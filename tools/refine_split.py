#!/usr/bin/env python3
"""Where a family's time goes inside the port, on the card: one run of
a benchmark cell through ``bench_port/run.py`` with the port's tracer
(``prrn_aln_tpu_torch/utils/trace.py``) on for the window, its spans
summed by name, and, traced, the card's idle gaps put down to the
innermost of the program's spans the host was in.

Temporary: the harness does not turn the tracer on yet, so this tool
does it by wrapping the harness's window and span names from outside.
The ``benchmark`` change that wires ``trace.enable``/``trace.take``
into ``bench_port`` and adds the span metrics (ROADMAP E8) deletes it.

Run from the repository root:

    python3 tools/refine_split.py --workload prrn-protein.rv12 \
        --seed <n> [--seconds 51] [--trace 1] [--tracer 1]

``--trace 1`` (default) runs the cell as the benchmark's traced run
does (its spans, kernel events and the profiler) and hands the profiler
the program's spans too (every name that starts with ``prrn.``), so the
breakdown's ``idle_gaps`` name them.  ``--trace 0`` runs it as the
untraced run does; with ``--tracer 0`` the tracer stays off, so two runs
of one seed with ``--tracer 1`` and ``--tracer 0`` give the tracer's
cost on ``throughput``.

Prints the benchmark's result line, then, with the tracer on, one JSON
line: per family of the window, each span's calls, ms and self ms (its
time less its child spans'), the program's counts, and the
refinement's parts (the tree, the
candidates' preparation less ``score_path``, ``score_path``, the
accepted candidates' application, and the group DP's packing, K2 and
K3 wrappers and fetch under the refinement) in ms and as shares of the
benchmark's ``refine_ms`` when traced.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "bench_port")]

# the refinement's parts: a span's time ("ms") or self time ("self_ms"),
# counted where it runs under prrn.refine
PARTS = (("tree", "prrn.refine.tree", "ms"),
         ("prepare_self", "prrn.refine.prepare", "self_ms"),
         ("score_path", "prrn.score_path", "ms"),
         ("apply", "prrn.refine.apply", "ms"),
         ("group_pack", "prrn.group.pack", "ms"),
         ("group_k2", "prrn.group.k2", "ms"),
         ("group_k3", "prrn.group.k3", "ms"),
         ("group_fetch", "prrn.group.fetch", "ms"))


class _WithProgramSpans(tuple):
    """The harness's span names and every name of the program's spans."""

    def __contains__(self, name):
        return tuple.__contains__(self, name) or name.startswith("prrn.")


def split(records, families: int) -> dict:
    """Per family: each span name's calls, ms and self ms, overall and
    under ``prrn.refine``."""
    dur = [r.end_ns - r.start_ns for r in records]
    inner = [0] * len(records)
    for k, r in enumerate(records):
        if r.parent >= 0:
            inner[r.parent] += dur[k]

    def under_refine(k):
        while k >= 0:
            if records[k].name == "prrn.refine":
                return True
            k = records[k].parent
        return False

    spans = collections.defaultdict(lambda: [0, 0, 0])
    refine = collections.defaultdict(lambda: [0, 0, 0])
    for k, r in enumerate(records):
        for table, yes in ((spans, True), (refine, under_refine(r.parent))):
            if yes:
                row = table[r.name]
                row[0] += 1
                row[1] += dur[k]
                row[2] += dur[k] - inner[k]

    def per_family(table):
        return {name: {"calls": c / families, "ms": ns / 1e6 / families,
                       "self_ms": own / 1e6 / families}
                for name, (c, ns, own) in sorted(table.items())}
    spans, refine = per_family(spans), per_family(refine)
    parts = {part: refine.get(name, {}).get(key, 0.0)
             for part, name, key in PARTS}
    return {"families": families, "spans": spans,
            "refine_ms": spans.get("prrn.refine", {}).get("ms"),
            "parts_ms": parts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="the window (default: BENCHMARK.json's)")
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    import run as bench
    from harness import load

    cell, _, _, spec = bench.load_cell(args.workload)
    drv = load("traffic", cell["traffic"])
    window = drv.window

    counted = []

    def traced_window(st, seconds):
        from prrn_aln_tpu_torch.utils import trace
        trace.take()
        before = collections.Counter(trace.COUNTS)
        trace.enable()
        try:
            return window(st, seconds)
        finally:
            trace.disable()
            counted.append(trace.COUNTS - before)

    if args.tracer:
        drv.window = traced_window
    bench.SPANS = _WithProgramSpans(bench.SPANS)
    results = []
    run_cell = bench.run_cell

    def kept(*a, **kw):
        results.append(run_cell(*a, **kw))
        return results[-1]
    bench.run_cell = kept
    seconds = spec["run_seconds"] if args.seconds is None else args.seconds
    rc = bench.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(seconds), "--trace", str(args.trace)])
    if rc or not args.tracer:
        return rc
    from prrn_aln_tpu_torch.utils import trace
    records = trace.take()
    families = len({r.request for r in records if r.request})
    out = split(records, families) if families else {"families": 0}
    if families:
        out["counts"] = {k: v / families
                         for k, v in sorted(counted[0].items())}
    res = results[0]
    bench_refine = res["metrics"].get("refine_ms", {}).get("value")
    if bench_refine and families:
        parts = out["parts_ms"]
        out["bench_refine_ms"] = bench_refine
        out["parts_pct_of_refine_ms"] = {
            k: 100.0 * v / bench_refine for k, v in parts.items()}
        out["parts_cover_pct"] = 100.0 * sum(parts.values()) / bench_refine
    if "breakdown" in res:
        out["idle_gaps"] = res["breakdown"]["idle_gaps"]
        out["busy_s"] = res["device"]["busy_s"]
        out["window_s"] = res["device"]["window_s"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
