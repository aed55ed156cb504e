"""Benchmark of ``prrn_aln_tpu_torch``, the PyTorch and CUDA port, on
the card it is started on.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one cell is found by name.  ``BENCHMARK.json``
names the cell's configuration, traffic and metrics;
``workloads/<cell>.json`` holds the traffic's parameters, the
configuration's ``file`` its sizes, its generator, the program's entry
point (arguments and environment) and its plain reference;
``traffic/<traffic>.py`` drives the window (set-up and warm-up, the
requests, and the check of what they produced against the reference once
the window has closed); ``generators/<name>.py`` makes the inputs;
``kernels/<kernel>.py`` names a launcher to time and counts its work;
``metrics/<metric>.py`` reads one metric.  With ``--trace 0`` the run
reports the cell's end-to-end metrics and installs nothing; with
``--trace 1`` it installs the spans and kernel events of
``harness/tracing.py`` and the profiler, and reports the per-layer
metrics.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import load  # noqa: E402
from harness.tracing import merged  # noqa: E402

# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "prrn_aln_tpu")
# the record_function names of the window and of the layer spans
SPANS = ("bench_port.window", "distance", "progressive", "refine")


def process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    stat = Path("/proc/self/stat").read_text()
    start = int(stat.rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """The cell's entry of ``BENCHMARK.json``, its traffic, its
    configuration and the whole ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"unknown workload {name!r}")
    traffic = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    return cell, traffic, config, bench


def metric_reader(name: str):
    return load("metrics", name).read


class Run:
    """What a run measured, as the metric readers read it."""

    def __init__(self, **kw):
        self.spans, self.kernel_ms, self.launches = [], [], []
        self.__dict__.update(kw)


def profile_summary(prof, torch) -> dict | None:
    """Busy seconds of the card over the traced window from the
    profiler's trace, the device operations that took most time, and the
    idle gaps summed by the layer the host was in (``record_function``
    spans; "host" outside them).  None where the trace holds no device
    operation."""
    def ns(ev, what):
        f = getattr(ev, f"{what}_ns", None)
        return f() if f else getattr(ev, f"{what}_us")() * 1e3

    dev, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        start = ns(ev, "start")
        end = start + ns(ev, "duration")
        name = ev.name()
        if name in SPANS:
            # a span's own event; its mirror on the device's timeline
            # (a user annotation) is no device operation
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                if name == "bench_port.window":
                    window = (start, end)
                else:
                    host.append((start, end, name))
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((start, end, name))
    if not dev or window is None:
        return None
    busy_iv = merged((s, e) for s, e, _ in dev)
    busy = sum(e - s for s, e in busy_iv)
    ops = collections.Counter()
    for s, e, name in dev:
        ops[name] += (e - s) / 1e9
    gaps = collections.Counter()
    edges = [window[0]] + [x for s, e in busy_iv for x in (s, e)] + [window[1]]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        inside = [(s, e, n) for s, e, n in host if s <= mid <= e]
        gaps[min(inside, key=lambda x: x[1] - x[0])[2] if inside
             else "host"] += (g1 - g0) / 1e9
    return {"busy_s": busy / 1e9,
            "device_ops": [[n, s] for n, s in ops.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}


class Job:
    """What a traffic driver is handed: the cell, its traffic and
    configuration, the run's seed and directory, and ``request()``, a
    context to hold around each request of the window (it counts the
    program's launches in a traced run)."""

    def __init__(self, **kw):
        self.request = contextlib.nullcontext
        self.__dict__.update(kw)


def run_cell(cell: dict, traffic: dict, config: dict, metrics: list, *,
             seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of a cell; returns the result line's fields (with
    ``checks`` last).  The traffic driver is ``traffic/<traffic>.py``,
    named by the cell.  ``device="cpu"`` (with an entry whose arguments
    run the program's plain versions) is for the CPU tests."""
    import torch
    from prrn_aln_tpu_torch.ops import _build
    from harness import load
    from harness.tracing import Trace

    drv = load("traffic", cell["traffic"])
    cuda = device == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="bench_port."))
    try:
        job = Job(cell=cell, traffic=traffic, config=config, seed=seed,
                  tmp=tmp)
        state = drv.prepare(job)
        if cuda:
            torch.cuda.synchronize()
        setup_s = (time.time() - t_start) if t_start is not None else 0.0

        tr = Trace() if trace else None
        prof = None
        launches = []
        if tr is not None:
            tr.install(torch)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()

            @contextlib.contextmanager
            def counted():
                before = collections.Counter(_build.LAUNCHES)
                yield
                launches.append(collections.Counter(_build.LAUNCHES)
                                - before)
            job.request = counted
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            t0_ev = torch.cuda.Event(enable_timing=True)
            t0_ev.record()
        window = (torch.profiler.record_function("bench_port.window")
                  if tr is not None else contextlib.nullcontext())
        window.__enter__()
        t0 = time.perf_counter()
        rec = drv.window(state, seconds)
        t_end = time.perf_counter()
        window.__exit__(None, None, None)
        job.request = contextlib.nullcontext
        peak = 0
        kind = torch.cuda.get_device_name() if cuda else "cpu"
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        run = Run(seconds=seconds, setup_s=setup_s, window_s=t_end - t0,
                  walls=rec["walls"], residues=rec["residues"],
                  peak_mem_bytes=peak, kind=kind, launches=launches)
        summary = None
        if tr is not None:
            prof.__exit__(None, None, None)
            tr.uninstall()
            run.spans = tr.spans
            for c in tr.calls:
                host = ({k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                         for k, v in c.inputs.items()}
                        if c.inputs is not None else None)
                count = getattr(load("kernels", c.kernel), "work", None)
                run.kernel_ms.append(
                    (c.kernel, t0_ev.elapsed_time(c.start),
                     t0_ev.elapsed_time(c.end),
                     count(host) if host and count else None))
            summary = profile_summary(prof, torch)
            if summary is None:
                print("bench_port: the profiler's trace holds no device "
                      "operation; busy_s from the kernel events",
                      file=sys.stderr)
            del tr, prof
        values = {}
        for m in metrics:
            v = metric_reader(m["name"])(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        print(f"bench_port: setup {setup_s:.1f} s, window {run.window_s:.1f}"
              f" s ({len(run.walls)} families)", file=sys.stderr)

        # the comparison, once the program's state is freed
        if cuda:
            torch.cuda.empty_cache()
        verdict = drv.check_outputs(state, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    result = {"correct": verdict["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": values,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": cell["chips"],
                         "memory_peak_bytes": peak}}
    if trace:
        busy = (summary["busy_s"] if summary else sum(
            e - s for s, e in merged((s, e) for _, s, e, _ in run.kernel_ms))
            / 1e3)
        result["device"].update(busy_s=busy, window_s=run.window_s)
        if summary:
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    result["checks"] = verdict["checks"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = time.time() - process_age()
    # the seed as the generators take it (a whole number of 64 bits)
    seed = args.seed % 2 ** 64
    cell, traffic, config, bench = load_cell(args.workload)
    # the program's environment, before anything of it is imported
    os.environ.update(config["entry"].get("env", {}))
    group = "per_layer" if args.trace else "end_to_end"
    metrics = bench[group]
    # every cache of the program and of PyTorch inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_port" / sub)
    # one host thread for the program's NumPy and PyTorch work (and the
    # reference's workers): steadier on a host whose cores are shared
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"bench_port: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, traffic, config, metrics, seed=seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
