#!/usr/bin/env python3
"""Time kernel K5 (the fwd2s wave sweep, ``csrc/spliced_s_wave.cu``) on
seeded shapes of ``aln -G``, on one CUDA card.

Run from the repository root:

    python3 tools/k5_bench.py                      # every variant, held to each other
    python3 tools/k5_bench.py --ctas 1,4,9,16      # cluster sizes besides the default
    python3 tools/k5_bench.py --chained "clusters=3;clusters=5,ctas=13;per_pass=1"
                                                   # chained plans besides the default
    python3 tools/k5_bench.py --root DIR --digests FILE
                                                   # another checkout's K5, held to FILE
    python3 tools/k5_bench.py --sass FILE          # the kernels' SASS into FILE
    python3 tools/k5_bench.py --profile            # clock cycles a step, by section
    python3 tools/k5_bench.py --ablate skew1       # another schedule, or a part taken out

Shapes (inputs as ``aln -G`` packs them, through the port's own path):

- ``gen1``, ``gen2``: ``tests/fixtures/gen{1,2}.fa`` x ``cdna{1,2}.fa``,
  350 rows x 1,389 waves and 313 rows x 1,652 waves;
- ``medium``: ``chip_smoke.GENES["medium"]``, 621 rows x 4,549 waves;
- ``realistic``: ``chip_smoke.GENES["realistic"]``, a 2.3 kb cDNA
  against its 18.5 kb locus, 2,275 rows x 22,998 waves;
- ``long``: ``chip_smoke.GENES["long"]``, a 6 kb cDNA against its 26 kb
  locus, past what one cluster holds (the chained variant by default).

In this checkout each shape runs the plan the wrapper picks, the
cluster sizes ``--ctas`` asks for, the chained plans ``--chained`` asks
for (``;`` between plans, each ``key=value`` keywords of
``sweep_s_plan``'s chained variant joined by ``,``: ``clusters``,
``ctas``, ``per_pass``; on a shape one cluster holds, the same
rows over chained clusters), the penalty table out of shared
memory, and the global variant; every timed call's
planes and final band equal the global variant's bit for bit, or the
script raises (the GPU tests and ``chip_smoke.py`` hold both variants to
the plain version).  Each line carries a digest of the outputs (ev,
jdon, HV, Hi).  ``--root`` imports ``prrn_aln_tpu_torch`` from another
checkout (an unpacked parent commit) and times its K5 as it launches
it; ``--digests`` then holds its outputs to the digests of an earlier
run of this script (its JSON lines).  ``--out`` writes the JSON lines to
a file too.

``--profile`` builds the sources with ``-DK5_PROFILE``: each thread sums
the clock cycles of each section of a step (PROFILE_SECTIONS), and the
script prints them a thread-step, for the default plan, the cluster
sizes asked for and the global variant of each shape.  ``--ablate`` builds a
copy of the sources with a part of the cluster variant changed
(ABLATIONS): another skew (checked as above), or a part taken out (its
outputs wrong and not checked).

Prints the card and its power limit, then one JSON line a timed call:
the median of warm calls (CUDA events), microseconds a wave, the plan
(variant, clusters, CTAs a cluster, rows a CTA, clusters a launch,
launches, penalty table in shared memory), registers and spilled
bytes.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
SHAPES = ("gen1", "gen2", "medium", "realistic", "long")
# parts of the cluster variant an ablation changes in a copy of the
# sources (ABLATIONS_WRONG: its outputs are then wrong and not checked;
# the time says what the part costs): the plane stores, never taken; the
# release of the cluster barrier's arrival; the barrier itself
ABLATIONS = {
    "planes": [("  p.ev[cellx] = valid ? e : -1;\n"
                "  p.jdon[3 * cellx] = jd0;\n"
                "  p.jdon[3 * cellx + 1] = jd1;\n"
                "  p.jdon[3 * cellx + 2] = jd2;\n"
                "  pf.mark(kSecPlanes);\n\n"
                "  // retain old values on invalid slots\n"
                "  const Rec9 o{",
                "  if (s < 0) {\n"
                "    p.ev[cellx] = valid ? e : -1;\n"
                "    p.jdon[3 * cellx] = jd0;\n"
                "    p.jdon[3 * cellx + 1] = jd1;\n"
                "    p.jdon[3 * cellx + 2] = jd2;\n"
                "  }\n"
                "  pf.mark(kSecPlanes);\n\n"
                "  // retain old values on invalid slots\n"
                "  const Rec9 o{")],
    "fence": [("barrier.cluster.arrive.release;",
               "barrier.cluster.arrive.relaxed;")],
    # other skews (the outputs stay right, and are checked): the warps
    # skewed by 1, 3 or 5 waves, the barrier every 2, 4 or 6 steps
    **{f"skew{k}": [("constexpr int kSkew = 7,",
                     f"constexpr int kSkew = {k},")] for k in (1, 3, 5)},
    # no barrier in the step loop: each warp runs its steps unsynchronised
    "nobarrier": [("    if (ph == 0 && s > 1) cluster_wait();\n", ""),
                  ("    if (ph == kEvery - 1) cluster_arrive();\n", ""),
                  ("  if ((s_last - 1) % kEvery != kEvery - 1) "
                   "cluster_arrive();\n", "  cluster_arrive();\n")],
}
# the ablations whose outputs are wrong
ABLATIONS_WRONG = ("planes", "fence", "nobarrier")
# the sections of a step (csrc/spliced_s_wave.cu's kSec* order)
PROFILE_SECTIONS = ("reads", "match", "diag_vert_hori", "acceptor", "donor",
                    "planes", "ring_writes", "barrier", "idle")


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class _Captured(Exception):
    pass


def capture_inputs(name: str, SS, aln_main):
    """K5's inputs of a shape, recorded at its launch point; the run
    stops there."""
    import chip_smoke as C
    got = []
    real = SS._launch_sweep_s

    def rec(ins, *args, **kwargs):
        got.append(ins)
        raise _Captured

    SS._launch_sweep_s = rec
    try:
        with tempfile.TemporaryDirectory() as tmp:
            if name in C.GENES:
                genome, cdna, _ = C.spliced_gene(name)
                g = C.write_fasta(Path(tmp) / "genome.fa", "genome", genome)
                c = C.write_fasta(Path(tmp) / "cdna.fa", "cdna", cdna)
            else:
                g, c = str(FIX / f"{name}.fa"), str(FIX / f"cdna{name[3:]}.fa")
            aln_main(["-G", g, c, "-o", str(Path(tmp) / "out.txt"),
                      "--device", "cuda"])
    except _Captured:
        pass
    finally:
        SS._launch_sweep_s = real
    if len(got) != 1:
        raise AssertionError(f"expected one K5 call on {name}, got {len(got)}")
    return got[0]


def digest(sw) -> str:
    h = hashlib.sha256()
    for t in sw:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:24]


def equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def sass_counts(text: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing: its instructions, and
    those of its widest loop (the span of its farthest backward branch),
    which for K5 is the step loop with the cell inlined into it."""
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2)) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*);", block)]
        loop = (0, 0)
        for addr, op in ins:
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if b and int(b.group(1), 16) < addr:
                lo = int(b.group(1), 16)
                if addr - lo > loop[1] - loop[0]:
                    loop = (lo, addr)
        out[name] = {"instructions": len(ins),
                     "loop_instructions": sum(loop[0] <= a <= loop[1]
                                              for a, _ in ins)}
    return out


def dump_sass(path: Path, _build) -> None:
    """The kernels' SASS (cuobjdump) into ``path``, and ``sass_counts``
    for each K5 kernel."""
    lib = _build.library_path()
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    path.write_text(text)
    for fn, n in sass_counts(text).items():
        if "spliced_s_wave" in fn:
            print(json.dumps({"sass_function": fn, **n}), flush=True)


def profile_read(_build, clear: bool) -> dict:
    """Cycles a thread-step by section, summed since the last clear."""
    fn = _build.load().k5_profile_read
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * (len(PROFILE_SECTIONS) + 1))()
    _build.check(fn(ctypes.addressof(out), int(clear)), "k5_profile_read")
    steps = max(out[len(PROFILE_SECTIONS)], 1)
    return {name: out[k] / steps for k, name in enumerate(PROFILE_SECTIONS)}


def ablated_sources(root: Path, part: str) -> Path:
    """A copy of the kernel sources with the part ``part`` changed."""
    out = REPO / "build" / f"k5_ablate_{part}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root / "prrn_aln_tpu_torch" / "csrc", out)
    src = out / "spliced_s_wave.cu"
    text = src.read_text()
    for old, new in ABLATIONS[part]:
        if old not in text:
            raise ValueError(f"no {old!r} in {src}")
        text = text.replace(old, new)
    src.write_text(text)
    return out


def attrs_of(SS, plan) -> dict:
    return SS.spliced_s_wave_attrs(plan["variant"], multi=plan["rpt"] > 1)


def chained_asks(spec: str) -> list:
    """``--chained``'s plans: keyword dicts of the chained variant."""
    return [{k: int(v) for k, v in (kv.split("=") for kv in
                                     filter(None, plan.split(",")))}
            for plan in filter(None, spec.split(";"))]


def plans_of(SS, ins, ctas, chained, pen_out: bool) -> list:
    """The default plan, then the cluster sizes asked for, the chained
    plans asked for (within what the card holds at once), the penalty
    table out of shared memory (if ``pen_out``), and the global
    variant."""
    K, npen = ins.mtx.shape[0], ins.lb + 2
    plans = [SS.launch_plan(ins.rows, K, npen)]
    asks = [("cluster", dict(ctas=c)) for c in ctas]
    asks += [("chained", kw) for kw in chained]
    if pen_out:
        asks.append((plans[0]["variant"], dict(pen_smem=False)))
    for variant, kw in asks:
        try:
            plan = SS.sweep_s_plan(ins.rows, K, npen, variant=variant, **kw)
            if variant == "chained":
                held = SS.clusters_held(plan)
                plan = SS.sweep_s_plan(ins.rows, K, npen, variant=variant,
                                       held=held, **kw)
        except ValueError:
            continue
        if plan not in plans:
            plans.append(plan)
    plans.append(SS.sweep_s_plan(ins.rows, K, npen, variant="global"))
    return plans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--ctas", default="",
                    help="cluster sizes to time besides the default plan")
    ap.add_argument("--chained", default="",
                    help="chained plans to time besides the default plan")
    ap.add_argument("--digests", type=Path,
                    help="JSON lines of an earlier run to hold outputs to")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ablate", choices=sorted(ABLATIONS))
    ap.add_argument("--profile", action="store_true",
                    help="clock cycles a step by section of each plan")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_bench: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(REPO))
    from prrn_aln_tpu_torch.cli import aln_main
    from prrn_aln_tpu_torch.ops import _build, spliced_s as SS
    this = hasattr(SS, "launch_plan")
    if args.profile:
        if not this:
            raise SystemExit("k5_bench: --profile needs this checkout's K5")
        _build.NVCC_FLAGS = [*_build.NVCC_FLAGS, "-DK5_PROFILE"]
        _build._BUILD = REPO / "build" / "k5_profile_lib"
    if args.ablate:
        _build._CSRC = ablated_sources(root, args.ablate)
        _build._BUILD = REPO / "build" / f"k5_ablate_{args.ablate}_lib"
    want = {}
    if args.digests:
        for line in args.digests.read_text().splitlines():
            rec = json.loads(line) if line.startswith("{") else {}
            if "digest" in rec:
                want[rec["shape"]] = rec["digest"]
    out = args.out.open("w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.load()
    if args.sass:
        dump_sass(args.sass, _build)
    ctas = [int(c) for c in filter(None, args.ctas.split(","))]
    for name in args.shapes.split(","):
        ins = capture_inputs(name, SS, aln_main)
        if this:
            plans = plans_of(SS, ins, ctas, chained_asks(args.chained),
                             not args.profile)
            outs = [SS._launch_sweep_s(ins, plan) for plan in plans]
            glob = outs[-1]
        else:
            plans = [{"variant": "parent"}]
            outs = [SS._launch_sweep_s(ins)]
        torch.cuda.synchronize()
        for plan, sw in zip(plans, outs):
            if this and args.ablate not in ABLATIONS_WRONG and not equal(
                    sw, glob):
                raise AssertionError(f"K5 {plan} != the global variant on "
                                     f"{name}")
            d = digest(sw)
            if (name in want and want[name] != d
                    and args.ablate not in ABLATIONS_WRONG):
                raise AssertionError(f"K5 outputs on {name} differ from "
                                     f"{args.digests}")
            if this:
                fn = (lambda p=plan: SS._launch_sweep_s(ins, p))
            else:
                fn = (lambda: SS._launch_sweep_s(ins))
            rec = {"shape": name, "root": str(root), "rows": ins.rows,
                   "W": ins.W, "genome": ins.lb, "waves": ins.waves,
                   "variant": plan["variant"],
                   "clusters": plan.get("clusters"), "ctas": plan.get("ctas"),
                   "rows_a_cta": plan.get("rows"),
                   "threads": plan.get("threads"), "rpt": plan.get("rpt"),
                   "per_pass": plan.get("per_pass"),
                   "passes": plan.get("passes"),
                   "pen_smem": plan.get("pen_smem"),
                   "smem": plan.get("smem"),
                   **(attrs_of(SS, plan) if this else {}), "digest": d,
                   "ablate": args.ablate,
                   "held_to": (None if args.ablate in ABLATIONS_WRONG
                               else "global variant" if this
                               else "digests" if name in want else None)}
            if args.profile:
                profile_read(_build, clear=True)
                ms = time_ms(fn, 1)
                cyc = profile_read(_build, clear=True)
                rec.update(profile_cycles_a_step=cyc,
                           total_cycles_a_step=sum(cyc.values()))
                rec["profiled_ms"] = ms
            else:
                ms = time_ms(fn, 3 if ins.waves > 20000 and
                             plan["variant"] == "global" else args.reps)
            rec.update(ms=ms, us_per_wave=ms * 1e3 / ins.waves)
            emit(rec)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
