#!/usr/bin/env python3
"""Time kernel K4 (the fwd2h wave sweep, ``csrc/spliced_h_wave.cu``) on
seeded shapes of ``aln -yl2``, on one CUDA card.

Run from the repository root:

    python3 tools/k4_bench.py                      # both variants, held to each other
    python3 tools/k4_bench.py --ctas 2,4,8         # cluster sizes besides the default
    python3 tools/k4_bench.py --root DIR --digests FILE
                                                   # another checkout's K4, held to FILE
    python3 tools/k4_bench.py --sass FILE          # the kernels' SASS into FILE
    python3 tools/k4_bench.py --profile            # clock cycles a step, by section
    python3 tools/k4_bench.py --ablate acc         # a step without a part, or another schedule

Shapes (inputs as ``aln -yl2`` packs them, through the port's own path):

- ``mini``: ``mini_gen.fa`` x ``mini_pro.fa``, 173 rows x 1,414 waves;
- ``win_msa``: the 2.3 kb CET10B9 window x the 7-member ``ce13a.msa``
  profile, 527 rows x 3,875 waves;
- ``q1100``: a 1,100-residue random protein against 3.6 kb of random
  genome rich in GT and AG (seed 3), 1,101 rows;
- ``flagship``: the window at 31,400 in seeded random flanks to 34.9 kb
  x ``ce13a.msa``, 527 rows x 36,475 waves.

In this checkout each shape runs the default plan, the cluster sizes
``--ctas`` asks for and the global variant; every timed call's planes
equal the other variant's bit for bit, or the script raises.  Each line
carries a digest of the planes (ev, jd, V, D).  ``--root`` imports
``prrn_aln_tpu_torch`` from another checkout (an unpacked parent commit)
and times its K4 as it launches it; ``--digests`` then holds its planes
to the digests of an earlier run of this script (its JSON lines), so
two designs are compared bit for bit across two processes.  ``--out``
writes the JSON lines to a file too.

``--profile`` builds a copy of the sources whose cluster variant sums,
in each warp, the clock cycles of each section of a step
(PROFILE_SECTIONS) and prints them a warp-step, for the default plan.
``--ablate`` builds a copy with a part of a step taken out (ABLATIONS;
its planes are wrong and not checked) or with another barrier schedule
(SCHEDULES; checked as above).

Prints the card and its power limit, then one JSON line a timed call:
the median of warm calls (CUDA events), microseconds a wave, the
variant, CTAs, rows a CTA, registers and spilled bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
SHAPES = ("mini", "win_msa", "q1100", "flagship")
# parts of the cluster variant an ablation changes in a copy of the
# sources: the release (fence) of the cluster barrier's arrival (the
# planes are then not checked; the time says what the fence costs)
ABLATIONS = {
    "fence": [("barrier.cluster.arrive.release;", "barrier.cluster.arrive.relaxed;")],
    # other schedules (the planes stay right, and are checked): no skew,
    # a barrier every 3 steps; a skew of 2 waves a warp, a barrier every 5
    # steps; a skew of 5, a barrier every 8 steps (deeper rings)
    "skew0": [("constexpr int kSkew = 1,", "constexpr int kSkew = 0,")],
    "skew2": [("constexpr int kSkew = 1,", "constexpr int kSkew = 2,"),
              ("constexpr int kHD = 8,", "constexpr int kHD = 16,")],
    "skew5": [("constexpr int kSkew = 1,", "constexpr int kSkew = 5,"),
              ("constexpr int kHD = 8, kSD = 16;", "constexpr int kHD = 16, kSD = 32;")],
}
SCHEDULES = ("skew0", "skew2", "skew5")


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


def rich_pair(seed: int, L: int, P: int, share: float) -> tuple[str, str]:
    """A random genome of L nt in which a ``share`` of the draws are
    splice-like motifs (GT, AG, GTAAGT, TTTCAG), and a random protein of
    P residues."""
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < L:
        if rng.random() < share:
            part = ("GT", "AG", "GTAAGT", "TTTCAG")[rng.integers(0, 4)]
        else:
            part = "ACGT"[rng.integers(0, 4)]
        parts.append(part)
        size += len(part)
    prot = "".join(np.array(list("ACDEFGHIKLMNPQRSTVWY"))[
        rng.integers(0, 20, P)])
    return "".join(parts)[:L], prot


def flagship_genome(pio) -> str:
    rng = np.random.default_rng(0)
    win = pio.sniff_and_read(FIX / "cet10b9_win31401.fa")[0].seq.upper()

    def flank(k):
        return "".join(np.array(list("ACGT"))[rng.integers(0, 4, k)])

    return flank(31400) + win + flank(34900 - 31400 - len(win))


class _Captured(Exception):
    pass


def capture_inputs(name: str, SH, aln_main, spliced_align_h, pio):
    """K4's inputs of a shape, recorded at its launch point; the run
    stops there."""
    got = []
    real = SH._launch_sweep

    def rec(ins, *args, **kwargs):
        got.append(ins)
        raise _Captured

    SH._launch_sweep = rec
    try:
        if name == "q1100":
            g, p = rich_pair(3, 3600, 1100, 0.2)
            spliced_align_h(g, p, device="cuda")
        else:
            with tempfile.TemporaryDirectory() as tmp:
                if name == "flagship":
                    genome = Path(tmp) / "flagship_shape.fa"
                    seq = flagship_genome(pio)
                    genome.write_text(">flagship_shape\n" + "\n".join(
                        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
                    query = FIX / "ce13a.msa"
                elif name == "mini":
                    genome, query = FIX / "mini_gen.fa", FIX / "mini_pro.fa"
                else:
                    genome = FIX / "cet10b9_win31401.fa"
                    query = FIX / "ce13a.msa"
                aln_main(["-yl2", str(genome), str(query), "-o",
                           str(Path(tmp) / "out.txt"), "--device", "cuda"])
    except _Captured:
        pass
    finally:
        SH._launch_sweep = real
    if len(got) != 1:
        raise AssertionError(f"expected one K4 call on {name}, got {len(got)}")
    return got[0]


def digest(sw) -> str:
    h = hashlib.sha256()
    for t in (sw.ev, sw.jd, sw.V, sw.D):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:24]


def equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def sass_counts(text: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing: its instructions, and
    those of its widest loop (the span of its farthest backward branch),
    which for K4 is the wave loop with everything inlined into it."""
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
    """The kernels' SASS (cuobjdump) into ``path``, and the counts of
    ``sass_counts`` for each K4 kernel: the wave loop's instructions
    bound what a warp issues a step."""
    lib = _build.library_path()
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    path.write_text(text)
    for fn, n in sass_counts(text).items():
        if "spliced_h_wave" in fn:
            print(json.dumps({"sass_function": fn, **n}), flush=True)


# the cluster variant's wave, cut into sections at these lines of its
# source for --profile: each warp's first lane sums clock64() deltas a
# section, and the sums come back through k4_profile_read
PROFILE_SECTIONS = (
    ("sync", "    __syncwarp();\n    if (ph == 0 && s > t_min) cluster_wait();"),
    ("neighbour", "    // ---- row m - 1's records: H of wave t - 3"),
    ("own", "    // ---- the row's own part\n"),
    ("horizontal", "    // ---- horizontal + frameshift insertions"),
    ("diag_vert_max", "    // ---- row m - 1's records in the band"),
    ("acceptor", "    // ---- 3' acceptor merges"),
    ("cell", "    // ---- the cell record"),
    ("donor", "    // ---- 5' donor pushes"),
    ("rings_arrive", "    // ---- the records row m + 1 reads"),
    ("planes", "    // ---- planes"),
)
PROFILE_END = "    p.jd[oj + 3 * MR] = sj_used ? sjK_ : 0;\n"


def profiled_sources(root: Path) -> Path:
    """A copy of the kernel sources whose cluster variant times its
    sections (PROFILE_SECTIONS) in clock cycles."""
    out = REPO / "build" / "k4_profile"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root / "prrn_aln_tpu_torch" / "csrc", out)
    src = out / "spliced_h_wave.cu"
    text = src.read_text()
    head = text.index("spliced_h_wave_cluster(Params p) {")
    pre, body = text[:head], text[head:]
    nsec = len(PROFILE_SECTIONS)
    body = body.replace("  const int m = rank * R + lm;\n",
                        "  const int m = rank * R + lm;\n"
                        f"  long long prof_t = 0, prof_acc[{nsec}] = {{0}};\n", 1)
    for k, (_, line) in enumerate(PROFILE_SECTIONS):
        if body.count(line) != 1:
            raise ValueError(f"section line {line!r} not unique in {src}")
        stamp = "" if k == 0 else (f"    prof_acc[{k - 1}] += clock64() - "
                                   "prof_t;\n")
        body = body.replace(line, stamp + "    prof_t = clock64();\n" + line)
    if body.count(PROFILE_END) != 1:
        raise ValueError(f"no end of the wave in {src}")
    body = body.replace(PROFILE_END, PROFILE_END
                        + f"    prof_acc[{nsec - 1}] += clock64() - prof_t;\n")
    tail = "  // no CTA leaves while the next one may still read its rings\n"
    body = body.replace(tail, "  if ((threadIdx.x & 31) == 0 && m <= M)\n"
                        f"    for (int k = 0; k < {nsec}; ++k)\n"
                        "      atomicAdd(&k4_prof[k], (unsigned long long)"
                        "prof_acc[k]);\n" + tail, 1)
    pre = pre.replace("namespace {\n",
                      f"__device__ unsigned long long k4_prof[{nsec}];\n"
                      "namespace {\n", 1)
    text = pre + body + (
        "\nextern \"C\" int k4_profile_read(void* out, int clear) {\n"
        f"  cudaError_t e = cudaMemcpyFromSymbol(out, k4_prof, {nsec} * 8);\n"
        "  if (e == cudaSuccess && clear) {\n"
        f"    unsigned long long z[{nsec}] = {{0}};\n"
        "    e = cudaMemcpyToSymbol(k4_prof, z, sizeof(z));\n"
        "  }\n  return (int)e;\n}\n")
    src.write_text(text)
    return out


def profile_read(_build, waves: int, rows: int, clear: bool) -> dict:
    import ctypes
    fn = _build.load().k4_profile_read
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * len(PROFILE_SECTIONS))()
    _build.check(fn(ctypes.addressof(out), int(clear)), "k4_profile_read")
    warps = -(-rows // 32)
    return {name: out[k] / (warps * waves)
            for k, (name, _) in enumerate(PROFILE_SECTIONS)}


def ablated_sources(root: Path, part: str) -> Path:
    """A copy of the kernel sources with the part ``part`` taken out."""
    out = REPO / "build" / f"k4_ablate_{part}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root / "prrn_aln_tpu_torch" / "csrc", out)
    src = out / "spliced_h_wave.cu"
    text = src.read_text()
    for old, new in ABLATIONS[part]:
        if old not in text:
            raise ValueError(f"no {old!r} in {src}")
        text = text.replace(old, new)
    src.write_text(text)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--ctas", default="",
                    help="cluster sizes to time besides the default plan")
    ap.add_argument("--digests", type=Path,
                    help="JSON lines of an earlier run to hold planes to")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ablate", choices=sorted(ABLATIONS))
    ap.add_argument("--profile", action="store_true",
                    help="clock cycles a wave by section of the cluster "
                         "variant's default plan (a warp's, averaged)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_bench: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from prrn_aln_tpu_torch import io as pio
    from prrn_aln_tpu_torch.cli import aln_main
    from prrn_aln_tpu_torch.ops import _build, spliced_h as SH
    from prrn_aln_tpu_torch.splice.hapi import spliced_align_h
    this = hasattr(SH, "sweep_plan")
    if args.ablate:
        _build._CSRC = ablated_sources(root, args.ablate)
        _build._BUILD = REPO / "build" / f"k4_ablate_{args.ablate}_lib"
    if args.profile:
        _build._CSRC = profiled_sources(root)
        _build._BUILD = REPO / "build" / "k4_profile_lib"
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
    attrs = ({v: SH.spliced_h_wave_attrs(v) for v in ("cluster", "global")}
             if this else {})
    for name in args.shapes.split(","):
        ins = capture_inputs(name, SH, aln_main, spliced_align_h, pio)
        MR, npen = ins.M + 1, ins.rlmt - ins.llmt + 1
        if this:
            plans = [SH.sweep_plan(MR, npen)]
            for c in filter(None, args.ctas.split(",")):
                try:
                    plan = SH.sweep_plan(MR, npen, variant="cluster",
                                         ctas=int(c))
                except ValueError:
                    continue
                if plan not in plans:
                    plans.append(plan)
            plans.append(SH.sweep_plan(MR, npen, variant="global"))
            outs = [SH._launch_sweep(ins, plan) for plan in plans]
            glob = outs[-1]
            other = next((o for p, o in zip(plans, outs)
                          if p["variant"] == "cluster"), None)
        else:
            plans = [{"variant": "parent"}]
            outs = [SH._launch_sweep(ins)]
        torch.cuda.synchronize()
        for plan, sw in zip(plans, outs):
            if this and (not args.ablate or args.ablate in SCHEDULES):
                ref = other if plan["variant"] == "global" else glob
                if ref is not None and not equal(sw, ref):
                    raise AssertionError(f"K4 {plan} != the other variant "
                                         f"on {name}")
            if this:
                fn = (lambda p=plan: SH._launch_sweep(ins, p))
            else:
                fn = (lambda: SH._launch_sweep(ins))
            d = digest(sw)
            if name in want and want[name] != d:
                raise AssertionError(f"K4 planes on {name} differ from "
                                     f"{args.digests}")
            ms = time_ms(fn, args.reps)
            emit({"shape": name, "root": str(root), "rows": MR,
                  "waves": ins.waves, "ms": ms,
                  "us_per_wave": ms * 1e3 / ins.waves,
                  "variant": plan["variant"], "ctas": plan.get("ctas"),
                  "rows_a_cta": plan.get("rows"),
                  "smem": plan.get("smem"),
                  **attrs.get(plan["variant"], {}), "digest": d,
                  "ablate": args.ablate,
                  "held_to": ("other variant" if this and (
                      not args.ablate or args.ablate in SCHEDULES)
                              else "digests" if name in want else None)})
        if args.profile and this and plans[0]["variant"] == "cluster":
            profile_read(_build, 1, 1, clear=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            SH._launch_sweep(ins, plans[0])
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            cyc = profile_read(_build, ins.waves, MR, clear=True)
            emit({"shape": name, "profile_cycles_a_wave": cyc,
                  "total_cycles_a_wave": sum(cyc.values()), "ms": ms,
                  "ctas": plans[0]["ctas"],
                  "rows_a_cta": plans[0]["rows"]})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
