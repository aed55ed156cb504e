#!/usr/bin/env python3
"""Rehearse kernel K1f (``csrc/pairwise_rows.cu``) on the CPU, every CUDA
thread a ``std::thread``, and hold it bit for bit to its plain version.

Run from the repository root (needs ``g++``; no card, no ``nvcc``):

    python3 tools/k1f_emulate.py                   # AddressSanitizer
    python3 tools/k1f_emulate.py --sanitize thread # ThreadSanitizer
    python3 tools/k1f_emulate.py --mutate no_push --cases c3_w2

The source's anonymous namespace (the kernels and their device helpers)
is compiled as ``tools/k1_emulate.py`` compiles K1's, with its header and
launch loop: ``g++ -std=c++17 -ffp-contract=off``, the CUDA keywords
defined, ``threadIdx``/``blockIdx``/``blockDim`` as ``thread_local``
values, ``extern __shared__`` as one buffer a CTA of exactly its bytes
(poisoned before the launch with bytes that read as a large positive
float), the warp shuffles as an exchange through
an array a warp between two spin barriers, and ``__syncthreads``, the
named barrier and the split cluster barrier (the inline PTX swapped by
the script) as spin barriers on ``std::atomic`` alone.
``cg::this_cluster()``'s ``map_shared_rank`` returns the same offset in
another CTA's buffer.  A cluster's CTAs and threads run at once and
really race between barriers, so a missing barrier or push shows as a
score that differs or as a report of a race.

Each case scores seeded DNA pairs whose bands span a given number of
lanes in the plan it names: the cluster variant at 2, 3 and 4 CTAs of
one or two warps and 4 or 8 lanes a thread, a band edge on a CTA edge
(the band's last lane a CTA's first, and a CTA of padding lanes only), a
batch of unequal pairs, free end gaps, a terminal gap factor of 0.5 and
a negative gap extension; the warp, warps and block variants (the row
in shared and in device memory) as a check of the harness.  The scores
are compared with ``row_scores_ref`` bit for bit.  ``--mutate`` builds a
broken copy of the source (a push or the row's cluster barrier taken
out, the slots not alternated by row) to show that the cases catch it.
Prints one JSON line a case and exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import k1_emulate as K1  # noqa: E402
from prrn_aln_tpu_torch import alphabet as ab, scoring  # noqa: E402
from prrn_aln_tpu_torch.config import default_params  # noqa: E402
from prrn_aln_tpu_torch.ops import pairwise as P  # noqa: E402

# K1's header lacks the block variant's broadcast shuffle; shared memory
# is poisoned with 0x4b bytes (1.33e7 as a float), so a slot read before
# its push wins every maximum it meets and shows in the score
SHFL = ("#define __shfl_sync(m, v, s) emu::shfl((v), (s))\n"
        "#define EMU_POISON 0x4b\n")

DRIVER = r"""
// argv[1]: the packed inputs (python side: ``pack``); argv[2]: scores
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[12];
  if (fread(h, sizeof(int), 12, f) != 12) return 2;
  const int B = h[0], Ma = h[1], Mb = h[2], dim = h[3], lw0 = h[4],
            W = h[5], variant = h[6], lanes = h[7], threads = h[8],
            code_stride = h[9], smem_bytes = h[10], ctas = h[11];
  auto* a = take<int32_t>(f, (size_t)B * Ma);
  auto* b = take<int32_t>(f, (size_t)B * Mb);
  auto* la = take<int32_t>(f, B);
  auto* lb = take<int32_t>(f, B);
  auto* lw = take<int32_t>(f, B);
  auto* up = take<int32_t>(f, B);
  auto* u = take<float>(f, B);
  auto* v = take<float>(f, B);
  auto* tg = take<float>(f, B);
  auto* exg = take<uint8_t>(f, (size_t)B * 4);
  auto* mtx = take<float>(f, (size_t)dim * dim);
  fclose(f);
  std::vector<float> out(B, 7.0f);
  if (variant == 0 || variant == 4) {
    // the block variant: the row in shared memory, or (4) in device memory
    const int L = (W + 1023) / 1024;
    const int nthreads = (((W + L - 1) / L + 31) / 32) * 32;
    std::vector<unsigned char> state(
        (size_t)B * rows_state_bytes(W, Ma, Mb), 0x5a);
    if (variant == 0)
      run_blocks(pairwise_rows_block_kernel<false>, B, 1, nthreads,
                 (size_t)smem_bytes, a, b, la, lb, lw, up, u, v, tg, exg,
                 mtx, out.data(), Ma, Mb, dim, lw0, W, L,
                 (unsigned char*)nullptr, 1);
    else
      run_blocks(pairwise_rows_block_kernel<true>, B, 1, nthreads,
                 (size_t)smem_bytes, a, b, la, lb, lw, up, u, v, tg, exg,
                 mtx, out.data(), Ma, Mb, dim, lw0, W, L, state.data(),
                 (int)((size_t)smem_bytes >= 4 * ((size_t)dim * dim + 32)));
  } else {
    const RowsKernel kern = pick_kernel(variant, lanes);
    if (kern == nullptr) return 3;
    const int per = variant == 3 ? ctas : 1;
    const int grid = variant == 3 ? B * ctas
                     : variant == 1 ? (B + threads / 32 - 1) / (threads / 32)
                                    : B;
    run_blocks(kern, grid, per, threads, (size_t)smem_bytes, a, b, la, lb,
               lw, up, u, v, tg, exg, mtx, out.data(), B, Ma, Mb, dim, lw0,
               W, code_stride, variant == 3 ? ctas : 1);
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, B, o);
  fclose(o);
  for (void* p : taken) free(p);
  return 0;
}
"""

# broken copies of the source that the cases must catch: (old, new)
MUTATIONS = {
    # a CTA's total never reaches the CTAs to its right
    "no_push": [("            cluster.map_shared_rank(xb, lane)[rank] = "
                 "c_next;", "            (void)0;")],
    # the edge lanes' values never cross a CTA edge
    "no_edge_push": [("            nx[18] = H[L - 1];\n"
                      "            nx[19] = carry;\n", ""),
                     ("          pv[16] = H[0];\n"
                      "          pv[17] = G[0];\n", "")],
    # the row's cluster barrier
    "no_barrier": [("        cluster_arrive();\n        cluster_wait();\n"
                    "        const float t2", "        const float t2")],
    # the slots not alternated by row: a push can land on one a slower
    # CTA still reads
    "one_buffer": [("float* xb = xs + 20 * (m & 1);", "float* xb = xs;")],
}


def source(src_dir: Path, mutate: str | None) -> str:
    text = (src_dir / "pairwise_rows.cu").read_text()
    for old, new in MUTATIONS.get(mutate, []):
        if old not in text:
            raise ValueError(f"mutation {mutate}: no {old!r} in the source")
        text = text.replace(old, new, 1)
    start = text.index("namespace {")
    end = text.index("}  // namespace\n") + len("}  // namespace\n")
    body = text[start:end]
    for old, new in K1.SWAPS:
        if old not in body:
            raise ValueError(f"no {old!r} in the kernel source")
        body = body.replace(old, new)
    if "asm" in body:
        raise ValueError("inline PTX left in the emulated source")
    return K1.HEADER + SHFL + body + K1.RUNNER + DRIVER


def build(src_dir: Path, sanitize: str, mutate: str | None,
          out_dir: Path) -> Path:
    cpp = out_dir / f"k1f_emu_{sanitize}_{mutate or 'ok'}.cpp"
    exe = cpp.with_suffix("")
    cpp.write_text(source(src_dir, mutate))
    cmd = ["g++", "-std=c++17", "-O1", "-g", "-ffp-contract=off",
           f"-fsanitize={sanitize}", "-fno-omit-frame-pointer", "-pthread",
           "-o", str(exe), str(cpp)]
    subprocess.run(cmd, check=True)
    return exe


# name: ((la, lb) of each pair, lanes the batch's bands span, free end
# gaps (None: seeded), terminal gap factor, u, the plan asked for).  A
# cluster CTA of W warps of L lanes a thread holds 32 W L lanes.
CASES = {
    # 2 CTAs of one warp, 4 lanes a thread (128 lanes a CTA)
    "c2_w1": ([(200, 300)], 240, None, 1.0, 2.0,
              dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    # 3 CTAs of two warps (a named barrier inside each CTA too)
    "c3_w2": ([(300, 900)], 700, None, 1.0, 2.0,
              dict(variant="cluster", ctas=3, lanes=4, warps=2)),
    # 4 CTAs of one warp, 8 lanes a thread
    "c4_l8": ([(260, 1000)], 900, None, 1.0, 2.0,
              dict(variant="cluster", ctas=4, lanes=8, warps=1)),
    # the band's last lane CTA 1's first (129 lanes on 2 x 128)
    "edge_first": ([(180, 200)], 129, None, 1.0, 2.0,
                   dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    # the band's last lane CTA 0's last: CTA 1 holds padding lanes only
    "edge_last": ([(180, 200)], 128, None, 1.0, 2.0,
                  dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    # a batch of three unequal pairs
    "batch3": ([(120, 400), (240, 300), (170, 380)], 380, None, 1.0, 2.0,
               dict(variant="cluster", ctas=3, lanes=4, warps=1)),
    # each free end gap, a terminal gap factor of 0.5, a negative u
    "exg0": ([(150, 300)], 250, [1, 0, 0, 0], 1.0, 2.0,
             dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    "exg1": ([(150, 300)], 250, [0, 1, 0, 0], 1.0, 2.0,
             dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    "exg2": ([(150, 300)], 250, [0, 0, 1, 0], 1.0, 2.0,
             dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    "exg3": ([(150, 300)], 250, [0, 0, 0, 1], 1.0, 2.0,
             dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    "tgapf_half": ([(150, 300)], 250, None, 0.5, 2.0,
                   dict(variant="cluster", ctas=2, lanes=4, warps=1)),
    "negative_u": ([(150, 350)], 340, None, 1.0, -0.5,
                   dict(variant="cluster", ctas=3, lanes=4, warps=1)),
    # the other variants through the same harness
    "warp": ([(90, 100), (70, 110)], 120, None, 1.0, 2.0,
             dict(variant="warp")),
    "warps": ([(120, 300)], 300, None, 1.0, 2.0,
              dict(variant="warps", lanes=4, warps=3)),
    "block": ([(100, 300)], 300, None, 1.0, 2.0, dict(variant="block")),
    "block_device": ([(100, 300)], 300, None, 1.0, 2.0,
                     dict(variant="block", state="device")),
}


def mutant(rng, base, lb, sub=0.05):
    """``base`` with a short deletion and substitutions, cut or extended
    with random bases to ``lb``: a long run of b past a's end is a long
    horizontal gap, whose running maximum crosses the CTAs."""
    mut = list(base)
    p = int(rng.integers(10, len(mut) - 10))
    del mut[p:p + int(rng.integers(1, 4))]
    mut = np.array(mut)
    hit = rng.random(len(mut)) < sub
    mut[hit] = rng.integers(0, 4, int(hit.sum()))
    return np.concatenate([mut, rng.integers(0, 4, max(lb - len(mut), 0))]
                          )[:lb]


def case_inputs(name: str):
    """The batch of a case: DNA pairs (a sequence and a mutant), the band
    of pair 0 spanning all the lanes from lw0 = its lw, the others'
    inside them."""
    lengths, nlane, exg, tgapf, u, ask = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    mtx, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))
    pairs = []
    for La, Lb in lengths:
        a = rng.integers(0, 4, La)
        b = mutant(rng, a, Lb)
        pairs.append(tuple(ab.encode("".join("ACGT"[c] for c in x), ab.DNA)
                           .astype(np.int64) for x in (a, b)))
    Bn = len(pairs)
    la = np.array([len(a) for a, _ in pairs], np.int32)
    lb = np.array([len(b) for _, b in pairs], np.int32)
    A = np.zeros((Bn, int(la.max())), np.int32)
    Bm = np.zeros((Bn, int(lb.max())), np.int32)
    for i, (a, b) in enumerate(pairs):
        A[i, :len(a)] = a
        Bm[i, :len(b)] = b
    lw = -(la // 2).astype(np.int32)
    lw[0] = lw.min()
    # the others' bands reach their corner (lb - la) where the lanes do
    up = np.minimum(np.maximum(lb - la, 0) + la // 2, lw[0] + nlane - 1)
    up[0] = lw[0] + nlane - 1
    assert int(up.max()) - int(lw.min()) + 1 == nlane
    if exg is None:
        exg = rng.random((Bn, 4)) < 0.25
    t = torch.as_tensor
    args = (t(A), t(Bm), t(la), t(lb), t(lw), t(up.astype(np.int32)),
            t(mtx.astype(np.float32)), t(np.full(Bn, u, np.float32)),
            t(np.full(Bn, 9.0, np.float32)), t(np.full(Bn, tgapf, np.float32)),
            t(np.broadcast_to(np.asarray(exg, bool), (Bn, 4)).copy()))
    return args, int(lw.min()), nlane, ask


def pack(path: Path, args, lw0: int, nlane: int, ask: dict) -> dict:
    a, b, la, lb, lw, up, mtx, u, v, tg, exg = args
    plan = P.rows_plan(nlane, a.shape[0], mtx.shape[0], a.shape[1],
                       b.shape[1], **ask)
    code = 4 if plan["state"] == "device" else P._K1F_VARIANTS[plan["variant"]]
    head = np.array([a.shape[0], a.shape[1], b.shape[1], mtx.shape[0], lw0,
                     nlane, code, plan["lanes"], plan["threads"],
                     plan["code_stride"], plan["smem_bytes"], plan["ctas"]],
                    np.int32)
    with path.open("wb") as f:
        f.write(head.tobytes())
        for x in (a, b, la, lb, lw, up, u, v, tg):
            f.write(x.contiguous().numpy().tobytes())
        f.write(exg.to(torch.uint8).numpy().tobytes())
        f.write(mtx.contiguous().numpy().tobytes())
    return plan


def run_case(exe: Path, name: str, tmp: Path) -> dict:
    args, lw0, nlane, ask = case_inputs(name)
    plan = pack(tmp / "in.bin", args, lw0, nlane, ask)
    res = subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin")],
                         capture_output=True, text=True, timeout=1800)
    rec = {"case": name, "lanes_swept": nlane, "rows": int(args[2].max()),
           **{k: plan[k] for k in ("variant", "lanes", "warps", "ctas",
                                   "state", "smem_bytes")},
           "rc": res.returncode}
    if res.returncode != 0:
        rec["stderr"] = res.stderr[-3000:]
        rec["equal"] = False
        return rec
    got = torch.from_numpy(np.frombuffer((tmp / "out.bin").read_bytes(),
                                         np.float32).copy())
    ref = P._plain_rows(*args, lw0, nlane)
    rec["equal"] = torch.equal(got.view(torch.int32), ref.view(torch.int32))
    rec["scores"] = got.tolist()
    if not rec["equal"]:
        rec["plain"] = ref.tolist()
    if "race" in res.stderr or "ERROR" in res.stderr:
        rec["stderr"] = res.stderr[-3000:]
        rec["equal"] = False
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sanitize", choices=("address", "thread"),
                    default="address")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--src", type=Path,
                    default=REPO / "prrn_aln_tpu_torch" / "csrc")
    ap.add_argument("--mutate", choices=sorted(MUTATIONS))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    out_dir = REPO / "build" / "k1f_emulate"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = build(args.src, args.sanitize, args.mutate, out_dir)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.cases.split(","):
            rec = run_case(exe, name, Path(tmp))
            rec.update(sanitize=args.sanitize, mutate=args.mutate)
            print(json.dumps(rec), flush=True)
            bad += not rec["equal"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
