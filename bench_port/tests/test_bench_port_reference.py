"""The plain reference against the port's plain versions on the host:
its NumPy K2 bit for bit against ``group.group_wavefront_ref``, its
frozen PyTorch K2 likewise, and its whole ``prrn -R 0`` against the
command line's output on the CPU (the program's plain path)."""

import numpy as np
import pytest
import torch

from harness import check, families as fam
from prrn_ref.ops import group as rg, wavefront_np
from prrn_aln_tpu_torch import alphabet as ab, scoring
from prrn_aln_tpu_torch.config import AlnParams
from prrn_aln_tpu_torch.msa.msa import Msa
from prrn_aln_tpu_torch.ops import group as tg
from prrn_aln_tpu_torch.ops.window import stripe

torch.set_num_threads(1)
MTX, _ = scoring.protein_matrix(AlnParams(pam=150))


def rand_msa(rng, many, length, gap, weighted):
    codes = (rng.integers(0, 20, size=(many, length)) + ab.ALA).astype(
        np.int8)
    codes[rng.random((many, length)) < gap] = ab.GAP
    codes[:, 0] = ab.ALA + rng.integers(0, 20)
    m = Msa(codes=codes, molc=ab.PROTEIN, names=[f"s{i}" for i in
                                                 range(many)])
    if weighted:
        m.weight = rng.random(many) + 0.5
    m.prepare(MTX.shape[0])
    return m


@pytest.mark.parametrize("seed,many,gap,weighted,sh", [
    (0, (1, 1), 0.0, False, -60), (1, (3, 2), 0.1, False, -60),
    (2, (4, 5), 0.2, True, -60), (3, (7, 6), 0.3, True, -100),
    (4, (2, 8), 0.15, True, 30)])
def test_numpy_k2_equals_the_ports_plain_version(seed, many, gap, weighted,
                                                 sh):
    rng = np.random.default_rng(seed)
    pairs = [(rand_msa(rng, many[0], int(rng.integers(30, 90)), gap,
                       weighted),
              rand_msa(rng, many[1], int(rng.integers(30, 90)), gap,
                       weighted)) for _ in range(3)]
    an = max(max(a.many, b.many) for a, b in pairs) + 1
    la_max = lb_max = tg._bucket(max(max(a.length, b.length)
                                     for a, b in pairs))
    wdws = [stripe(a.length, b.length, sh) for a, b in pairs]
    nslot = tg._bucket(max(w.up - w.lw + 3 for w in wdws), 128)
    nsteps = tg._bucket(max(a.length + b.length + 1 for a, b in pairs), 256)
    items = [tg._pack_inputs(a, b, MTX, 2.0, 9.0, w, an, an, la_max,
                             lb_max) for (a, b), w in zip(pairs, wdws)]
    ins = tg.stack_inputs(items, "cpu")
    want = tg.group_wavefront_ref(ins, nslot=nslot, nsteps=nsteps)
    got = wavefront_np.group_wavefront(
        {k: v.numpy() for k, v in ins.items()}, nslot=nslot, nsteps=nsteps)
    assert np.array_equal(got[0].view(np.int32),
                          want[0].numpy().view(np.int32))
    assert np.array_equal(got[1], want[1].numpy())
    assert np.array_equal(got[2], want[2].numpy())
    frozen = rg.group_wavefront_ref(rg.stack_inputs(items, "cpu"),
                                    nslot=nslot, nsteps=nsteps)
    for a, b in zip(frozen[:3], want[:3]):
        assert torch.equal(a, b)


def test_fma_sum_skips_zeros_exactly():
    rng = np.random.default_rng(5)
    x = rng.random((3, 40, 9)).astype(np.float32).astype(np.float64)
    terms = x * (rng.random((3, 40, 9)) < 0.3) * 1e3
    acc = np.zeros((3, 40), np.float32)
    for k in range(9):
        acc = (acc.astype(np.float64) + terms[..., k]).astype(np.float32)
    assert np.array_equal(wavefront_np._fma_sum(terms), acc)


@pytest.mark.parametrize("seed,shape", [(2 ** 31 + 1, (5, 70)),
                                        (17, (7, 50))])
def test_reference_equals_the_command_line_on_the_host(tmp_path, seed,
                                                        shape):
    from prrn_aln_tpu_torch.cli import prrn_main
    from prrn_ref.pipeline import align_family
    cfg = {"generator": "tree_family",
           "family": {"identity": [0.2, 0.4], "length_spread": 0.1,
                      "inner_height": 0.8, "indel_rate": 0.03,
                      "indel_max": 5}}
    f = fam.pool([seed, 2], cfg, [list(shape)])[0]
    (tmp_path / "f.fa").write_text(f.fasta())
    assert prrn_main(["-R", "0", "--device", "cpu", "-o",
                      str(tmp_path / "o.txt"), str(tmp_path / "f.fa")]) == 0
    got = check.read_native((tmp_path / "o.txt").read_text())
    assert check.rows_differ(got, align_family(f.names, f.seqs)) == 0
