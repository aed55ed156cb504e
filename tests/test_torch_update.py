"""The port's prrn on pre-aligned inputs, plain versions on the CPU,
against the JAX package: the combine step and the update mode (``-U``)
on Multi_A and Multi_B (rows equal to the reference's goldens), the
gap snapshot (``--prntgap``/``--readgap``), the report bits ``-O 2`` and
``-O 4`` (``-O 7``), ``-ps``, ``-s`` and ``-V``'s progress lines.

``jax_prrn_U_R0_multiAB.txt`` is the JAX package's output, written by
``tools/write_jax_fixtures.py``; the other cases run both packages."""

import contextlib
import io as _io
import json
import re
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu.cli import prrn_main as jax_prrn_main
from prrn_aln_tpu_torch import io as pio
from prrn_aln_tpu_torch.cli import prrn_main

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"


def _run(main, argv):
    out, err = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue(), err.getvalue()


def _both(argv):
    """(port, JAX) standard output and error of prrn on ``argv``."""
    return _run(prrn_main, [*argv, "--device", "cpu"]), _run(jax_prrn_main,
                                                             argv)


def _rows(text):
    rows = {}
    for line in text.splitlines():
        mt = re.match(r"\s*\d+ (.{1,61})\| (\S+)", line)
        if mt:
            rows.setdefault(mt.group(2), []).append(mt.group(1).rstrip())
    return {k: "".join(v) for k, v in rows.items()}


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """Multi_A and Multi_B rebuilt from the galign fixture, as
    tests/test_update.py does."""
    tmp = tmp_path_factory.mktemp("multi")
    gfix = json.loads((FIX / "galign_fixtures.json").read_text())
    paths = []
    for key in ("pas/Multi_A", "pas/Multi_B"):
        info = gfix["files"][key]
        p = tmp / key.split("/")[-1]
        with open(p, "w") as f:
            f.write(f"{len(info['rows']):5d}{len(info['rows'][0]):6d}\tx\n")
            for n, r in zip(info["names"], info["rows"]):
                f.write(f">{n}\n{r}\n/\n")
        paths.append(str(p))
    return paths


def _prealigned(native: Path, out: Path) -> str:
    out.write_text("".join(f">{r.name}\n{r.seq}\n"
                           for r in pio.sniff_and_read(native)))
    return str(out)


def test_combine_matches_golden_and_jax(multi):
    """No ``-U``: the two hosts are merged (host group alignment) and not
    refined; every row equals the reference's group merge."""
    (got, _), (want, _) = _both(["-R", "0", *multi])
    assert got == want
    assert _rows(got) == _rows((FIX / "golden_aln_multiAB.txt").read_text())


def _progress(err):
    """-V's lines without the seconds field, which is the run's own."""
    return [re.sub(r", +\d+ sec$", "", ln) for ln in err.splitlines()
            if "<--" in ln]


def test_update_refine_matches_jax_fixture(multi, monkeypatch):
    """``-U -R 0``: the combined hosts refined on K2/K3's plain versions,
    byte-identical to the JAX package's output and with every row of the
    reference's golden; ``-V``'s progress lines equal the JAX CLI's."""
    monkeypatch.setenv("PRRN_PROGRESS", "0")     # -V sets it to 1
    got, err = _run(prrn_main, ["-U", "-R", "0", "-V", *multi,
                                "--device", "cpu"])
    assert got == (FIX / "jax_prrn_U_R0_multiAB.txt").read_text()
    golden = _rows((FIX / "golden_prrn_U_R0.txt").read_text())
    assert list(_rows(got)) == list(golden) and _rows(got) == golden
    monkeypatch.setenv("PRRN_PROGRESS", "0")
    _, jerr = _run(jax_prrn_main, ["-U", "-R", "0", "-V", *multi])
    assert _progress(err) and _progress(err) == _progress(jerr)


def test_gap_snapshot_roundtrip_matches_jax(multi, tmp_path):
    """``--prntgap`` writes the same snapshot as the JAX CLI; ``--readgap``
    rebuilds the hosts from it to the same output."""
    snap, jsnap = tmp_path / "port.gaps", tmp_path / "jax.gaps"
    got = _run(prrn_main, ["-R", "0", "--prntgap", str(snap), *multi,
                           "--device", "cpu"])
    want = _run(jax_prrn_main, ["-R", "0", "--prntgap", str(jsnap), *multi])
    assert got == want
    assert snap.read_bytes() == jsnap.read_bytes()
    assert snap.read_text().startswith("Gaps structure: 6\n")
    got, want = _both(["-R", "0", "--readgap", str(snap), *multi])
    assert got == want


@pytest.mark.parametrize("native", ["jax_prrn_ce13a17_clean_R0.txt",
                                    "jax_prrn_fam19_R0.txt"])
def test_report_bits_match_jax(native, tmp_path):
    """``-O 7`` on one pre-aligned input: the alignment, the Dixon
    outlier report and the SP line (7 members: ``wsp`` with pair
    weights; 19: the tree-structured ``sptree``)."""
    path = _prealigned(FIX / native, tmp_path / "aligned.fa")
    (got, _), (want, _) = _both(["-O", "7", path])
    assert got == want
    assert re.match(r"\S+ \[ (7|19) \] \d+\t", got.splitlines()[-1])


def test_tree_sorted_output_and_srcdir_match_jax(multi):
    """``-ps`` sorts the rows by the guide tree; ``-s DIR`` resolves the
    input names inside DIR."""
    srcdir = str(Path(multi[0]).parent)
    names = [Path(p).name for p in multi]
    (got, _), (want, _) = _both(["-R", "0", "-ps", "-s", srcdir, *names])
    assert got == want
    plain, _ = _run(prrn_main, ["-R", "0", *multi, "--device", "cpu"])
    assert sorted(_rows(got).items()) == sorted(_rows(plain).items())
    assert list(_rows(got)) != list(_rows(plain))
