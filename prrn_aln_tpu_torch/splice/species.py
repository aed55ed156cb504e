"""Species-specific parameter tables (the reference's ``-T`` system).

The reference resolves ``-T <species>`` to a directory under the
``ALN_TAB`` table root (iolib.cc:297-333) and then
* parses ``<species>/AlnParam`` as an extra command line
  (AlnServer::readargs, autocomp.h:328-366) — in practice one ``-yI``
  option carrying the Frechet intron-length-distribution parameters
  (simmtx.cc:676-684 sscanf order: llmt rlmt mean a1 m1 t1 k1 m2 t2 k2
  [a2 m3 t3 k3]);
* loads ``Splice5`` / ``Splice3`` context PWMs (PatMat text blocks,
  utilseq.cc readPatMat) replacing the built-in canonical tables.

``load_species`` returns table overrides consumable by
``SpliceSignals.build(tabs=...)`` / ``build_exin(tabs=...)`` plus the
intron-length parameters for ``IntronPenalty.build``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np


def table_root() -> Path | None:
    root = os.environ.get("ALN_TAB")
    return Path(root) if root else None


def species_dir(name: str) -> Path:
    p = Path(name)
    if p.is_dir():
        return p
    root = table_root()
    if root and (root / name).is_dir():
        return root / name
    raise FileNotFoundError(
        f"species table dir '{name}' not found (set ALN_TAB)")


def read_patmat(path: Path):
    """One PatMat text block: header `rows cols offset [trans skip
    tonic ...]`, `skip` comment lines, then rows x cols floats
    (utilseq.cc readPatMat)."""
    lines = path.read_text().splitlines()
    hdr = lines[0].split()
    rows, cols, offset = int(hdr[0]), int(hdr[1]), int(hdr[2])
    trans = int(hdr[3]) if len(hdr) > 3 else 0
    skip = int(hdr[4]) if len(hdr) > 4 else 0
    flat: list[float] = []
    for ln in lines[1 + skip:]:
        flat.extend(float(x) for x in ln.split())
        if len(flat) >= rows * cols:
            break
    # the reference's transpose flag swaps rows/cols logically while the
    # storage stays row-major (utilseq.cc:767) — i.e. the file already
    # lies in (position, feature) orientation when trans=1
    mtx = np.array(flat[: rows * cols], np.float64).reshape(rows, cols)
    del trans
    return mtx, offset


def parse_alnparam(path: Path) -> dict:
    """Extract recognized options from an AlnParam file.  Returns
    {'yI': [floats...]} plus raw tokens for diagnostics."""
    text = path.read_text()
    out: dict = {"raw": text.strip()}
    m = re.search(r'-yI"([^"]+)"', text)
    if m:
        out["yI"] = [float(x) for x in m.group(1).split()]
    return out


def load_species(name: str) -> dict:
    """Species table bundle: PWM overrides + intron-length params."""
    d = species_dir(name)
    out: dict = {"dir": str(d), "tabs": {}}
    ap = d / "AlnParam"
    if ap.exists():
        out.update(parse_alnparam(ap))
    for fn, key in (("Splice5", "splice5"), ("Splice3", "splice3")):
        f = d / fn
        if f.exists():
            mtx, offset = read_patmat(f)
            out["tabs"][f"{key}_mtx"] = mtx
            out["tabs"][f"{key}_offset"] = np.int64(offset)
    return out


def ipen_kwargs(sp: dict) -> dict:
    """Map the species -yI vector onto IntronPenalty.build kwargs."""
    yi = sp.get("yI")
    if not yi:
        return {}
    keys = ["llmt", "rlmt", "mean", "a1", "m1", "t1", "k1",
            "m2", "t2", "k2", "a2", "m3", "t3", "k3"]
    kw = dict(zip(keys, yi))
    kw["llmt"] = int(kw["llmt"])
    kw["rlmt"] = int(kw["rlmt"])
    return kw
