"""Command-line entry points ``prrn`` (MSA) and ``aln`` (gene
prediction) of the port.

Counterparts of ``prrn_aln_tpu/cli.py::prrn_main`` for the flags the
default path and its output use, and of ``aln_main``'s spliced branch
for a protein or aligned protein MSA query against genomic DNA
(``aln -yl2``).  The port adds ``--device`` (default ``cuda``); a CUDA
device that is absent is an error, never a switch to the CPU.  Every
other flag or mode of the JAX ``prrn`` and ``aln`` is accepted and exits
with a "not yet ported" error.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

from . import alphabet as ab
from . import io
from .config import default_params
from .pipeline import build_msa
from .utils.runstat import RunStat

# flags of the JAX prrn that are accepted but not yet ported, with the
# value that means "not given"
_NOT_PORTED = {"U": False, "b": None, "G": None, "e": None, "ckpt": None,
               "resume": None, "srcdir": None, "ps": False,
               "verbose": False, "prntgap": None, "readgap": None}


def _out(msa, fmt: str, path=None, markeij: int = 0):
    if fmt == "fasta":
        text = io.write_fasta(msa)
    elif fmt == "clustal":
        text = io.write_clustal(msa)
    else:
        text = io.write_native_block(msa, markeij=markeij)
    if path:
        Path(path).write_text(text)
    else:
        sys.stdout.write(text)


def _add_sshp_args(p) -> None:
    """Protein structure-propensity score options (reference -ys/-yh/-yr,
    simmtx.cc:639-657 readOption)."""
    p.add_argument("-ys", type=float, default=None, metavar="F",
                   help="secondary-structure propensity factor")
    p.add_argument("-yh", default=None, metavar="F[,WING]",
                   help="hydrophobicity factor (optional window wing)")
    p.add_argument("-yr", default=None, metavar="F[,NANGLE]",
                   help="hydrophobic-moment factor (NANGLE=1: 100deg, "
                        "2: also 180deg)")


def _apply_sshp(args) -> None:
    """Configure the global ssp term from parsed flags (ssp.cc
    initSsHpPrm; alprm3 defaults simmtx.cc:50)."""
    from .msa import sshp
    scnd = args.ys if args.ys is not None else 0.0
    hydr = hpmt = 0.0
    hpwing, no_angle = 3, 0
    if args.yh:
        head, _, tail = str(args.yh).partition(",")
        if head:
            hydr = float(head)
        if tail:
            hpwing = int(tail)
    if args.yr:
        head, _, tail = str(args.yr).partition(",")
        if head:
            hpmt = float(head)
        if tail:
            no_angle = int(tail)
    sshp.activate(scnd=scnd, hydr=hydr, hpmt=hpmt, hpwing=hpwing,
                  no_angle=no_angle)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return dev


def prrn_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="prrn",
        description="multiple sequence alignment with randomized "
                    "iterative refinement (PyTorch and CUDA port)")
    p.add_argument("inputs", nargs="*", help="sequence files")
    p.add_argument("-u", type=float, default=None, help="gap extension")
    p.add_argument("-v", type=float, default=None, help="gap open")
    p.add_argument("-w", type=int, default=None, help="band shoulder")
    p.add_argument("-S", type=int, default=10, help="max outer iterations")
    p.add_argument("-R", type=int, default=1, help="random seed (0 = none)")
    p.add_argument("-I", type=int, default=1, help="refinement recycles")
    p.add_argument("-F", choices=["native", "fasta", "clustal"],
                   default="native", help="output format")
    p.add_argument("-o", default=None, help="output file")
    p.add_argument("-yp", type=int, default=None, help="PAM level")
    p.add_argument("-O", type=int, default=1,
                   help="output bits: 1=alignment (2 and 4 not yet ported)")
    p.add_argument("-YH", type=float, default=35.0,
                   help="consreg threshold (0 disables)")
    p.add_argument("-ph", action="store_true", dest="ph",
                   help="color intron positions as HTML (reference -ph)")
    p.add_argument("-pi", action="store_true", dest="pi",
                   help="color intron positions (ANSI escapes)")
    p.add_argument("-yJ", type=float, default=None,
                   help="intron-position match bonus (default 20)")
    _add_sshp_args(p)
    p.add_argument("-r", type=int, default=1, metavar="N",
                   help="best-of-N speculative refinement fan-out, one "
                        "batched launch per N candidates")
    p.add_argument("-J", type=int, default=2, choices=[0, 1, 2, 3],
                   help="division mode: 1=leave-one-out, 2=tree edges "
                        "(default), 3=all bipartitions, 0=random subsets")
    p.add_argument("-E", nargs="?", const="-", default=None,
                   metavar="FILE", help="write phase-interval run "
                        "statistics (RunStat, prrn5.h:263-283)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the DP kernels (default cuda)")
    nyp = "not yet ported: see ROADMAP.md"
    p.add_argument("-U", action="store_true", help=nyp)
    p.add_argument("-b", default=None, metavar="TREE", help=nyp)
    p.add_argument("-G", default=None, metavar="GROUPS", help=nyp)
    p.add_argument("-e", default=None, metavar="PREFIX", help=nyp)
    p.add_argument("--ckpt", default=None, metavar="FILE", help=nyp)
    p.add_argument("--resume", default=None, metavar="FILE", help=nyp)
    p.add_argument("-s", dest="srcdir", default=None, metavar="DIR",
                   help=nyp)
    p.add_argument("-ps", action="store_true", dest="ps", help=nyp)
    p.add_argument("-V", action="store_true", dest="verbose", help=nyp)
    p.add_argument("--prntgap", default=None, metavar="FILE", help=nyp)
    p.add_argument("--readgap", default=None, metavar="FILE", help=nyp)
    args = p.parse_args(argv)
    given = [k for k, unset in _NOT_PORTED.items()
             if getattr(args, k) != unset]
    if args.O & ~1:
        given.append(f"O {args.O}")
    if given:
        p.error(f"not yet ported: see ROADMAP.md: "
                f"{', '.join('-' + g for g in given)}")
    device = _device(args.device)
    _apply_sshp(args)
    runstat = RunStat()
    runstat.setfmessg(args.E)
    runstat.stamp(0)

    per_file = [io.sniff_and_read(f) for f in args.inputs]
    records = [r for recs in per_file for r in recs]
    if not records:
        print("no sequences read", file=sys.stderr)
        return 1
    if any(len(recs) > 1 and len({len(r.seq) for r in recs}) == 1
           and any("-" in r.seq for r in recs) for recs in per_file):
        p.error("pre-aligned inputs (update mode) are not yet ported: "
                "see ROADMAP.md")
    molc = ab.infer_molc(records[0].seq)
    params = default_params(molc, "prrn")
    over = {}
    if args.u is not None:
        over["u"] = args.u
    if args.v is not None:
        over["v"] = args.v
    if args.w is not None:
        over["sh"] = args.w
    if args.yp is not None:
        over["pam"] = args.yp
    if args.yJ is not None:
        over["spb"] = args.yJ
    if over:
        params = dataclasses.replace(params, **over)

    divmode = {0: "part", 1: "one", 2: "tree", 3: "all"}[args.J]
    msa = build_msa(records, params=params, molc=molc, maxitr=args.S,
                    randseed=args.R, refine=args.I > 0, local_thr=args.YH,
                    nbatch=args.r, divmode=divmode, device=device)
    runstat.stamp(1)
    if args.O & 1:
        _out(msa, args.F, args.o,
             markeij=2 if args.ph else (1 if args.pi else 0))
    runstat.conclude()
    return 0


# aln flags of the JAX package that are accepted but not yet ported,
# with the value that means "not given"
_ALN_NOT_PORTED = {"a": False, "b": None, "imode": None, "R": 0,
                   "M": False, "m": None, "F": None, "ncolony": None,
                   "ckpt": None, "ys": None, "yh": None, "yr": None}


def _aln_argv(argv) -> list[str]:
    """The JAX aln's argv rewriting: a bare ``-L`` (reference local
    mode) must not consume the next positional, and multi-char short
    options take glued values (``-yl2`` -> ``-yl 2``)."""
    argv = ["-Ll" if t == "-L" else t for t in argv]
    split = []
    for t in argv:
        glued = False
        if len(t) > 3 and t[:3] in ("-yl", "-yp", "-yJ"):
            try:                       # -yJ takes float values (-yJ0.5)
                float(t[3:])
                glued = True
            except ValueError:
                glued = False
        if glued:
            split.extend([t[:3], t[3:]])
        else:
            split.append(t)
    return split


def aln_main(argv=None) -> int:
    """``aln -yl2|-yl3 <genome> <protein | aligned protein MSA>``: gene
    prediction by the spliced DP (fwd2h) on ``--device``."""
    from .splice.hapi import spliced_align_h
    if argv is None:
        argv = sys.argv[1:]
    p = argparse.ArgumentParser(
        prog="aln",
        description="gene prediction: protein or protein MSA against "
                    "genomic DNA (PyTorch and CUDA port)")
    p.add_argument("inputs", nargs="*", help="genome and query files")
    p.add_argument("-u", type=float, default=None, help="gap extension")
    p.add_argument("-v", type=float, default=None, help="gap open")
    p.add_argument("-w", type=int, default=None, help="band shoulder")
    p.add_argument("-o", default=None, help="output file")
    p.add_argument("-yp", type=int, default=None, help="PAM level")
    p.add_argument("-G", action="store_true",
                   help="spliced alignment: first input is genomic DNA")
    p.add_argument("-s", dest="srcdir", default=None, metavar="DIR",
                   help="directory containing the input files")
    p.add_argument("-pi", action="store_true", dest="pi",
                   help="color intron positions (ANSI; reference -pi)")
    p.add_argument("-ph", action="store_true", dest="ph",
                   help="color intron positions as HTML (reference -ph)")
    p.add_argument("-yl", type=int, default=None,
                   help="2/3: spliced (gene-prediction) alignment")
    p.add_argument("-O", type=int, default=1,
                   help="output mode: 0 gff3, 1 alignment, 2 gff3 match, "
                        "3 bed, 4 exons, 5 introns")
    p.add_argument("-L", nargs="?", const="s", default=None,
                   help="local mode (bare -L: the default; -L s not yet "
                        "ported)")
    p.add_argument("-yJ", type=float, default=None,
                   help="intron-position match bonus (default 20)")
    p.add_argument("-T", default=None, metavar="SPECIES",
                   help="species parameter tables under $ALN_TAB")
    p.add_argument("--device", default="cuda",
                   help="torch device of the spliced DP (default cuda)")
    nyp = "not yet ported: see ROADMAP.md"
    p.add_argument("-a", action="store_true", help=nyp)
    p.add_argument("-b", default=None, metavar="TREE", help=nyp)
    p.add_argument("-i", dest="imode", default=None, metavar="MODE",
                   help=nyp)
    p.add_argument("-F", default=None, help=nyp)
    p.add_argument("-R", type=int, default=0, metavar="N", help=nyp)
    p.add_argument("-M", action="store_true", help=nyp)
    p.add_argument("-C", dest="ncolony", type=int, default=None, help=nyp)
    p.add_argument("-m", default=None, metavar="MATRIX", help=nyp)
    p.add_argument("--ckpt", default=None, metavar="FILE", help=nyp)
    for flag in ("-ys", "-yh", "-yr"):
        p.add_argument(flag, default=None, help=nyp)
    args = p.parse_args(_aln_argv(argv))
    given = [k for k, unset in _ALN_NOT_PORTED.items()
             if getattr(args, k) != unset]
    if args.L == "s":
        given.append("L s")
    if not (args.G or args.yl in (2, 3)):
        given.append("without -yl2/-yl3 (pair and group alignment)")
    if given:
        p.error(f"not yet ported: see ROADMAP.md: "
                f"{', '.join('-' + g for g in given)}")
    if len(args.inputs) != 2:
        p.error("aln needs exactly two inputs: genome and query")
    device = _device(args.device)
    inputs = args.inputs
    if args.srcdir:
        inputs = [str(Path(args.srcdir) / f)
                  if (Path(args.srcdir) / f).exists() else f
                  for f in inputs]
    grecs = io.sniff_and_read(inputs[0])
    qrecs = io.sniff_and_read(inputs[1])
    if ab.infer_molc(qrecs[0].seq) != ab.PROTEIN:
        p.error("not yet ported: see ROADMAP.md: a DNA query (cDNA "
                "against genome, fwd2s)")
    mode = args.O & 7 if args.O < 16 else args.O
    common = dict(gname=grecs[0].name,
                  sh=args.w if args.w is not None else -50, u=args.u,
                  v=args.v, pam=args.yp, yj=args.yJ, species=args.T,
                  device=device)
    out = []
    if len(qrecs) > 1 and len({len(r.seq) for r in qrecs}) == 1:
        # an aligned MSA: the DP runs against its weighted profile
        msa = io.records_to_msa(qrecs, ab.PROTEIN)
        res = spliced_align_h(grecs[0].seq, None, qname=qrecs[0].name,
                              msa=msa, **common)
        out.append(res.render(mode, markeij=2 if args.ph
                              else (1 if args.pi else 0)))
    else:
        for q in qrecs:
            res = spliced_align_h(grecs[0].seq, q.seq, qname=q.name,
                                  **common)
            out.append(res.render(mode))
    text = "".join(out)
    if args.o:
        Path(args.o).write_text(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(prrn_main())
