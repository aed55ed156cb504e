"""Command-line entry points ``prrn`` (MSA) and ``aln`` (pairwise, group
and spliced alignment) of the port.

Counterparts of ``prrn_aln_tpu/cli.py::prrn_main`` and ``aln_main``:
the same flags and the same output bytes.  The port adds ``--device``
(default ``cuda``); a CUDA device that is absent is an error, never a
switch to the CPU.  ``refgs_main`` is the counterpart of the JAX
package's ``refgs`` (concerted gene-structure refinement).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import torch

from . import alphabet as ab
from . import io, scoring
from .config import default_params
from .msa.merge import merge_msas
from .msa.progressive import align_pair
from .pipeline import build_msa
from .utils.runstat import load_checkpoint, runstat, save_checkpoint

_DIVMODE = {0: "part", 1: "one", 2: "tree", 3: "all"}


def _resolve_inputs(inputs, srcdir):
    """Reference -s: input names resolve inside the source directory
    (iolib makefnam path search)."""
    if not srcdir:
        return inputs
    out = []
    for f in inputs:
        cand = Path(srcdir) / f
        out.append(str(cand) if cand.exists() else f)
    return out


def _write(text: str, path) -> None:
    if path:
        Path(path).write_text(text)
    else:
        sys.stdout.write(text)


def _out(msa, fmt: str, path=None, markeij: int = 0):
    if fmt == "fasta":
        text = io.write_fasta(msa)
    elif fmt == "clustal":
        text = io.write_clustal(msa)
    else:
        text = io.write_native_block(msa, markeij=markeij)
    _write(text, path)


def _emit(msa, args):
    """prrn output modes (Msa::output, prrn5.cc:1738-1806)."""
    if getattr(args, "ps", False):
        msa = io.tree_sorted(msa)
    if args.O & 1:
        _out(msa, args.F, args.o,
             markeij=(2 if getattr(args, "ph", False)
                      else (1 if getattr(args, "pi", False) else 0)))
    need_tree = args.O & (2 | 4)
    if need_tree and msa.many > 2:
        from .msa import distance as dmod, tree as tmod, wsp
        d = dmod.msa_distance_matrix(msa.codes)
        t = tmod.upgma(d, msa.many)
        pairwt, vol = tmod.calc_pair_weights(t)
        mtx, _ = scoring.build_matrix(msa.molc, default_params(msa.molc,
                                                               "prrn"))
        if args.O & 2:
            from .msa.outliers import find_outliers, outlier_report
            outs = find_outliers(msa, t, mtx)
            sys.stdout.write(outlier_report(msa, outs))
        if args.O & 4:
            span = msa.length
            ncomb = msa.many * (msa.many - 1) // 2
            sp = wsp.wsp_score(msa, mtx, v=9.0)
            if msa.many >= 10:
                # tree-structured WSP (Sptree, fspscore.cc:783-860)
                from .msa.sptree import sptree_wsp
                wspv, _ = sptree_wsp(msa, mtx, v=9.0, tree=t)
            else:
                wspv = wsp.wsp_score(msa, mtx, v=9.0, pairwt=pairwt)
            npw = float(pairwt.sum())
            print(f"{msa.names[0]} [ {msa.many} ] {span}\t"
                  f"{sp:7.1f} {100.0 * sp / ncomb / span:7.3f} "
                  f"{wspv:7.1f} {100.0 * wspv / npw / span:7.3f}")


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
    p.add_argument("-U", action="store_true",
                   help="update mode: refine combined pre-aligned inputs")
    p.add_argument("-b", default=None, metavar="TREE",
                   help="guide tree file (Newick; leaves name seq files)")
    p.add_argument("-O", type=int, default=1,
                   help="output bits: 1=alignment, 2=outliers, 4=SP scores")
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
    p.add_argument("-G", default=None, metavar="GROUPS",
                   help="member grouping, e.g. '1 2/3-5/6' (groups "
                        "separated by /, 1-based indices and a-b ranges; "
                        "reference Subset, sets.h:27-45); refinement "
                        "bipartitions never split a group")
    p.add_argument("-J", type=int, default=2, choices=[0, 1, 2, 3],
                   help="division mode: 1=leave-one-out, 2=tree edges "
                        "(default), 3=all bipartitions, 0=random subsets")
    p.add_argument("-E", nargs="?", const="-", default=None,
                   metavar="FILE", help="write phase-interval run "
                        "statistics (RunStat, prrn5.h:263-283)")
    p.add_argument("-e", default=None, metavar="PREFIX",
                   help="write each sub-MSA to PREFIX.N instead of "
                        "merging (prrn5.cc:1099-1107)")
    p.add_argument("--ckpt", default=None, metavar="FILE",
                   help="save a refinement checkpoint (MSA+seed+iter)")
    p.add_argument("--resume", default=None, metavar="FILE",
                   help="resume from a checkpoint written by --ckpt")
    p.add_argument("-s", dest="srcdir", default=None, metavar="DIR",
                   help="directory containing the input files "
                        "(reference -s, iolib setdfn)")
    p.add_argument("-ps", action="store_true", dest="ps",
                   help="sort output rows by guide-tree leaf order "
                        "(reference BY_TREE phylsort, prrn5.cc:1607)")
    p.add_argument("-V", action="store_true", dest="verbose",
                   help="per-pass WSP progress lines on stderr "
                        "(reference MONIT prompt, prrn5.cc:772-780)")
    p.add_argument("--prntgap", default=None, metavar="FILE",
                   help="dump the per-member gap-structure snapshot "
                        "(IterMsa::prntgap, prrn5.cc:287)")
    p.add_argument("--readgap", default=None, metavar="FILE",
                   help="rebuild the input alignment from a gap "
                        "snapshot before refining (IterMsa::readgap, "
                        "prrn5.cc:294)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the DP kernels (default cuda)")
    args = p.parse_args(argv)
    device = _device(args.device)
    args.inputs = _resolve_inputs(args.inputs, args.srcdir)
    if args.verbose:
        os.environ["PRRN_PROGRESS"] = "1"
    _apply_sshp(args)
    runstat.reset()                  # the pipeline stamps its phases too
    runstat.setfmessg(args.E)
    runstat.stamp(0)

    if args.b:
        from .pipeline import build_msa_guided
        msa = build_msa_guided(args.b, randseed=args.R, maxitr=args.S,
                               refine=args.I > 0, device=device)
        _emit(msa, args)
        return 0

    if args.resume:
        # as in the JAX package: the inputs and -u/-v are not read here
        from .msa.refine import refine_msa
        msa, meta = load_checkpoint(args.resume)
        params = default_params(msa.molc, "prrn")
        mtx, _ = scoring.build_matrix(msa.molc, params)
        res = refine_msa(msa, mtx, u=params.u, v=params.v, sh=params.sh,
                         maxitr=args.S, randseed=meta["randseed"],
                         nbatch=args.r, spb=params.spb,
                         divmode=_DIVMODE[args.J], device=device)
        msa = res.msa
        if args.ckpt:
            save_checkpoint(args.ckpt, msa, meta["randseed"], args.S)
        runstat.stamp(1)
        _emit(msa, args)
        runstat.conclude()
        return 0

    per_file = [io.sniff_and_read(f) for f in args.inputs]
    records = [r for recs in per_file for r in recs]
    if not records:
        print("no sequences read", file=sys.stderr)
        return 1
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

    # pre-aligned multi-member files become host groups (update flow)
    def is_aligned(recs):
        return (len(recs) > 1 and len({len(r.seq) for r in recs}) == 1
                and any("-" in r.seq for r in recs))

    divmode = _DIVMODE[args.J]
    hosts_present = any(is_aligned(recs) for recs in per_file)
    if args.G:
        # grouped refinement of one pre-aligned input (prrn5 -G)
        from .msa.sets import Subset
        from .msa.refine import refine_msa
        msa = io.records_to_msa(records, molc)
        ss = Subset.from_string(msa.many, args.G)
        mtx, _ = scoring.build_matrix(molc, params)
        res = refine_msa(msa, mtx, u=params.u, v=params.v, sh=params.sh,
                         maxitr=args.S, randseed=args.R, nbatch=args.r,
                         spb=params.spb, subset=ss, device=device)
        msa = res.msa
    elif hosts_present:
        from .pipeline import update_msa
        groups = [io.records_to_msa(recs, molc) for recs in per_file]
        if args.readgap:
            gl = io.read_gaps_list(args.readgap)
            k = 0
            regrouped = []
            for g in groups:
                regrouped.append(io.apply_gaps_list(g, gl[k:k + g.many]))
                k += g.many
            groups = regrouped
        msa = update_msa(groups, params=params, molc=molc, maxitr=args.S,
                         randseed=args.R, refine=args.U, nbatch=args.r,
                         divmode=divmode, device=device)
    elif args.e and len(records) >= 16:
        from .pipeline import build_msa_denovo_large
        msa = build_msa_denovo_large(records, params, molc, maxitr=args.S,
                                     randseed=args.R, refine=args.I > 0,
                                     nbatch=args.r, divmode=divmode,
                                     dump_prefix=args.e, device=device)
    else:
        msa = build_msa(records, params=params, molc=molc, maxitr=args.S,
                        randseed=args.R, refine=args.I > 0,
                        local_thr=args.YH, nbatch=args.r, divmode=divmode,
                        device=device)
    if args.ckpt:
        save_checkpoint(args.ckpt, msa, args.R, args.S)
    runstat.stamp(1)
    if args.prntgap:
        io.write_gaps_list(msa, args.prntgap)
    _emit(msa, args)
    runstat.conclude()
    return 0


def _aln_catalog(args, device) -> int:
    """Catalog input modes (CalcServer IM_*, calcserv.h:619-641):
    pair generation over the flat sequence list."""
    mode = args.imode
    files = list(args.inputs)
    if ":" in mode:
        mode, cat = mode.split(":", 1)
        files += [ln.strip() for ln in Path(cat).read_text().splitlines()
                  if ln.strip() and not ln.startswith("#")]
    mode = (mode or "s").lower()
    recs = [r for f in files for r in io.sniff_and_read(f)]
    nn = len(recs)
    if mode == "a" or mode == "j":
        pairs = [(i, i + 1) for i in range(0, nn - 1, 2)]
    elif mode == "e":
        pairs = [(i, j) for j in range(1, nn) for i in range(j)]
    elif mode == "f":
        pairs = [(0, k) for k in range(1, nn)]
    elif mode == "l":
        pairs = [(k, nn - 1) for k in range(nn - 1)]
    elif mode == "p":
        half = nn // 2
        pairs = [(k, half + k) for k in range(half)]
    elif mode == "i":
        pairs = [(k, k) for k in range(nn)]
    else:
        pairs = [(i, i + 1) for i in range(0, nn - 1, 2)]
    molc = ab.infer_molc(recs[0].seq)
    params = default_params(molc, "aln")
    mtx, _ = scoring.build_matrix(molc, params)
    out = []
    for i, j in pairs:
        A = io.records_to_msa([recs[i]], molc)
        B = io.records_to_msa([recs[j]], molc)
        A.prepare(mtx.shape[0])
        B.prepare(mtx.shape[0])
        score, skl, swapped = align_pair(A, B, mtx, u=params.u,
                                         v=params.v, sh=params.sh,
                                         device=device)
        if swapped:
            A, B = B, A
        m = merge_msas(A, B, skl)
        out.append(f"! {recs[i].name} x {recs[j].name}  "
                   f"score = {score:.1f}")
        out.append(io.write_native_block(m).rstrip("\n"))
    _write("\n".join(out) + "\n", args.o)
    return 0


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
    if argv is None:
        argv = sys.argv[1:]
    p = argparse.ArgumentParser(
        prog="aln",
        description="pairwise, group-to-group and spliced alignment "
                    "(PyTorch and CUDA port)")
    p.add_argument("inputs", nargs="*", help="sequence/MSA files "
                   "(two, unless -a/-b/-i)")
    p.add_argument("-a", action="store_true",
                   help="progressive pileup MSA in input order "
                        "(aln.cc:489-568 MakeMsa)")
    p.add_argument("-b", default=None, metavar="TREE",
                   help="progressive MSA along a Newick guide tree "
                        "whose leaves name sequence files")
    p.add_argument("-i", dest="imode", default=None, metavar="MODE",
                   help="catalog input mode over the sequence list "
                        "(calcserv.h:619-641): a=adjacent pairs, "
                        "e=every pair, f=first vs others, l=others vs "
                        "last, p=parallel two halves, i=self; append "
                        "':file' to read the file list from a catalog")
    p.add_argument("-u", type=float, default=None, help="gap extension")
    p.add_argument("-v", type=float, default=None, help="gap open")
    p.add_argument("-w", type=int, default=None, help="band shoulder")
    p.add_argument("-F", choices=["native", "fasta", "clustal"],
                   default="native", help="output format")
    p.add_argument("-o", default=None, help="output file")
    p.add_argument("-yp", type=int, default=None, help="PAM level")
    p.add_argument("-R", type=int, default=0, metavar="N",
                   help="shuffle significance test with N jumbles")
    p.add_argument("-G", action="store_true",
                   help="spliced alignment: first input is genomic DNA")
    p.add_argument("-s", dest="srcdir", default=None, metavar="DIR",
                   help="directory containing the input files "
                        "(reference -s, iolib setdfn)")
    p.add_argument("-pi", action="store_true", dest="pi",
                   help="color intron positions (ANSI; reference -pi)")
    p.add_argument("-ph", action="store_true", dest="ph",
                   help="color intron positions as HTML (reference -ph)")
    p.add_argument("-yl", type=int, default=None,
                   help="2/3: spliced (gene-prediction) alignment "
                        "(reference -yl2/-yl3; implies -G)")
    p.add_argument("-O", type=int, default=1,
                   help="output mode (with -G: 0 gff3, 1 alignment, "
                        "2 gff3 match, 3 bed, 4 exons, 5 introns)")
    p.add_argument("-M", action="store_true",
                   help="search both strands (DNA; reference aln -M)")
    p.add_argument("-L", nargs="?", const="s", default=None,
                   help="local alignment mode ('s' = SWG colonies)")
    p.add_argument("-C", dest="ncolony", type=int, default=1,
                   help="with -Ls: max local alignments (reference -M#)")
    p.add_argument("-yJ", type=float, default=None,
                   help="intron-position match bonus (default 20)")
    p.add_argument("-T", default=None, metavar="SPECIES",
                   help="species parameter tables under $ALN_TAB")
    p.add_argument("-m", default=None, metavar="MATRIX",
                   help="named amino-acid exchange matrix file "
                        "(e.g. vtml200, blosum62; searched in $ALN_TAB; "
                        "reference -mS)")
    _add_sshp_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device of the DP kernels (default cuda)")
    args = p.parse_args(_aln_argv(argv))
    device = _device(args.device)
    args.inputs = _resolve_inputs(args.inputs, args.srcdir)
    _apply_sshp(args)

    if args.b:
        # progressive MSA along a user tree (aln -b, no refinement)
        from .pipeline import build_msa_guided
        msa = build_msa_guided(args.b, refine=False, device=device)
        _out(msa, args.F, args.o)
        return 0

    if args.a:
        # pileup: progressive merge in input order (aln -a); internal
        # nodes of the caterpillar tree are built with align_pair
        recs = [r for f in args.inputs for r in io.sniff_and_read(f)]
        if len(recs) < 2:
            print("need at least two sequences", file=sys.stderr)
            return 1
        molc = ab.infer_molc(recs[0].seq)
        params = default_params(molc, "aln")
        mtx, _ = scoring.build_matrix(molc, params)
        msa = io.records_to_msa([recs[0]], molc)
        for r in recs[1:]:
            nxt = io.records_to_msa([r], molc)
            msa.prepare(mtx.shape[0])
            nxt.prepare(mtx.shape[0])
            _, skl, swapped = align_pair(msa, nxt, mtx, u=params.u,
                                         v=params.v, sh=params.sh,
                                         device=device)
            A, B = (nxt, msa) if swapped else (msa, nxt)
            msa = merge_msas(A, B, skl)
        _out(msa, args.F, args.o)
        return 0

    if args.imode:
        return _aln_catalog(args, device)

    if len(args.inputs) != 2:
        print("aln needs exactly two inputs (or -a/-b/-i)",
              file=sys.stderr)
        return 1

    if args.L == "s":
        from .msa.local import swg_align, local_alignment_text
        ra = io.sniff_and_read(args.inputs[0])[0]
        rb = io.sniff_and_read(args.inputs[1])[0]
        molc = ab.infer_molc(ra.seq)
        prm = default_params(molc, "aln")
        mtx, _ = scoring.build_matrix(molc, prm)
        sa, sb = ra.seq.upper(), rb.seq.upper()
        res = swg_align(ab.encode(sa, molc), ab.encode(sb, molc), mtx,
                        u=args.u or prm.u, v=args.v or prm.v,
                        sh=args.w if args.w is not None else -50,
                        mlt=1 if args.ncolony <= 1 else 2)
        text = "".join(
            local_alignment_text(sa, sb, (ra.name, rb.name), scr, skl,
                                 molc=molc, u=args.u or prm.u,
                                 v=args.v or prm.v)
            for _, scr, skl in res[: max(1, args.ncolony)])
        sys.stdout.write(text)
        return 0

    if args.G or args.yl in (2, 3):
        return _aln_spliced(args, device)

    groups = []
    for f in args.inputs:
        recs = io.sniff_and_read(f)
        molc = ab.infer_molc(recs[0].seq)
        groups.append(io.records_to_msa(recs, molc))
    A, B = groups
    params = default_params(A.molc, "aln")
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
    if args.m and A.molc == ab.PROTEIN:
        mtx = scoring.read_matrix_file(args.m)
    else:
        mtx, _ = scoring.build_matrix(A.molc, params)
    if args.R > 0 and A.many == 1 and B.many == 1:
        from .msa.shuffle import shuffle_test
        r = shuffle_test(A.codes[0].astype(np.int32),
                         B.codes[0].astype(np.int32), mtx,
                         u=params.u, v=params.v, sh=params.sh,
                         njumble=args.R, device=device)
        print(f"Dev = {r['dev']:6.2f}  AV = {r['mean']:7.2f}  "
              f"SD = {r['sd']:7.2f}   ({r['njumble']} jumbles)")
    score, skl, swapped = align_pair(A, B, mtx, u=params.u, v=params.v,
                                     sh=params.sh, device=device)
    strand = "+"
    if args.M and A.molc == ab.DNA:
        # both-strand search (reference aln.cc:336-356): also try the
        # reverse complement of the second input, keep the better
        from .utils.seqtools import reverse_complement
        from .msa.msa import Msa
        # fresh container: derived profile caches must not be reused
        Brv = Msa(codes=np.stack(
            [reverse_complement(B.codes[i]) for i in range(B.many)]),
            molc=B.molc, names=list(B.names), weight=B.weight)
        scr2, skl2, swp2 = align_pair(A, Brv, mtx, u=params.u,
                                      v=params.v, sh=params.sh,
                                      device=device)
        if scr2 > score:
            score, skl, swapped, B, strand = scr2, skl2, swp2, Brv, "-"
    if swapped:
        A, B = B, A
    merged = merge_msas(A, B, skl)
    print(f"; Score = {score:.1f}"
          + (f" (strand {strand})" if args.M else ""), file=sys.stderr)
    if args.F not in ("fasta", "clustal"):
        _write(_group_pair_text(A, B, merged, score, params), args.o)
    else:
        _out(merged, args.F, args.o)
    return 0


def _group_pair_text(A, B, merged, score: float, params) -> str:
    """``aln``'s output of a pair or group merge: the reference's
    group-pair framing (sqpr.cc:1133-1196 print2), a 3-slot header,
    matrix params, FSTAT Score line, ALIGNMENT."""
    from .msa.merge import group_pair_fstat
    fst = group_pair_fstat(merged.codes, A.many, ab.GAP)
    tscr = score / fst["vab"]
    denom = fst["mch"] + fst["mmc"] + fst["unp"]
    pct = 100.0 * fst["mch"] / denom if denom else 0.0
    hdr = [
        "",
        f">{A.names[0]} [{A.many}:{A.length}]  ( 1 - {A.length} )"
        f" - >{B.names[0]} [{B.many}:{B.length}]"
        f"  ( 1 - {B.length} ) - > [0:0]  ( 1 - 0 )",
        "PAM = %d, BIAS = 0.0, u = %.1f, v = %.1f"
        % (params.pam, params.u, params.v),
        "Score = %5.1f (%5.1f), %.1f (=), %.1f (#), %.1f (g), "
        "%.1f (u), (%5.2f %%)"
        % (score, tscr, fst["mch"], fst["mmc"], fst["gap"],
           fst["unp"], pct),
    ]
    if merged.eij is not None:
        # merged intron-position block sits between the Score and
        # ALIGNMENT lines (put_SigII via print2)
        hdr += io._sigii_lines(merged)
    hdr.append("ALIGNMENT   1 / 1")
    return io.write_native_block(merged, header_lines=hdr, trailer="\n\n",
                                 csym_min=2)


def _aln_spliced(args, device) -> int:
    """``aln -G|-yl2|-yl3 <genome> <query>`` on ``device``: a protein or
    an aligned protein MSA is gene prediction by the fwd2h DP; a DNA
    query (cDNA or EST) is spliced alignment by the fwd2s DP, one
    alignment a query record."""
    grecs = io.sniff_and_read(args.inputs[0])
    qrecs = io.sniff_and_read(args.inputs[1])
    mode = args.O & 7 if args.O < 16 else args.O
    sh = args.w if args.w is not None else -50
    out = []
    if ab.infer_molc(qrecs[0].seq) != ab.PROTEIN:
        from .splice.api import spliced_align
        for q in qrecs:
            res = spliced_align(grecs[0].seq, q.seq, gname=grecs[0].name,
                                qname=q.name, sh=sh, u=args.u, v=args.v,
                                species=args.T, device=device)
            out.append(res.render(mode))
        _write("".join(out), args.o)
        return 0
    from .splice.hapi import spliced_align_h
    common = dict(gname=grecs[0].name, sh=sh, u=args.u, v=args.v,
                  pam=args.yp, yj=args.yJ, species=args.T, device=device)
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
    _write("".join(out), args.o)
    return 0


def refgs_main(argv=None) -> int:
    """Concerted gene-structure refinement (reference perl/refgs.pl):
    re-predict each member's structure against the profile of the
    others, rebuild the MSA, iterate.  The JAX package's ``refgs`` flags
    plus ``--device``."""
    if argv is None:
        argv = sys.argv[1:]
    p = argparse.ArgumentParser(
        prog="refgs",
        description="iterative gene-structure refinement "
                    "(refgs.pl L6 pipeline)")
    p.add_argument("msa", help="gene-structure-annotated multi-FASTA / "
                               "MSA of the family")
    p.add_argument("-n", dest="genome", required=True,
                   help="genomic sequence file (members are windowed "
                        "by their ;C coordinates when they fit)")
    p.add_argument("-I", type=int, default=1, help="max iterations")
    p.add_argument("-m", action="append", default=None,
                   help="restrict refinement to these members "
                        "(repeatable; default all)")
    p.add_argument("-T", dest="species", default=None,
                   help="species parameter/table directory")
    p.add_argument("-yJ", type=float, default=None,
                   help="intron-position match bonus")
    p.add_argument("-t", dest="out", default=None,
                   help="write the refined extended FASTA here "
                        "(default stdout)")
    p.add_argument("-pq", action="store_true", help="quiet")
    p.add_argument("--device", default="cuda",
                   help="torch device of the DP kernels (default cuda)")
    args = p.parse_args(argv)
    device = _device(args.device)

    from .refgs import refgs_family
    recs = io.sniff_and_read(args.msa)
    grec = io.sniff_and_read(args.genome)[0]
    genome = grec.seq.upper().replace("-", "")
    allow = set(args.m) if args.m else None

    def genome_of(name):
        if allow is not None and name not in allow:
            return None
        return genome, 0

    res = refgs_family(recs, genome_of, iters=args.I,
                       species=args.species, yj=args.yJ,
                       quiet=args.pq, device=device)
    lines = []
    for r in res.records:
        lines.append(f">{r.name}")
        if r.exons:
            parts = ",".join(f"{a}..{b}" for a, b in r.exons)
            lines.append(f";C join({parts})")
        s = r.seq.replace("-", "")
        lines.extend(s[i:i + 60] for i in range(0, len(s), 60))
    text = "\n".join(lines) + "\n"
    if args.out:
        Path(args.out).write_text(text)
    else:
        sys.stdout.write(text)
    for name, st_ in res.status.items():
        print(f"{name}\t{st_}", file=sys.stderr)
    if res.outliers:
        print("outliers: " + " ".join(res.outliers), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(prrn_main())
