"""Command-line entry points ``prrn`` (MSA) and ``aln`` (pairwise, group
and spliced alignment) of the port.

Counterparts of ``prrn_aln_tpu/cli.py::prrn_main`` and ``aln_main``:
the same flags and the same output bytes.  The port adds ``--device``
(default ``cuda``); a CUDA device that is absent is an error, never a
switch to the CPU.  ``refgs_main`` is the counterpart of the JAX
package's ``refgs`` (concerted gene-structure refinement), and
``phyln_main``, ``makmdm_main``, ``makdbs_main``, ``decomp_main``,
``iden_main``, ``rdn_main``, ``utn_main`` and ``utp_main`` of its utility
programs; of these only ``phyln`` launches a kernel (K1), so only it
takes ``--device``.
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
from .ops.frontier import maybe_init_distributed
from .pipeline import build_msa
from .utils import trace
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
    if fmt == "native":
        text = io.write_native_block(msa, markeij=markeij)
    else:
        text = {"fasta": io.write_fasta, "clustal": io.write_clustal,
                "phylip": io.write_phylip, "msf": io.write_msf,
                "gde": io.write_gde, "nexus": io.write_nexus}[fmt](msa)
    _write(text, path)


def _emit(msa, args):
    """prrn output modes (Msa::output, prrn5.cc:1738-1806)."""
    with trace.span("prrn.write"):
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
    with trace.request("prrn.main"):
        return _prrn(argv)


def _prrn(argv) -> int:
    maybe_init_distributed()   # a gloo group when the environment asks
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
    maybe_init_distributed()   # a gloo group when the environment asks
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



def phyln_main(argv=None) -> int:
    """Guide-tree utility: the reference's phyln/upg/nj family, plus
    ``--device`` for the distance pass (K1)."""
    p = argparse.ArgumentParser(
        prog="phyln", description="print a UPGMA or NJ tree (Newick)")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-m", choices=["upgma", "nj"], default="upgma")
    p.add_argument("-k", action="store_true",
                   help="use in-MSA divergence (input is an alignment)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the DP kernels (default cuda)")
    args = p.parse_args(argv)
    device = _device(args.device)

    from .msa import distance as dmod, tree as tmod

    records = []
    for f in args.inputs:
        records += io.sniff_and_read(f)
    molc = ab.infer_molc(records[0].seq)
    names = [r.name for r in records]
    if args.k:
        m = io.records_to_msa(records, molc)
        d = dmod.msa_distance_matrix(m.codes)
    else:
        params = default_params(molc, "prrn")
        mtx, _ = scoring.build_matrix(molc, params)
        seqs = [ab.encode(r.seq.replace("-", ""), molc) for r in records]
        d = dmod.distance_matrix(seqs, mtx, u=params.u, v=params.v,
                                 sh=params.sh, device=device)
    n = len(records)
    t = (tmod.neighbor_joining(d, n) if args.m == "nj"
         else tmod.upgma(d, n))
    print(tmod.to_newick(t, names))
    return 0


def makmdm_main(argv=None) -> int:
    """Write mutation-data (PAM) matrix tables (reference makmdm.cc).

    Emits the integer score table for the requested PAM level in the
    reference's space-separated layout, derivable for any level from
    the bundled mdm eigendecomposition series."""
    p = argparse.ArgumentParser(
        prog="makmdm", description="generate mutation data matrix")
    p.add_argument("pam", type=int, nargs="+", help="PAM level(s)")
    p.add_argument("-d", dest="outdir", default=".")
    args = p.parse_args(argv)
    for pam in args.pam:
        prm = dataclasses.replace(default_params(ab.PROTEIN, "aln"),
                                  pam=pam)
        mtx, meta = scoring.protein_matrix(prm)
        dim = mtx.shape[0]
        lines = [f"# mdm{pam} nrmlf={meta['nrmlf']:g} avtrc={meta['avtrc']:g}"]
        for i in range(dim):
            lines.append(" ".join(f"{mtx[i, j]:7.2f}"
                                  for j in range(dim)))
        out = Path(args.outdir) / f"mdm{pam}"
        out.write_text("\n".join(lines) + "\n")
        print(f"wrote {out}")
    return 0


def makdbs_main(argv=None) -> int:
    """Build a formatted sequence database (reference makdbs.cc; the
    SeqDB .psq/.pix/.pnm layout of native/seqlib.cpp)."""
    p = argparse.ArgumentParser(
        prog="makdbs", description="build formatted sequence DB")
    p.add_argument("input")
    p.add_argument("-b", dest="base", default=None,
                   help="output base path (default: input stem)")
    args = p.parse_args(argv)
    from . import native
    recs = io.sniff_and_read(args.input)
    molc = ab.infer_molc(recs[0].seq)
    base = args.base or str(Path(args.input).with_suffix(""))
    seqs = [ab.encode(r.seq, molc) for r in recs]
    names = [r.name for r in recs]
    native.SeqDB.build(base, seqs, names)
    print(f"{len(seqs)} entries -> {base}.psq/.pix/.pnm")
    return 0


def decomp_main(argv=None) -> int:
    """Split a bundled flat DB file into per-entry files (reference
    decomp.cc): filename = last '|'-separated field of the id token,
    restricted to [alnum._]; optional date filter for GenBank entries."""
    import datetime
    import re

    p = argparse.ArgumentParser(
        prog="decomp", description="decompose a flat DB file")
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("-p", dest="path", default=".", help="output path")
    p.add_argument("-n", dest="date", default=None,
                   help='keep entries dated on/after "Day-MON-Year"')
    p.add_argument("-f", dest="field", type=int, default=0,
                   help="id field number (whitespace separated)")
    p.add_argument("-q", action="store_true", help="quiet")
    args = p.parse_args(argv)

    text = (sys.stdin.read() if args.input == "-"
            else Path(args.input).read_text())
    lines = text.splitlines(keepends=True)
    given = None
    if args.date:
        given = datetime.datetime.strptime(args.date, "%d-%b-%Y")

    def emit(entry_lines, idline):
        toks = idline.split()
        if args.field < len(toks):
            tok = toks[args.field]
        else:
            return
        parts = tok.split("|")
        name = re.sub(r"[^A-Za-z0-9._]", "", parts[-1] or
                      (parts[-2] if len(parts) > 1 else tok))
        if not name:
            return
        out = Path(args.path) / name
        out.write_text("".join(entry_lines))
        if not args.q:
            print(f"{name}: {idline}")

    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(">"):                 # FASTA entry
            j = i + 1
            while j < len(lines) and not lines[j].startswith(">"):
                j += 1
            emit(lines[i:j], line[1:].rstrip("\n"))
            i = j
        elif line.startswith(("LOCUS", "ID")):   # GenBank / EMBL
            j = i + 1
            while j < len(lines) and not lines[j].startswith("//"):
                j += 1
            if j < len(lines):
                j += 1
            keep = True
            if given is not None and line.startswith("LOCUS"):
                try:
                    d = datetime.datetime.strptime(
                        line[62:].split()[0], "%d-%b-%Y")
                    keep = d >= given
                except (ValueError, IndexError):
                    keep = False
            if keep:
                emit(lines[i:j], line.split(None, 1)[1].rstrip("\n")
                     if len(line.split()) > 1 else "")
            i = j
        else:
            i += 1
    return 0


def iden_main(argv=None) -> int:
    """Detect differences between two closely related sequences
    (reference iden.cc: banded min-cost alignment, u=v=1, sh=2; prints
    only the 60-column blocks containing a difference)."""
    p = argparse.ArgumentParser(
        prog="iden", description="differences between similar sequences")
    p.add_argument("inputs", nargs=2)
    p.add_argument("-u", type=float, default=1.0)
    p.add_argument("-v", type=float, default=1.0)
    p.add_argument("-w", type=int, default=2, help="band shoulder")
    p.add_argument("-t", type=float, default=1.0,
                   help="distance threshold %% (alprm.thr)")
    p.add_argument("-O", type=int, default=1,
                   help="0: score only; 1: difference blocks")
    args = p.parse_args(argv)

    from .ops.iden_np import iden_align, path_stats, alignment_columns
    recs = [io.sniff_and_read(f)[0] for f in args.inputs]
    molc = ab.infer_molc(recs[0].seq)
    sa = recs[0].seq.upper()
    sb = recs[1].seq.upper()
    ca = ab.encode(sa, molc)
    cb = ab.encode(sb, molc)
    cut = int((len(ca) + len(cb)) * args.t / 100)
    if args.O == 0:
        dist, _ = iden_align(ca, cb, u=args.u, v=args.v, sh=args.w)
        if dist < cut:
            print(f"{recs[0].name:<12} {recs[1].name:<12} {int(dist):3d}")
        return 0
    dist, skl = iden_align(ca, cb, u=args.u, v=args.v, sh=args.w)
    mch, mmc, runs, unp = path_stats(ca, cb, skl)
    span = mch + mmc + unp
    if not span:
        return 0
    rowa, rowb = alignment_columns(sa, sb, skl)
    out = ["", f">{recs[0].name} [1:{len(sa)}]  ( 1 - {len(sa)} ) - "
               f">{recs[1].name} [1:{len(sb)}]  ( 1 - {len(sb)} )"]
    pct = 100.0 * mch / span
    out.append("Dist = %4d, Cons = %3d, Repl = %3d,  Gaps = %2d, "
               "Unpairs = %3d, (%6.2f %%)" % (int(dist), mch, mmc,
                                              runs, unp, pct))
    lpw = 60
    na = nb = 0
    for z in range(0, len(rowa), lpw):
        sega = rowa[z: z + lpw]
        segb = rowb[z: z + lpw]
        ra = sum(1 for c in sega if c != "-")
        rb = sum(1 for c in segb if c != "-")
        if any(x != y for x, y in zip(sega, segb)):
            out.append("")
            for seg, n0, n1 in ((sega, na, na + ra), (segb, nb, nb + rb)):
                if n1 > n0:
                    out.append("%8d  %s%6d" % (n0 + 1, seg.ljust(lpw), n1))
                else:
                    out.append(" " * 10 + seg.ljust(lpw))
                if seg is sega:
                    ind = "".join("*" if x != y else " "
                                  for x, y in zip(sega.ljust(lpw),
                                                  segb.ljust(lpw)))
                    out.append(" " * 10 + ind)
        na += ra
        nb += rb
    sys.stdout.write("\n".join(out) + "\n\n")
    return 0


def rdn_main(argv=None) -> int:
    """MSA editing utility (reference rdn)."""
    p = argparse.ArgumentParser(prog="rdn", description="MSA row/column "
                                "editing (extract, dedup, degap, justify)")
    p.add_argument("input")
    p.add_argument("-e", default=None, metavar="IDX",
                   help="extract 1-based member indices, comma separated")
    p.add_argument("-d", action="store_true", help="remove duplicates")
    p.add_argument("-c", action="store_true", help="delete common gaps")
    p.add_argument("-j", choices=["l", "r"], default=None, help="justify")
    p.add_argument("-F", choices=["native", "fasta", "clustal", "phylip",
                                  "msf", "gde", "nexus"], default="fasta")
    p.add_argument("-o", default=None)
    args = p.parse_args(argv)

    from .utils import seqtools as st
    recs = io.sniff_and_read(args.input)
    msa = io.records_to_msa(recs)
    if args.e:
        keep = [int(x) - 1 for x in args.e.split(",")]
        msa = st.extract_members(msa, keep)
    if args.d:
        msa = st.remove_duplicates(msa)
    if args.j:
        msa = st.justify(msa, left=args.j == "l")
    if args.c:
        msa = st.delete_common_gaps(msa)
    _out(msa, args.F, args.o)
    return 0


def utn_main(argv=None) -> int:
    """Nucleotide utility (reference utn): composition, translation,
    ORFs, reverse complement."""
    p = argparse.ArgumentParser(prog="utn")
    p.add_argument("input")
    p.add_argument("-c", action="store_true", help="composition")
    p.add_argument("-t", type=int, default=None, metavar="FRAME",
                   help="translate in frame 0/1/2")
    p.add_argument("-O", action="store_true", help="find ORFs")
    p.add_argument("-r", action="store_true", help="reverse complement")
    p.add_argument("-z", default=None, metavar="ENZ|all[,max[,min]]",
                   help="restriction sites (reference utn resezm/allezm; "
                        "table: renzyme)")
    p.add_argument("-fp", default=None, metavar="PATTERN",
                   help="find IUPAC pattern positions (reference -f)")
    args = p.parse_args(argv)

    from .utils import resite as rz
    from .utils import seqtools as st
    for rec in io.sniff_and_read(args.input):
        codes = ab.encode(rec.seq.replace("-", ""), ab.DNA)
        if args.z or args.fp:
            seq = rec.seq.replace("-", "").upper()
            if args.fp:
                locs = rz.pattern_positions(seq, args.fp)
                print(f"{rec.name}  ({args.fp})  {len(locs)}")
                if locs:
                    print(rz.format_loc(locs))
            if args.z and args.z.startswith("all"):
                parts = args.z.split(",")
                mx = int(parts[1]) if len(parts) > 1 else 2 ** 31 - 1
                mn = int(parts[2]) if len(parts) > 2 else (0 if mx == 0
                                                           else 1)
                for e, locs in rz.all_sites(seq, mn, mx):
                    print(f"{e.name:<10} {e.pattern:<10} {e.cut:2d}   "
                          f"{len(locs)}")
                    if locs:
                        print(rz.format_loc(locs))
            elif args.z:
                total = []
                for nm in args.z.split(","):
                    e = rz.find_enzyme(nm)
                    if e is None:
                        print(f"{nm} not found", file=sys.stderr)
                        continue
                    locs = rz.respos(seq, e)
                    print(f"{rec.name}  ({e.name:<10} {e.pattern:<10} "
                          f"{e.cut:2d} )  {len(locs)}")
                    total.extend(locs)
                if total:
                    print(rz.format_loc(sorted(total)))
        if args.c:
            comp = st.composition(codes, ab.DNA)
            total = sum(comp.values())
            print(rec.name, total,
                  " ".join(f"{k}:{v}" for k, v in sorted(comp.items())))
        if args.t is not None:
            print(f">{rec.name}_frame{args.t}")
            print(st.translate(codes, args.t))
        if args.O:
            for s, e, f in st.find_orfs(codes):
                print(f"{rec.name}\t{s}\t{e}\t{f}")
        if args.r:
            print(f">{rec.name}_rc")
            print(ab.decode(st.reverse_complement(codes), ab.DNA))
    return 0


def utp_main(argv=None) -> int:
    """Protein utility (reference utp): composition, PROSITE motifs."""
    p = argparse.ArgumentParser(prog="utp")
    p.add_argument("input")
    p.add_argument("-c", action="store_true", help="composition")
    p.add_argument("-m", default=None, metavar="PATTERN",
                   help="scan a PROSITE-syntax motif (reference prs.cc)")
    p.add_argument("-P", default=None, metavar="DAT",
                   help="scan every pattern of a prosite.dat file")
    args = p.parse_args(argv)

    from .utils import prosite as psm
    from .utils import seqtools as st
    pats = None
    if args.P:
        pats = [(pid, acc, psm.compile_pattern(pat))
                for pid, acc, pat in psm.parse_dat(args.P)]
    for rec in io.sniff_and_read(args.input):
        seq = rec.seq.replace("-", "")
        if args.m:
            for s, e in psm.scan(seq, args.m):
                print(f"{rec.name}\t{s + 1}\t{e}\t{seq[s:e]}")
        if pats is not None:
            for pid, acc, rx in pats:
                for s, e in psm.scan(seq, rx):
                    print(f"{rec.name}\t{pid}\t{acc}\t{s + 1}\t{e}\t"
                          f"{seq[s:e]}")
        if args.c or not (args.m or pats is not None):
            codes = ab.encode(seq, ab.PROTEIN)
            comp = st.composition(codes, ab.PROTEIN)
            total = sum(comp.values())
            print(rec.name, total,
                  " ".join(f"{k}:{v}" for k, v in sorted(comp.items())))
    return 0


if __name__ == "__main__":
    sys.exit(prrn_main())
