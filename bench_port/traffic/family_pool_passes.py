"""``family_pool_passes``: a closed loop with one client, as a pipeline
that aligns family after family and waits for each.

The workload file (``workloads/<cell>.json``) holds:

* ``pool_seed``: the seed the pool is made from;
* ``pool``: the pool's shapes, ``[sequences, ancestor length]`` each, a
  family of each from the configuration's generator;
* ``checked``: how many of the window's families the check aligns
  again by the reference, drawn from the run's seed;
* ``fresh``: how many families drawn from the run's seed (of pool
  shapes drawn from it too) the program aligns after the window, through
  the same entry, for the check.

The configuration's ``entry`` names the program's entry point
(``"<module>:<function>"``), its arguments (``{out}`` and ``{fasta}``
stand for the output and input files) and its environment (set before
the program is imported).  The window hands the pool's families to the
entry in the pool's order, pass after pass, until ``--seconds`` have
passed, and lets the family in flight finish.  The pool is the same in
every run, so the window's work does not move with the seed: a family's
time follows its residues far more than its shape.  The seed draws the
families that the check compares: some of the window's and fresh ones,
so that every run checks families that no run before it saw.
"""

from __future__ import annotations

import collections
import importlib
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from harness import check, families as fam
from harness.reference import references

# the streams of the pool's seed: the window's pool, the warm-up family
# and the fresh families
POOL, WARM, FRESH = 2, 9, 4


@dataclass
class State:
    job: object
    made: list
    paths: list
    done: dict = field(default_factory=lambda: collections.defaultdict(list))
    failed: int = 0


def entry(job):
    """The configuration's entry point as ``call(fasta, out) -> rc``."""
    e = job.config["entry"]
    module, function = e["call"].split(":")
    fn = getattr(importlib.import_module(module), function)

    def call(fasta, out) -> int:
        try:
            return fn([a.format(fasta=fasta, out=out) for a in e["argv"]])
        except Exception:          # a failed family is counted
            traceback.print_exc()
            return -1
    return call


def prepare(job) -> State:
    """The pool's FASTA files under the run's directory, and one warm-up
    family of the pool's smallest shape (other residues, same path)."""
    tr = job.traffic
    made = fam.pool([tr["pool_seed"], POOL], job.config, tr["pool"])
    paths = []
    for k, f in enumerate(made):
        paths.append(job.tmp / f"f{k}.fa")
        paths[-1].write_text(f.fasta())
    smallest = min(tr["pool"], key=lambda s: s[0] * s[1])
    warm = fam.pool([tr["pool_seed"], WARM], job.config, [smallest])[0]
    (job.tmp / "warm.fa").write_text(warm.fasta())
    job.call = entry(job)
    if job.call(job.tmp / "warm.fa", job.tmp / "warm.out") != 0:
        raise RuntimeError("the warm-up family failed")
    return State(job, made, paths)


def window(st: State, seconds: float) -> dict:
    """The closed loop: the pool pass after pass until ``seconds``."""
    walls, residues = [], []
    attempted = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        idx = attempted % len(st.made)
        out = st.job.tmp / f"o{attempted}.txt"
        with st.job.request():
            ts = time.perf_counter()
            rc = st.job.call(st.paths[idx], out)
            te = time.perf_counter()
        attempted += 1
        if rc != 0 or not out.exists():
            st.failed += 1
        else:
            walls.append(te - ts)
            residues.append(st.made[idx].residues)
            st.done[idx].append(out)
    print("bench_port: family walls (pool index, s): " + " ".join(
        f"{k % len(st.made)}:{w:.3f}" for k, w in enumerate(walls)),
        file=sys.stderr)
    return {"attempted": attempted, "failed": st.failed, "walls": walls,
            "residues": residues}


def check_outputs(st: State, seed: int) -> dict:
    """Families of the window drawn from the seed, each at one of the
    times it was aligned, and fresh families of the seed aligned now,
    against the reference, row for row (limit 0)."""
    job, tr = st.job, st.job.traffic
    rng = np.random.default_rng([seed, 3])
    picks = sorted(rng.choice(sorted(st.done), min(tr["checked"],
                                                   len(st.done)),
                              replace=False).tolist()) if st.done else []
    fams, got = [], []
    for idx in picks:
        out = st.done[idx][int(rng.integers(len(st.done[idx])))]
        fams.append(st.made[idx])
        got.append(check.read_native(out.read_text()))
    shapes = np.random.default_rng([seed, 4]).choice(
        len(tr["pool"]), tr["fresh"]).tolist()
    fresh = fam.pool([tr["pool_seed"], FRESH, seed], job.config,
                     [tr["pool"][i] for i in shapes])
    fresh_failed = 0
    for k, f in enumerate(fresh):
        (job.tmp / f"fresh{k}.fa").write_text(f.fasta())
        out = job.tmp / f"fresh{k}.txt"
        if job.call(job.tmp / f"fresh{k}.fa", out) != 0 or not out.exists():
            fresh_failed += 1
            continue
        fams.append(f)
        got.append(check.read_native(out.read_text()))
    t_ref = time.perf_counter()
    want = references([(job.config["reference"], f.names, f.seqs, None)
                       for f in fams])
    print(f"bench_port: reference {time.perf_counter() - t_ref:.1f} s "
          f"({len(fams)} families: {len(picks)} of the window's, "
          f"{len(fams) - len(picks)} fresh)", file=sys.stderr)
    differ = sum(check.rows_differ(g, w) for g, w in zip(got, want))
    failed = st.failed + fresh_failed
    return {"correct": failed == 0 and differ == 0 and bool(picks),
            "checks": {"families_failed": {"value": failed, "limit": 0},
                       "rows_differ": {"value": differ, "limit": 0,
                                       "families_checked": len(fams)}}}

