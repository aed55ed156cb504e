"""Phase-stamp tracing and refinement checkpointing.

``RunStat`` mirrors the reference's run statistics (prrn5.h:263-283,
prrn5.cc:218-240): ``stamp(val)`` records a wall-clock timestamp at a
phase boundary; ``conclude()`` writes tab-separated phase intervals and
the total to the ``-E`` destination.

``Checkpoint`` adds what the reference lacks (SURVEY §5.4): a
serializable (MSA, seed, iteration) refinement state so long runs can
resume.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

N_STAMP = 10


class RunStat:
    def __init__(self):
        self.fmessg = None
        self.values: list[int] = []
        self.timestamps: list[float] = []

    def reset(self):
        """Forget the stamps of an earlier run in this process."""
        self.values.clear()
        self.timestamps.clear()

    def setfmessg(self, dest: str | None):
        """'' or '-' = stderr; otherwise a file path."""
        if dest is None:
            self.fmessg = None
        elif dest in ("", "-"):
            self.fmessg = sys.stderr
        else:
            self.fmessg = open(dest, "w")

    def stamp(self, val: int = 0):
        if len(self.timestamps) < N_STAMP:
            self.values.append(val)
            self.timestamps.append(time.time())

    def conclude(self):
        if self.fmessg is None or not self.timestamps:
            return
        ts = self.timestamps
        for i in range(1, len(ts)):
            self.fmessg.write(f"{ts[i] - ts[i - 1]:.0f}\t")
        secs = ts[-1] - ts[0]
        self.fmessg.write(f"{secs:.0f} secs {secs / 60:.2f} mins\n")
        self.fmessg.flush()
        if self.fmessg is not sys.stderr:
            self.fmessg.close()
            self.fmessg = None


runstat = RunStat()


# ---------------------------------------------------------------------------
# refinement checkpoint (MSA codes + names + RNG state + iteration)

def save_checkpoint(path: str | Path, msa, randseed: int, iteration: int,
                    crand_state=None, extra: dict | None = None):
    meta = dict(names=list(msa.names), molc=int(msa.molc),
                randseed=int(randseed), iteration=int(iteration),
                tgapf=float(msa.tgapf),
                crand_state=(None if crand_state is None
                             else list(map(int, crand_state))),
                extra=extra or {})
    np.savez(path, codes=msa.codes,
             weight=(msa.weight if msa.weight is not None
                     else np.zeros(0)),
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))


def load_checkpoint(path: str | Path):
    from ..msa.msa import Msa
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    weight = z["weight"] if z["weight"].size else None
    msa = Msa(codes=z["codes"], molc=meta["molc"], names=meta["names"],
              weight=weight, tgapf=meta.get("tgapf", 1.0))
    return msa, meta
