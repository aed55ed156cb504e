"""Seeded sequence families, the benchmark's traffic.

A configuration names its family generator, ``generators/<name>.py``,
whose ``make(rng, n, length, prm)`` draws one family of ``n`` sequences
about an ancestor of ``length`` residues, with the configuration's
``family`` parameters.  A workload names a pool of shapes (sequences,
ancestor length); family k of a pool comes from its own stream of the
seed it is made from, so that any one can be made again alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from harness import load

AMINO = "ARNDCQEGHILKMFPSTWYV"
# Robinson & Robinson (1991) background frequencies, in AMINO's order
AMINO_FREQ = np.array([0.07805, 0.05129, 0.04487, 0.05364, 0.01925,
                       0.04264, 0.06295, 0.07377, 0.02199, 0.05142,
                       0.09019, 0.05744, 0.02243, 0.03856, 0.05203,
                       0.07120, 0.05841, 0.01330, 0.03216, 0.06441])
AMINO_FREQ = AMINO_FREQ / AMINO_FREQ.sum()


@dataclass
class Family:
    names: list[str]
    seqs: list[str]
    identity: float | None = None     # mean pairwise, true alignment

    @property
    def residues(self) -> int:
        return sum(len(s) for s in self.seqs)

    def fasta(self) -> str:
        return "".join(f">{n}\n" + "\n".join(s[i:i + 60]
                                             for i in range(0, len(s), 60))
                       + "\n" for n, s in zip(self.names, self.seqs))


def pool(seed: list[int], config: dict, shapes: list) -> list[Family]:
    """One family of each of ``shapes`` (sequences, ancestor length),
    family k drawn from the stream ``[*seed, k]``."""
    make = load("generators", config["generator"]).make
    return [make(np.random.default_rng([*seed, k]), n, length,
                 config["family"])
            for k, (n, length) in enumerate(shapes)]
