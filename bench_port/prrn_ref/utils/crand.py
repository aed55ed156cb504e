"""glibc-compatible rand()/srand() and the reference's mixed-congruential
partition-order generator.

The reference seeds its randomized refinement from C ``rand()`` (glibc
TYPE_3 additive-feedback generator) and then iterates a mixed-congruential
sequence (reference: src/randiv.cc:34-53 McRand).  Reproducing the default
``-R1`` partition visit order bit-for-bit requires the same PRNG.
"""

from __future__ import annotations

M31 = 2147483647
U32 = 1 << 32


class GlibcRand:
    """glibc rand() (TYPE_3 / additive feedback, the default)."""

    def __init__(self, seed: int = 1):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed = seed % U32
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2^31-1 via Schrage to mirror glibc
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += M31
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) % U32
        self._r = r
        self._idx = 344

    def rand(self) -> int:
        r = self._r
        i = self._idx
        val = (r[i - 31] + r[i - 3]) % U32
        r.append(val)
        self._idx += 1
        return val >> 1


class McRand:
    """Mixed congruence sequence over [0, 2^p) (randiv.cc:34-53)."""

    def __init__(self, p: int, rn: int, crand: GlibcRand):
        if rn == 0:
            self.mrand = False
            self.mcoef = 1
            seed_val = 0
        else:
            self.mrand = True
            seed_val = crand.rand() if rn == 1 else rn
            crand.srand(seed_val)
        self.mcmod = 1 << p
        if self.mrand:
            self.mcoef = (crand.rand() // 4 * 4 + 5) % self.mcmod
            self.mcval = seed_val % self.mcmod
        else:
            self.mcval = self.mcmod - 1

    def mcrand(self) -> int:
        self.mcval = (self.mcoef * self.mcval + 1) % self.mcmod
        return self.mcval

    def mcrand_now(self) -> int:
        return self.mcval
