"""Member grouping (``-G``): partition of MSA members into units.

Reference: ``Subset`` (src/sets.h:27-45, src/sets.cc:24-106) parsed
from the ``-G`` option string (prrn5.cc:156-159) or a file.  Grammar
(sgetiarray, src/iolib.cc:664-700): groups separated by ``/``; within a
group, 1-based member indices and inclusive ``a-b`` ranges; a trailing
``a-b/`` (range immediately followed by ``/``) expands into singleton
groups; members not mentioned are appended as singletons so the subset
always covers all ``n`` members.
"""

from __future__ import annotations

import re
from pathlib import Path


class Subset:
    """groups: list of 0-based member-index lists covering 0..n-1."""

    def __init__(self, n: int, groups: list[list[int]]):
        seen: set[int] = set()
        out: list[list[int]] = []
        for g in groups:
            gg: list[int] = []
            for m in g:
                if 0 <= m < n and m not in seen:
                    seen.add(m)
                    gg.append(m)
            if gg:
                out.append(gg)
        for m in range(n):
            if m not in seen:
                out.append([m])
        self.groups = out
        self.num = len(out)
        self.elms = n

    @classmethod
    def from_string(cls, n: int, text: str) -> "Subset":
        if text and Path(text).is_file():
            text = Path(text).read_text()
        # "a-/b" expands to singleton groups a..b (the NEG arm of
        # sgetiarray, iolib.cc:683-695: '-' still pending when '/' hits)
        text = re.sub(
            r"(\d+)-\s*/\s*(\d+)",
            lambda m: "/".join(str(k) for k in
                               range(int(m.group(1)),
                                     int(m.group(2)) + 1)),
            text.strip())
        groups: list[list[int]] = []
        for part in re.split(r"[/\n;]+", text):
            part = part.strip()
            if not part:
                continue
            g: list[int] = []
            for tok in re.split(r"[,\s]+", part):
                if not tok:
                    continue
                m = re.fullmatch(r"(\d+)-(\d+)", tok)
                if m:
                    g += list(range(int(m.group(1)) - 1, int(m.group(2))))
                elif tok.isdigit():
                    g.append(int(tok) - 1)
            if g:
                groups.append(g)
        return cls(n, groups)

    def member_to_group(self) -> list[int]:
        m2g = [0] * self.elms
        for gi, g in enumerate(self.groups):
            for m in g:
                m2g[m] = gi
        return m2g
