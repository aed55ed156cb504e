"""The comparison that decides ``correct``.

The program's answer for a family is the alignment that ``prrn`` writes
(native block format).  ``read_native`` reads it back as (name, aligned
row) in output order; ``rows_differ`` counts the rows that differ from
the plain reference's, by name, row text or position in the output
order (the order is the guide tree's).  Exact: the limit is 0.
"""

from __future__ import annotations

import re

_ROW = re.compile(r"^ *\d+ (.*)\| (\S+)$")


def read_native(text: str) -> list[tuple[str, str]]:
    """(name, aligned row) of every member, in output order, from a
    native block alignment (60 columns a block, member lines
    ``<start> <columns>| <name>``; the consensus line has no trailer)."""
    rows: dict[str, list[str]] = {}
    for line in text.splitlines():
        m = _ROW.match(line)
        if m:
            rows.setdefault(m.group(2), []).append(m.group(1).rstrip(" "))
    return [(name, "".join(parts)) for name, parts in rows.items()]


def rows_differ(got: list[tuple[str, str]],
                want: list[tuple[str, str]]) -> int:
    """Rows of ``want`` that ``got`` does not hold at the same position
    with the same name and text (a missing or extra row counts)."""
    bad = sum(g != w for g, w in zip(got, want))
    return bad + abs(len(got) - len(want))
