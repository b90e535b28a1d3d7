"""The comparison that decides `correct`: the program's answer rows
against the reference's.

Keys, counts and integer sums compare exactly; a float answer compares by
its gap relative to the reference's value.  An answer whose rows differ
in number, keys, order (where the SQL orders) or an exact value is a
mismatched answer.
"""

from __future__ import annotations

import math


def compare(got: list[tuple], want: list[tuple], exact: list[bool],
            ordered: bool) -> tuple[bool, float]:
    """(mismatched, the widest relative gap of a float value)."""
    gap = 0.0
    if len(got) != len(want):
        return True, gap
    if not ordered:
        got = sorted(got, key=lambda r: _sort_key(r, exact))
        want = sorted(want, key=lambda r: _sort_key(r, exact))
    for g, w in zip(got, want):
        if len(g) != len(w):
            return True, gap
        for a, b, ex in zip(g, w, exact):
            if a is None or b is None:
                if (a is None) != (b is None):
                    return True, gap
                continue
            if ex:
                if a != b:
                    return True, gap
                continue
            a, b = float(a), float(b)
            if math.isnan(a) or math.isnan(b):
                if math.isnan(a) != math.isnan(b):
                    return True, gap
                continue
            gap = max(gap, abs(a - b) / max(abs(b), 1e-300))
    return False, gap


def _sort_key(row: tuple, exact: list[bool]):
    """Order rows by their exact values (the keys among them)."""
    return tuple((v is None, str(type(v)), v if v is not None else 0)
                 for v, ex in zip(row, exact) if ex)
