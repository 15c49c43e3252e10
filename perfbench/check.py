"""The comparison that decides ``correct``.

A mine or a published generation is correct when it holds exactly the
itemsets of at most ``max_k`` items whose support reaches the
threshold, each with its exact support: the configuration's guarantee.
The number compared is how many itemsets are wrong (missing, extra, or
with another support) against the plain reference
(``perfbench/reference``); a served query is wrong when its support
differs from the reference's count. Both limits are 0.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

Itemset = Tuple[int, ...]

LIMITS = {"itemsets_wrong": 0, "queries_wrong": 0}


def itemsets_wrong(got: Mapping[Itemset, int],
                   want: Mapping[Itemset, int]) -> int:
    """Itemsets missing from ``got``, extra in it, or counted otherwise."""
    wrong = sum(1 for x, s in want.items() if got.get(x) != s)
    return wrong + sum(1 for x in got if x not in want)


def queries_wrong(got: Sequence[int], want: Sequence[int]) -> int:
    if len(got) != len(want):
        return max(len(got), len(want))
    return sum(1 for a, b in zip(got, want) if int(a) != int(b))


def verdict(numbers: Dict[str, int]) -> Tuple[bool, List[str], Dict]:
    """(correct, lines for standard error, the result line's entry):
    each number beside its limit."""
    lines, entry, ok = [], {}, True
    for name, value in numbers.items():
        limit = LIMITS[name]
        ok = ok and value <= limit
        lines.append(f"check {name} {value} limit {limit}")
        entry[name] = {"value": value, "limit": limit}
    return ok, lines, entry
