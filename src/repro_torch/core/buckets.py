"""Prefix-bucket planning + the shared rows-touched cost model.

The paper's clustered policy groups level-k candidate tasks by their
(k-1)-prefix (§4). ``repro_torch.core.fpm`` makes the *bucket* the unit of
task execution (prefix intersection computed once, extensions swept
vectorized) — and since the engine went mesh-aware, bucket placement
on workers IS bucket placement on devices, so this grouping also
defines what a cross-device bucket steal migrates.

Cost model: the engine MEASURES rows-touched per task (cache hits
reduce it) and converts via :func:`rows_to_bytes`;
:func:`class_rows_touched` is the depth-first task's accounting.
:func:`bucket_rows_touched` / :func:`candidate_rows_touched` are the
corresponding ANALYTIC models — the (k-1)+E vs k·E contrast the paper
argues from — kept as the documented reference the measurements are
read against (and pinned by tests), not called on the hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.core.itemsets import Itemset, itemset_hash, prefix_hash

BYTES_PER_WORD = 4                    # uint32 TID-bitmap words


@dataclasses.dataclass(frozen=True)
class Bucket:
    """All level-k candidates sharing one (k-1)-prefix.

    ``key`` is the paper's XOR'd prefix hash (the clustered policy's
    bucket key); ``exts`` are the candidates' last items, sorted, so the
    bucket's candidate set is ``{prefix + (e,) for e in exts}``.
    """
    key: int
    prefix: Itemset
    exts: Tuple[int, ...]

    def __len__(self) -> int:
        return len(self.exts)

    def candidates(self) -> List[Itemset]:
        return [self.prefix + (e,) for e in self.exts]


def group_by_prefix(cands: Sequence[Itemset]) -> List[Bucket]:
    """Group candidates by (k-1)-prefix, preserving first-seen prefix
    order (Apriori's gen_candidates emits prefixes contiguously, so this
    is also prefix-sorted order for sorted inputs)."""
    groups: Dict[Tuple[int, Itemset], List[int]] = {}
    for c in cands:
        groups.setdefault((prefix_hash(c), c[:-1]), []).append(c[-1])
    return [Bucket(h, pref, tuple(sorted(ext)))
            for (h, pref), ext in groups.items()]


def gen_buckets(frequent: Sequence[Itemset],
                known_frequent: Iterable[Itemset] = ()) -> List[Bucket]:
    """``group_by_prefix(gen_candidates(frequent, known_frequent))``
    without the flat candidate list: the same buckets, keys and order.

    F_{k-1} (distinct itemsets of one size) is grouped by its
    (k-2)-prefix P; each item ``a`` of a group, in sorted order, heads
    the bucket ``P + (a,)`` whose extensions are the group's later items
    that pass the Apriori prune. Joining two members of a group makes
    the two subsets that drop ``a`` or the extension members of F_{k-1},
    so only the k-2 subsets that drop an item of P are probed. At k=2
    there is no prune and the extensions are a slice of the sorted
    items: no tuple is built per candidate. A head whose extensions are
    all pruned gets no bucket."""
    if not frequent:
        return []
    k = len(frequent[0]) + 1
    fset = None
    if k > 2:
        fset = set(frequent)
        fset.update(known_frequent)
    by_prefix: Dict[Itemset, List[int]] = {}
    for it in frequent:
        by_prefix.setdefault(it[:-1], []).append(it[-1])
    out: List[Bucket] = []
    for pref, lasts in by_prefix.items():
        lasts.sort()
        for i, a in enumerate(lasts):
            exts = lasts[i + 1:]
            if fset is not None:
                subs = [pref[:j] + pref[j + 1:] + (a,) for j in range(k - 2)]
                exts = [b for b in exts
                        if all(s + (b,) in fset for s in subs)]
            if exts:
                head = pref + (a,)
                out.append(Bucket(itemset_hash(head), head, tuple(exts)))
    return out


def bucket_rows_touched(prefix_len: int, n_exts: int) -> int:
    """Bitmap rows a bucket sweep reads: the (k-1) prefix rows once,
    plus one row per extension (the clustered/bucket cost model; the
    per-candidate model is ``k`` rows per candidate, no reuse)."""
    return prefix_len + n_exts


def candidate_rows_touched(k: int, n_cands: int) -> int:
    """Rows read when every candidate performs its full k-way join."""
    return k * n_cands


def class_rows_touched(n_exts: int, n_children: int) -> int:
    """Rows a depth-first equivalence-class task reads: its parent-handed
    prefix bitmap (1 row — never recomputed, where the bucket model pays
    ``k-1`` prefix rows per bucket), one row per extension in the sweep,
    and one row per *frequent* child whose bitmap it materializes for
    the handoff. Per-class the comparison vs the bucket model's
    ``(k-1) + E`` can go either way (the handoff saves ``k-2`` prefix
    rows but pays ``C`` materializations, and Eclat sweeps candidates
    Apriori's cross-class prune would drop), so total traffic is an
    empirical question the granularity benchmark measures."""
    return 1 + n_exts + n_children


def rows_to_bytes(rows: int, n_words: int) -> int:
    """Bitmap rows -> bytes of TID-bitmap traffic."""
    return rows * n_words * BYTES_PER_WORD


# ---------------------------------------------------------------------------
# Density-aware representation + granularity selection (dEclat hybrid)
# ---------------------------------------------------------------------------

REPRESENTATIONS = ("auto", "bitmap", "sparse")

# Breakeven between the two sweep primitives, in elements-per-word: a
# dense sweep touches every one of the row's W words (AND + popcount,
# ~1 fused pass/word); a sparse sweep gathers one ext word per tid and
# tests one bit (~2-3 scalar-equivalent ops/element, no locality).
# A tid-list of S entries therefore costs about S / TIDS_PER_WORD
# "word-equivalents", and sparse wins once S < TIDS_PER_WORD * W.
TIDS_PER_WORD = 2.0

# Ones-per-word above which level-synchronous buckets beat depth-first
# even in bitmap representation (very dense, very wide classes — chess
# territory: huge supports keep every word busy and the level barrier
# amortizes across few, fat sweeps). Mushroom sits near 5 ones/word
# (depth-first wins), chess above 20 (bucket wins on clustered).
DF_ONES_PER_WORD = 16.0

# EWMA weight for folding measured sweep supports into the density
# estimate (level-1 seeds it; each observed sweep nudges it).
DENSITY_EWMA = 0.2


@dataclasses.dataclass
class DensityModel:
    """Density-driven cost model for per-subtree representation and
    granularity selection — the hybrid-representation extension of
    :func:`class_rows_touched`.

    All costs are in *word-equivalents* (one dense uint32 word scanned
    = 1.0), so dense and sparse sweeps land on one axis: a bitmap row
    costs ``n_words`` regardless of support, a tid-list of S entries
    costs ``S / TIDS_PER_WORD``, and a dEclat diffset of D entries
    costs ``D / TIDS_PER_WORD`` (support comes from the parent's
    already-known sibling supports, so only the difference is swept).

    ``ones_per_word`` is the measured density gauge: seeded from the
    level-1 item supports (``seed_from_counts`` — free, because
    ``pack_database`` now counts ones while packing) and EWMA-updated
    from actual sweep results (:meth:`observe`), so the granularity
    choice tracks the subtree the engine is actually in, not the
    dataset-wide average.

    ``force`` pins the representation ("bitmap" / "sparse") for A/B
    runs; granularity selection still follows density.
    """
    n_words: int
    force: str | None = None          # None=auto, "bitmap", "sparse"
    tids_per_word: float = TIDS_PER_WORD
    ones_per_word: float = 0.0        # measured EWMA density gauge
    # decision counters (surfaced through MiningMetrics)
    bitmap_picks: int = 0
    tidlist_picks: int = 0
    diffset_picks: int = 0

    @classmethod
    def from_counts(cls, n_words: int, counts, force: str | None = None,
                    tids_per_word: float = TIDS_PER_WORD) -> "DensityModel":
        """Seed from per-item ones counts (pack_database's one-pass
        byproduct): ones_per_word starts at the mean item density."""
        m = cls(n_words=n_words, force=force, tids_per_word=tids_per_word)
        if counts is not None and len(counts) and n_words > 0:
            m.ones_per_word = float(sum(counts)) / (len(counts) * n_words)
        return m

    # ------------------------------------------------------------ costs --
    def row_cost(self, rep: str, size: int) -> float:
        """Word-equivalents one sweep pass over a row of this
        representation touches. ``size`` is the entry count (support
        for tid-lists, difference size for diffsets; ignored for
        bitmaps)."""
        if rep == "bitmap":
            return float(self.n_words)
        return size / self.tids_per_word

    def class_cost(self, rep: str, size: int, n_exts: int,
                   n_children: int) -> float:
        """Density-aware generalisation of :func:`class_rows_touched`:
        word-equivalents a depth-first class task touches — the prefix
        row once, one ext-row pass per extension (a sparse prefix
        gathers only ``size`` words per ext, never W), and one
        materialization per frequent child."""
        per_pass = self.row_cost(rep, size)
        return per_pass * (1 + n_exts + n_children)

    # -------------------------------------------------------- selection --
    def pick_rep(self, support: int) -> str:
        """Representation for a standalone row (no parent context):
        bitmap vs tid-list by sweep cost."""
        if self.force == "bitmap":
            return "bitmap"
        if self.force == "sparse":
            return "tidlist"
        if self.row_cost("tidlist", support) < self.n_words:
            return "tidlist"
        return "bitmap"

    def pick_child_rep(self, parent_support: int, child_support: int,
                       allow_diffset: bool = True) -> str:
        """Representation for a depth-first child handoff. Candidates:
        bitmap (W words), tid-list (child_support entries), diffset
        (parent_support - child_support entries, anchored on the
        parent). Cheapest sweep cost wins; ties prefer the simpler
        representation (bitmap > tidlist > diffset). Scalar arithmetic
        on purpose: this runs once per child class, so list-building
        would be a measurable share of the per-class Python floor."""
        if self.force != "bitmap":
            best = child_support / self.tids_per_word
            rep = "tidlist"
            if allow_diffset:
                diff = parent_support - child_support
                if diff < 0:
                    diff = 0
                df = diff / self.tids_per_word
                if df < best:
                    best = df
                    rep = "diffset"
            if self.force == "sparse" or best < self.n_words:
                if rep == "tidlist":
                    self.tidlist_picks += 1
                else:
                    self.diffset_picks += 1
                return rep
        self.bitmap_picks += 1
        return "bitmap"

    def pick_granularity(self, support: int) -> str:
        """Bucket vs depth-first for one subtree (``granularity="auto"``).
        Sparse subtrees always go depth-first (diffset handoffs shrink
        with depth; level-sync would re-pay full-width sweeps). Dense
        subtrees go depth-first only below DF_ONES_PER_WORD — beyond
        that (chess-dense) the bucket engine's fat, few sweeps win."""
        if self.pick_rep(support) != "bitmap":
            return "depth-first"
        if self.n_words and support / self.n_words <= DF_ONES_PER_WORD:
            return "depth-first"
        return "bucket"

    # ------------------------------------------------------ measurement --
    def observe(self, supports) -> None:
        """Fold measured sweep supports into the density gauge (EWMA),
        so per-subtree decisions track observed — not assumed —
        density."""
        if self.n_words <= 0 or len(supports) == 0:
            return
        mean = float(sum(supports)) / (len(supports) * self.n_words)
        self.ones_per_word += DENSITY_EWMA * (mean - self.ones_per_word)
