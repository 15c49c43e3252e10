"""The streaming layer's store of known supports, held bucket by bucket.

A refresh re-mines only what the pending segments can change, so it
keeps the exact support of every candidate it ever counted: frequent
itemsets, the negative border and query backfills. A level's candidates
arrive as prefix buckets (``core/buckets.py``), so the store is shaped
the same way: each prefix maps to a sorted ``int32`` array of
extensions and an ``int64`` array of supports beside it. An itemset
``x`` is the entry ``x[-1]`` of the bucket ``x[:-1]`` (a singleton's
prefix is ``()``).

:class:`KnownStore` is a ``MutableMapping`` from itemset tuples to
supports, so code that reads or writes a few entries at a time (query
planning and backfills, staleness priorities, the depth-first refresh)
uses it as it would a dict. The levelwise refresh works a whole level
at a time: :meth:`KnownStore.gather` lays the level's buckets end to
end, :func:`bucket_keys` and :func:`find` align them with the plan in
one search, :meth:`KnownStore.scatter` writes the folded level back,
and :meth:`KnownStore.split` thresholds the store at publish. It builds
no itemset tuple for a candidate it does not publish.

Copy-on-write: a stored array is never written in place (the store
marks each one read-only). A write makes new arrays for its bucket, and
:meth:`KnownStore.copy` and :meth:`KnownStore.split` copy only the
prefix map. A refresh therefore mines against a copy and commits it
whole (or drops it on a failure), and a published border stays as it
was whatever the store does next.
"""
from __future__ import annotations

from collections.abc import ItemsView, Mapping, MutableMapping
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.itemsets import Itemset

EXT_DTYPE = np.int32
SUP_DTYPE = np.int64
_NO_EXTS = np.zeros(0, EXT_DTYPE)
_NO_SUPS = np.zeros(0, SUP_DTYPE)
_NO_EXTS.flags.writeable = _NO_SUPS.flags.writeable = False
_EMPTY = (_NO_EXTS, _NO_SUPS)

_Bucket = Tuple[np.ndarray, np.ndarray]     # (sorted exts, supports)


def ext_array(exts: Iterable[int]) -> np.ndarray:
    """Extensions as the store keeps them (``int32``; callers pass them
    sorted and distinct)."""
    return np.fromiter(exts, EXT_DTYPE)


def find(stored: np.ndarray, values: np.ndarray
         ) -> Tuple[np.ndarray, np.ndarray]:
    """``(pos, found)``: where each of the sorted ``values`` sits or
    would go in the sorted ``stored``, and whether it is there."""
    pos = np.searchsorted(stored, values)
    found = pos < len(stored)
    found[found] = stored[pos[found]] == values[found]
    return pos, found


def _frozen(*arrays: np.ndarray) -> None:
    """Mark arrays the store keeps read-only, so that a write in place
    anywhere raises instead of changing a copy or a published border."""
    for a in arrays:
        a.flags.writeable = False


def _key(x) -> Tuple[Itemset, int]:
    if not isinstance(x, tuple) or not x:
        raise KeyError(x)
    return x[:-1], x[-1]


class _Items(ItemsView):
    """``items()`` read straight from the arrays, not key by key."""

    def __iter__(self):
        return self._mapping._iter_items()


def _iter_items(buckets: Dict[Itemset, _Bucket], keep=None
                ) -> Iterator[Tuple[Itemset, int]]:
    for p, (exts, sups) in buckets.items():
        if keep is not None:
            m = keep(p, sups)
            if m is None:
                continue
            exts, sups = exts[m], sups[m]
        for e, s in zip(exts.tolist(), sups.tolist()):
            yield p + (e,), s


class KnownStore(MutableMapping):
    """Itemset → exact support, stored as per-prefix numpy arrays.

    Built from a mapping or from ``(itemset, support)`` pairs. Reads and
    writes by itemset behave as a dict's; :meth:`update` groups its
    entries by prefix and rebuilds each touched bucket once."""

    __slots__ = ("_b", "_n")

    def __init__(self, items=()):
        self._b: Dict[Itemset, _Bucket] = {}
        self._n = 0
        if items:
            self.update(items)

    # ----------------------------------------------------------- Mapping --
    def __getitem__(self, x) -> int:
        p, e = _key(x)
        b = self._b.get(p)
        if b is not None:
            exts, sups = b
            i = int(np.searchsorted(exts, e))
            if i < len(exts) and exts[i] == e:
                return int(sups[i])
        raise KeyError(x)

    def __iter__(self) -> Iterator[Itemset]:
        for p, (exts, _) in list(self._b.items()):
            for e in exts.tolist():
                yield p + (e,)

    def __len__(self) -> int:
        return self._n

    def items(self) -> ItemsView:
        return _Items(self)

    def _iter_items(self) -> Iterator[Tuple[Itemset, int]]:
        return _iter_items(dict(self._b))

    def __repr__(self) -> str:
        return f"KnownStore({dict(self.items())!r})"

    # ---------------------------------------------------- MutableMapping --
    def __setitem__(self, x, support: int) -> None:
        p, e = _key(x)
        self._write(p, ext_array((e,)), np.array([support], SUP_DTYPE))

    def __delitem__(self, x) -> None:
        p, e = _key(x)
        b = self._b.get(p)
        if b is None:
            raise KeyError(x)
        pos, found = find(b[0], ext_array((e,)))
        if not found[0]:
            raise KeyError(x)
        m = np.zeros(len(b[0]), bool)
        m[pos] = True
        self.drop(p, m)

    def update(self, other=(), **kw) -> None:
        """Dict ``update`` semantics (a later duplicate wins), one bucket
        rebuild per prefix touched."""
        if kw:
            raise TypeError("KnownStore keys are itemset tuples")
        pairs = other.items() if isinstance(other, Mapping) else other
        groups: Dict[Itemset, Dict[int, int]] = {}
        for x, s in pairs:
            p, e = _key(x)
            groups.setdefault(p, {})[e] = s
        for p, g in groups.items():
            exts = sorted(g)
            self._write(p, ext_array(exts),
                        np.fromiter((g[e] for e in exts), SUP_DTYPE,
                                    len(exts)))

    def copy(self) -> "KnownStore":
        """A store of its own over the same (never written) arrays: only
        the prefix map is copied."""
        out = KnownStore()
        out._b = dict(self._b)
        out._n = self._n
        return out

    # -------------------------------------------------------- bucket-wise --
    def _write(self, prefix: Itemset, exts: np.ndarray,
               sups: np.ndarray) -> None:
        """Set ``sups`` at the sorted, distinct ``exts`` (one or more) of
        ``prefix``'s bucket, inserting the extensions it lacks, into new
        arrays; the caller hands over ``exts`` and ``sups``."""
        b = self._b.get(prefix)
        if b is None:
            _frozen(exts, sups)
            self._b[prefix] = (exts, sups)
            self._n += len(exts)
            return
        old_e, old_s = b
        pos, found = find(old_e, exts)
        new_s = old_s.copy()
        new_s[pos[found]] = sups[found]
        new_e = old_e
        if not found.all():
            fresh = ~found
            new_e = np.insert(old_e, pos[fresh], exts[fresh])
            new_s = np.insert(new_s, pos[fresh], sups[fresh])
            self._n += len(new_e) - len(old_e)
        _frozen(new_e, new_s)
        self._b[prefix] = (new_e, new_s)

    def prefixes(self) -> List[Itemset]:
        return list(self._b)

    def gather(self, prefixes: Sequence[Itemset]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The buckets of ``prefixes`` end to end: ``(exts, supports,
        lengths)``, one length per prefix (0 where it has none)."""
        bs = [self._b.get(p, _EMPTY) for p in prefixes]
        lens = np.fromiter((len(e) for e, _ in bs), np.int64, len(bs))
        if not bs:
            return _NO_EXTS, _NO_SUPS, lens
        return (np.concatenate([e for e, _ in bs]),
                np.concatenate([s for _, s in bs]), lens)

    def scatter(self, prefixes: Sequence[Itemset], exts: np.ndarray,
                sups: np.ndarray, lens: np.ndarray) -> None:
        """Replace the buckets of ``prefixes`` with consecutive runs of
        ``exts`` and ``sups`` (:meth:`gather`'s layout; a prefix whose
        length is 0 goes). The runs are views: the caller hands the
        arrays over, which become read-only."""
        _frozen(exts, sups)
        ends = np.cumsum(lens).tolist()
        for p, a, z in zip(prefixes, [0] + ends[:-1], ends):
            old = self._b.get(p)
            self._n -= 0 if old is None else len(old[0])
            if z > a:
                self._b[p] = (exts[a:z], sups[a:z])
                self._n += z - a
            elif old is not None:
                del self._b[p]

    def drop(self, prefix: Itemset, mask: np.ndarray) -> int:
        """Remove the entries of ``prefix``'s bucket where ``mask`` (over
        its stored extensions) is True. Returns how many went."""
        n = int(np.count_nonzero(mask))
        if n:
            exts, sups = self._b[prefix]
            keep = ~mask
            if n == len(exts):
                del self._b[prefix]
            else:
                b = (exts[keep], sups[keep])
                _frozen(*b)
                self._b[prefix] = b
            self._n -= n
        return n

    def split(self, min_support: int, max_len: int
              ) -> Tuple[List[Tuple[Itemset, int]], "BorderView"]:
        """The entries no longer than ``max_len``, split at
        ``min_support`` in one pass: the frequent ones as ``(itemset,
        support)`` pairs, and the rest (the negative border) as a
        read-only view frozen as the store stands now."""
        prefixes = [p for p in self._b if len(p) < max_len]
        exts, sups, lens = self.gather(prefixes)
        hits = np.flatnonzero(sups >= min_support)
        which = np.repeat(np.arange(len(prefixes)), lens)[hits]
        frequent = [(prefixes[i] + (e,), s) for i, e, s in
                    zip(which.tolist(), exts[hits].tolist(),
                        sups[hits].tolist())]
        return frequent, BorderView(dict(self._b), min_support, max_len,
                                    len(sups) - len(hits))


def bucket_keys(lens: np.ndarray, exts: np.ndarray) -> np.ndarray:
    """Sort keys for buckets laid end to end: a bucket's index in the
    high bits, the extension in the low ones. Runs of sorted extensions
    in bucket order give sorted keys, so one search aligns two such
    layouts."""
    which = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    return (which << 32) | exts.astype(np.int64)


class BorderView(Mapping):
    """A generation's negative border: a read-only mapping over a frozen
    prefix map of a :class:`KnownStore` (entries below ``min_support``,
    no longer than ``max_len``). No itemset tuple is built until one is
    read, and none of the arrays is ever written, so the view never
    changes."""

    __slots__ = ("_b", "_below", "_max_len", "_n")

    def __init__(self, buckets: Dict[Itemset, _Bucket], below: int,
                 max_len: int, n: int):
        self._b = buckets
        self._below = below
        self._max_len = max_len
        self._n = n

    def __getitem__(self, x) -> int:
        p, e = _key(x)
        b = self._b.get(p)
        if b is not None and len(x) <= self._max_len:
            exts, sups = b
            i = int(np.searchsorted(exts, e))
            if i < len(exts) and exts[i] == e and sups[i] < self._below:
                return int(sups[i])
        raise KeyError(x)

    def _keep(self, p, sups):
        if len(p) >= self._max_len:
            return None
        return sups < self._below

    def __iter__(self) -> Iterator[Itemset]:
        for x, _ in _iter_items(self._b, self._keep):
            yield x

    def __len__(self) -> int:
        return self._n

    def items(self) -> ItemsView:
        return _Items(self)

    def _iter_items(self) -> Iterator[Tuple[Itemset, int]]:
        return _iter_items(self._b, self._keep)

    def __repr__(self) -> str:
        return f"BorderView({dict(self.items())!r})"
