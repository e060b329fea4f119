"""User-behavior cache with time-travel-safe filtering (port of
goctr_tpu/features/ubcache.py).

Parity with the reference's feature/ubcache/cache.go: sequences are stored in
timestamp-descending order; Get(user, max_ts, count) skips entries newer than
max_ts (preventing label leakage during training) then returns the next
`count` items. max_ts==0 → no time filter; count==0 → no length cap.

`as_padded_arrays` exports the whole cache as fixed-shape [n_users, max_len]
arrays + a length vector, the layout a device-side behavior-embedding gather
consumes (in place of the per-sample Go slice munging at the reference's
recommend/rcmd.go:509-530); `bulk_get` answers n (user, max_ts) queries in
one vectorized pass.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TimeSeq:
    ts: np.ndarray     # int64, descending
    items: np.ndarray  # int64

    def filter(self, max_ts: int = 0, max_len: int = 0) -> "TimeSeq":
        if self.ts.size == 0:
            return TimeSeq(self.ts, self.items)
        if max_ts == 0:
            max_ts = int(self.ts[0])
        count = int(max_len) if max_len else self.ts.size
        # first index with ts <= max_ts (ts is descending)
        i = int(np.searchsorted(-self.ts, -max_ts, side="left"))
        count = min(count, self.ts.size - i)
        return TimeSeq(self.ts[i:i + count], self.items[i:i + count])


class UserBehaviorCache:

    def __init__(self):
        self._lock = threading.RLock()
        self._ub: dict[int, TimeSeq] = {}
        self._flat = None    # (uids_sorted, offsets, ts_asc, items_asc) memo

    def set(self, user_id: int, ts, items) -> None:
        with self._lock:
            self._ub[user_id] = TimeSeq(
                np.asarray(ts, dtype=np.int64),
                np.asarray(items, dtype=np.int64))
            self._flat = None

    def batch_set(self, ub: dict[int, tuple]) -> None:
        with self._lock:
            for uid, (ts, items) in ub.items():
                self._ub[uid] = TimeSeq(
                    np.asarray(ts, dtype=np.int64),
                    np.asarray(items, dtype=np.int64))
            self._flat = None

    def delete(self, user_id: int) -> None:
        with self._lock:
            self._ub.pop(user_id, None)
            self._flat = None

    def clear(self) -> None:
        with self._lock:
            self._ub = {}
            self._flat = None

    def __len__(self) -> int:
        return len(self._ub)

    def get(self, user_id: int, max_ts: int = 0,
            count: int = 0) -> Optional[TimeSeq]:
        """None when the user is unknown (reference returns an error)."""
        with self._lock:
            seq = self._ub.get(user_id)
            if seq is None:
                return None
            return seq.filter(max_ts, count)

    # ---------------------------------------------------------- bulk query --
    def _flat_arrays(self):
        """Memoized flat layout: all users' sequences concatenated in
        ascending-ts order with per-user offsets, for vectorized bulk
        queries. Rebuilt lazily after any mutation."""
        with self._lock:
            if self._flat is None:
                uids = np.fromiter(self._ub.keys(), np.int64,
                                   count=len(self._ub))
                order = np.argsort(uids, kind="stable")
                uids = uids[order]
                seqs = list(self._ub.values())
                lens = np.asarray([seqs[i].ts.size for i in order], np.int64)
                offsets = np.zeros(len(uids) + 1, np.int64)
                np.cumsum(lens, out=offsets[1:])
                total = int(offsets[-1])
                ts_asc = np.empty(total, np.int64)
                items_asc = np.empty(total, np.int64)
                for r, i in enumerate(order):
                    s, e = offsets[r], offsets[r + 1]
                    ts_asc[s:e] = seqs[i].ts[::-1]      # stored desc → asc
                    items_asc[s:e] = seqs[i].items[::-1]
                self._flat = (uids, offsets, ts_asc, items_asc)
            return self._flat

    def bulk_get(self, user_ids: np.ndarray, max_ts: np.ndarray,
                 max_len: int, pad_item: int = -1) -> np.ndarray:
        """Vectorized Get for n (user, max_ts) queries at once: returns
        [n, max_len] int64 item ids, each row the user's most recent
        `max_len` behaviors with ts <= max_ts[i], newest first (the exact
        Filter semantics of the per-user path, cache.go:71-94), padded
        with `pad_item`. Unknown users → all-pad rows.

        One searchsorted over a (user, ts) composite key replaces n Python
        cache lookups — the sample-assembly hot loop at ML-20M scale
        (14.4M train rows) runs in seconds instead of hours."""
        uids_s, offsets, ts_asc, items_asc = self._flat_arrays()
        user_ids = np.asarray(user_ids, np.int64)
        max_ts = np.asarray(max_ts, np.int64)
        n = user_ids.shape[0]
        if uids_s.size == 0:      # empty cache: every user is unknown
            return np.full((n, max_len), pad_item, np.int64)
        urow = np.searchsorted(uids_s, user_ids)
        known = (urow < uids_s.size)
        urow = urow.clip(0, max(uids_s.size - 1, 0))
        if uids_s.size:
            known &= uids_s[urow] == user_ids
        else:
            known[:] = False
        # composite key: ts fits 38 bits (year ~10889); rows sorted by
        # (user, ts) asc ⇒ flat position of the query = count of entries
        # with ts <= max_ts in the user's range
        base = offsets[urow]
        hi = offsets[urow + 1]
        # searchsorted over the user's slice, vectorized via global keys
        SHIFT = np.int64(1) << 38
        # max_ts == 0 → no time filter (reference Filter semantics)
        mt = np.where(max_ts == 0, SHIFT - 1, np.minimum(max_ts, SHIFT - 1))
        keys = uids_s[urow] * SHIFT + mt
        flat_keys = np.repeat(uids_s, np.diff(offsets)) * SHIFT + ts_asc
        k = np.searchsorted(flat_keys, keys, side="right")
        k = np.where(known, np.minimum(k, hi), base)
        take = np.minimum(k - base, max_len)          # how many to emit
        j = np.arange(max_len, dtype=np.int64)[None, :]
        idx = k[:, None] - 1 - j                      # newest first
        valid = j < take[:, None]
        out = np.full((n, max_len), pad_item, np.int64)
        np.copyto(out, items_asc[idx.clip(0, max(ts_asc.size - 1, 0))],
                  where=valid)
        return out

    # ------------------------------------------------------- device export --
    def as_padded_arrays(self, max_len: int,
                         pad_item: int = -1) -> tuple[np.ndarray, ...]:
        """(user_ids[n], items[n, max_len], lengths[n]) with tail padding.

        Items are each user's latest `max_len` behaviors (no time filter —
        callers needing per-sample max_ts use get()); pad_item marks padding
        so embedding lookups can mask it.
        """
        with self._lock:
            n = len(self._ub)
            user_ids = np.fromiter(self._ub.keys(), dtype=np.int64, count=n)
            items = np.full((n, max_len), pad_item, dtype=np.int64)
            lengths = np.zeros(n, dtype=np.int32)
            for r, seq in enumerate(self._ub.values()):
                k = min(max_len, seq.items.size)
                items[r, :k] = seq.items[:k]
                lengths[r] = k
        return user_ids, items, lengths
