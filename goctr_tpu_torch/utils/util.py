"""Small helpers mirroring the reference utils package (go-ctr
utils/util.go); port of goctr_tpu/utils/util.py, output for output."""
from __future__ import annotations

from collections import Counter
from typing import Sequence

import numpy as np

from goctr_tpu_torch.core import metrics as _metrics


def concat_slices(*slices: Sequence[float]) -> np.ndarray:
    """ConcatSlice32 util.go:22-28 — concatenate feature blocks into one row."""
    if not slices:
        return np.zeros((0,), dtype=np.float32)
    return np.concatenate([np.asarray(s, dtype=np.float32).ravel()
                           for s in slices])


def top_n_occurrences(items: Sequence[str], n: int) -> list[tuple[str, int]]:
    """TopNOccurrences util.go:42-69 — most-common strings with counts,
    count-desc then first-seen order for ties (Counter preserves insertion)."""
    return Counter(items).most_common(n)


def parse_int64_seq(s: str) -> list[int]:
    """ParseInt64Seq util.go:71-86 — parse 'a,b,c' into ints, skipping junk."""
    out = []
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            out.append(int(tok))
        except ValueError:
            continue
    return out


def accuracy(prediction, y, threshold: float = 0.5) -> float:
    """Accuracy32 util.go:106-114 — thresholded binary accuracy."""
    p = (np.asarray(prediction).ravel() > threshold).astype(np.int32)
    t = (np.asarray(y).ravel() > threshold).astype(np.int32)
    return float(np.mean(p == t))


def roc_auc(pred, y) -> float:
    """RocAuc32 util.go:131-148."""
    return _metrics.roc_auc_score(y, pred)


def parallelize(n_jobs: int, n_items: int, fn) -> None:
    """Host-side row-range sharding (reference base.Parallelize
    nn/base/parallel.go:9-33): fn(worker_idx, start, end) over n_items split
    across n_jobs threads, for IO-bound host work like feature fetches.
    Every worker's exception reaches the caller."""
    from concurrent.futures import ThreadPoolExecutor

    n_jobs = max(1, min(n_jobs, n_items))
    per = -(-n_items // n_jobs)
    with ThreadPoolExecutor(max_workers=n_jobs) as pool:
        futs = []
        for w in range(n_jobs):
            start, end = w * per, min((w + 1) * per, n_items)
            if start >= end:
                break
            futs.append(pool.submit(fn, w, start, end))
        for f in futs:
            f.result()
