"""Ranking / classification / regression metrics, including grouped GAUC
(port of goctr_tpu/core/metrics.py).

Mirrors the API surface of the reference's nn/metrics package
(nn/metrics/{ranking,classification,regression}.go) and utils wrappers
(utils/util.go:96-148). The host functions are numpy, copied from the
JAX package (the port imports none of it). The two device functions take
tensors and return a 0-d float64 tensor on the input's device, with no
host sync:

* `roc_auc_device` (JAX `roc_auc_jit`): ROC-AUC by the rank-sum
  (Mann-Whitney U) identity with tie-averaged ranks, one sort and two
  searchsorted;
* `gauc_device` (JAX `gauc_jit`): count-weighted per-group AUC over the
  groups that hold both classes, by a two-pass stable sort and segment
  sums.

The JAX versions form ranks and rank sums in float32, whose integers end
at 2^24 and whose sums of 10^12-sized terms drift in the 7th digit at a
2M-row eval; these accumulate in float64 (scores are ranked in their
own type), so they equal the numpy
`roc_auc_score` / `gauc_np` up to float64 rounding at any size, and JAX's
up to JAX's float32 rounding. A one-class input gives NaN AUC (as JAX);
a GAUC with no two-class group gives 0 (as JAX; `gauc_np` gives NaN).

GAUC — grouped-per-user AUC weighted by per-group sample count. The
reference README publishes "GAUC" numbers but has no implementation
in-tree; this defines it explicitly: mean over groups that contain both
classes of AUC(group), weighted by the group's #samples (or #positives
when weight='pos', host version only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "roc_auc_score", "roc_curve", "auc", "average_precision_score",
    "precision_recall_curve", "roc_auc_device", "gauc", "gauc_np",
    "gauc_device", "accuracy_score", "precision_score", "recall_score",
    "f1_score", "fbeta_score", "confusion_matrix", "log_loss",
    "r2_score", "mean_squared_error", "mean_absolute_error",
]


# ---------------------------------------------------------------- ranking ---

def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray,
                      sample_weight: Optional[np.ndarray] = None):
    """Cumulative (fps, tps, thresholds) sorted by descending score.

    Same contract as reference binaryClfCurve (ranking.go:13-69): scores
    descending, duplicate score values collapsed to the last index.
    """
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    w = (np.ones_like(y_true) if sample_weight is None
         else np.asarray(sample_weight, dtype=np.float64).ravel())

    order = np.argsort(-y_score, kind="mergesort")
    y_true, y_score, w = y_true[order], y_score[order], w[order]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true * w)[threshold_idxs]
    fps = np.cumsum((1 - y_true) * w)[threshold_idxs]
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score, pos_label: float = 1.0, sample_weight=None):
    """(fpr, tpr, thresholds); parity with reference ROCCurve ranking.go:71-104."""
    y_true = (np.asarray(y_true).ravel() == pos_label).astype(np.float64)
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score, sample_weight)
    # prepend the (0,0) origin point like sklearn / the reference
    fps = np.r_[0.0, fps]
    tps = np.r_[0.0, tps]
    thresholds = np.r_[thresholds[0] + 1 if thresholds.size else 1.0, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full_like(fps, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full_like(tps, np.nan)
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Trapezoidal area under (x, y); reference AUC ranking.go:106-142."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.size < 2:
        raise ValueError("at least 2 points required to compute AUC")
    return float(np.trapezoid(y, x))


def roc_auc_score(y_true, y_score, sample_weight=None) -> float:
    """Exact tie-aware binary ROC-AUC (reference ROCAUCScore ranking.go:144-181,
    RocAuc32 utils/util.go:131-148)."""
    if np.asarray(y_true).size == 0:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score, sample_weight=sample_weight)
    if np.any(np.isnan(fpr)) or np.any(np.isnan(tpr)):
        return float("nan")
    return auc(fpr, tpr)


def precision_recall_curve(y_true, probas_pred, pos_label: float = 1.0,
                           sample_weight=None):
    """Parity with reference PrecisionRecallCurve ranking.go:183-210."""
    y_true = (np.asarray(y_true).ravel() == pos_label).astype(np.float64)
    fps, tps, thresholds = _binary_clf_curve(y_true, probas_pred, sample_weight)
    precision = tps / np.maximum(tps + fps, 1e-300)
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    # reverse + append the (p=1, r=0) endpoint like sklearn
    sl = slice(None, None, -1)
    return (np.r_[precision[sl], 1.0], np.r_[recall[sl], 0.0], thresholds[sl])


def average_precision_score(y_true, y_score, sample_weight=None) -> float:
    """Step-wise AP (reference AveragePrecisionScore ranking.go:212-222)."""
    precision, recall, _ = precision_recall_curve(
        y_true, y_score, sample_weight=sample_weight)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


# --------------------------------------------------------------------- gauc ---

def gauc_np(y_true, y_score, group_ids, weight: str = "count") -> float:
    """Grouped AUC: weighted mean of per-group (e.g. per-user) AUC.

    Groups with a single class are skipped (their AUC is undefined), exactly
    as in the published GAUC definition (DIN paper, eq. 2). weight='count'
    weights by group size, 'pos' by positive count, 'uniform' equally.
    """
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    group_ids = np.asarray(group_ids).ravel()
    total_w, total = 0.0, 0.0
    for g in np.unique(group_ids):
        m = group_ids == g
        yt, ys = y_true[m], y_score[m]
        n_pos = float(np.sum(yt == 1))
        n_neg = float(np.sum(yt != 1))
        if n_pos == 0 or n_neg == 0:
            continue
        a = roc_auc_score(yt, ys)
        w = {"count": yt.size, "pos": n_pos, "uniform": 1.0}[weight]
        total_w += w
        total += w * a
    return total / total_w if total_w > 0 else float("nan")


# ---------------------------------------------------------- device metrics ---

def roc_auc_device(y_score: torch.Tensor, y_true: torch.Tensor
                   ) -> torch.Tensor:
    """On-device ROC-AUC via the rank-sum identity:
    AUC = (Σ ranks of positives − P(P+1)/2) / (P·N), with average ranks
    for ties (identical to the trapezoidal curve integral). y_true counts
    as given (0/1). NaN when either class is empty."""
    s = y_score.reshape(-1)
    y = y_true.reshape(-1).to(torch.float64)
    n = s.shape[0]
    sorted_s = torch.sort(s).values
    # average rank with ties: (#strictly-less + #less-or-equal + 1) / 2
    left = torch.searchsorted(sorted_s, s, side="left")
    right = torch.searchsorted(sorted_s, s, side="right")
    avg_rank = (left + right + 1).to(torch.float64) * 0.5
    n_pos = y.sum()
    n_neg = n - n_pos
    u = (avg_rank * y).sum() - n_pos * (n_pos + 1) * 0.5
    return torch.where((n_pos > 0) & (n_neg > 0), u / (n_pos * n_neg),
                       torch.full_like(u, float("nan")))


def gauc_device(y_score: torch.Tensor, y_true: torch.Tensor,
                group_ids: torch.Tensor) -> torch.Tensor:
    """On-device grouped AUC (count-weighted): gauc_np(weight="count")'s
    definition, labels thresholded at 0.5. The rows are ordered by
    (group, score) with two stable sorts (score, then the canonical group
    index), ranks within a group come from each group's start (a
    cumulative max), tie runs of equal (group, score) average their first
    and last rank (run ends by a reversed cumulative min), and per-group
    tallies are segment sums into n slots (scatter_add_)."""
    s = y_score.reshape(-1)
    y = (y_true.reshape(-1) > 0.5).to(torch.float64)
    gids = group_ids.reshape(-1)
    n = s.shape[0]
    dev = s.device

    # canonical group index 0..G-1 via the sorted ids
    gseg = torch.searchsorted(torch.sort(gids).values, gids, side="left")
    order1 = torch.sort(s, stable=True).indices
    order = order1[torch.sort(gseg[order1], stable=True).indices]
    g_s, s_s, y_s = gseg[order], s[order], y[order]

    pos = torch.arange(n, device=dev)
    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_group = torch.cat([first, g_s[1:] != g_s[:-1]])
    group_start = torch.cummax(torch.where(new_group, pos, 0), 0).values
    rank0 = (pos - group_start).to(torch.float64)         # 0-based rank
    new_run = new_group | torch.cat([first, s_s[1:] != s_s[:-1]])
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    next_start = torch.cat([torch.where(new_run[1:], pos[1:], n + 1),
                            torch.full((1,), n, device=dev)])
    run_end = torch.cummin(next_start.flip(0), 0).values.flip(0) - 1
    avg_rank = (rank0[run_start] + rank0[run_end]) * 0.5

    def seg(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.float64, device=dev).scatter_add_(
            0, g_s, v)

    n_pos = seg(y_s)
    n_tot = seg(torch.ones_like(y_s))
    n_neg = n_tot - n_pos
    # 1-based rank sum of the positives: add P per group
    u = (seg(avg_rank * y_s) + n_pos) - n_pos * (n_pos + 1) * 0.5
    auc_g = u / torch.clamp(n_pos * n_neg, min=1.0)
    w = torch.where((n_pos > 0) & (n_neg > 0), n_tot, 0.0)
    return (auc_g * w).sum() / torch.clamp(w.sum(), min=1.0)


def gauc(y_true, y_score, group_ids, weight: str = "count") -> float:
    """Grouped AUC. Host path for small evals; for large on-device evals use
    gauc_device (identical count-weighted definition)."""
    return gauc_np(y_true, y_score, group_ids, weight)


# ------------------------------------------------------------ classification ---

def accuracy_score(y_true, y_pred, normalize: bool = True,
                   sample_weight=None) -> float:
    """Reference AccuracyScore classification.go:12-37 / Accuracy32 util.go:106."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    w = np.ones_like(y_true, dtype=np.float64) if sample_weight is None \
        else np.asarray(sample_weight, dtype=np.float64).ravel()
    hit = (y_true == y_pred).astype(np.float64) * w
    return float(hit.sum() / w.sum()) if normalize else float(hit.sum())


def confusion_matrix(y_true, y_pred, sample_weight=None) -> np.ndarray:
    """Reference ConfusionMatrix classification.go:150-152."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    labels = np.unique(np.concatenate([y_true, y_pred]))
    lut = {v: i for i, v in enumerate(labels)}
    k = labels.size
    w = np.ones(y_true.size) if sample_weight is None else \
        np.asarray(sample_weight, dtype=np.float64).ravel()
    cm = np.zeros((k, k))
    for t, p, wi in zip(y_true, y_pred, w):
        cm[lut[t], lut[p]] += wi
    return cm


def _prf(y_true, y_pred, beta: float, average: str, sample_weight=None):
    """precision/recall/fbeta with micro|macro|weighted|binary averaging
    (reference PrecisionRecallFScoreSupport classification.go:74-148,
    averaging base.go:12-88)."""
    cm = confusion_matrix(y_true, y_pred, sample_weight)
    tp = np.diag(cm).astype(np.float64)
    pred_sum = cm.sum(axis=0)
    true_sum = cm.sum(axis=1)
    b2 = beta * beta

    if average == "micro":
        tp_s, pr_s, tr_s = tp.sum(), pred_sum.sum(), true_sum.sum()
        p = tp_s / pr_s if pr_s else 0.0
        r = tp_s / tr_s if tr_s else 0.0
        f = (1 + b2) * p * r / (b2 * p + r) if (p + r) else 0.0
        return p, r, f

    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(pred_sum > 0, tp / pred_sum, 0.0)
        r = np.where(true_sum > 0, tp / true_sum, 0.0)
        denom = b2 * p + r
        f = np.where(denom > 0, (1 + b2) * p * r / np.maximum(denom, 1e-300), 0.0)

    if average == "binary":
        # positive class is the largest label, matching the Go posLabel default
        i = -1
        return float(p[i]), float(r[i]), float(f[i])
    if average == "weighted":
        w = true_sum / true_sum.sum() if true_sum.sum() else np.zeros_like(true_sum)
        return float(p @ w), float(r @ w), float(f @ w)
    # macro
    return float(p.mean()), float(r.mean()), float(f.mean())


def precision_score(y_true, y_pred, average: str = "macro",
                    sample_weight=None) -> float:
    return _prf(y_true, y_pred, 1.0, average, sample_weight)[0]


def recall_score(y_true, y_pred, average: str = "macro",
                 sample_weight=None) -> float:
    return _prf(y_true, y_pred, 1.0, average, sample_weight)[1]


def f1_score(y_true, y_pred, average: str = "macro",
             sample_weight=None) -> float:
    return _prf(y_true, y_pred, 1.0, average, sample_weight)[2]


def fbeta_score(y_true, y_pred, beta: float, average: str = "macro",
                sample_weight=None) -> float:
    return _prf(y_true, y_pred, beta, average, sample_weight)[2]


def log_loss(y_true, y_prob, eps: float = 1e-10) -> float:
    """Binary cross-entropy (reference binLogLoss basemlp64.go:171-183)."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    p = np.clip(np.asarray(y_prob, dtype=np.float64).ravel(), eps, 1 - eps)
    return float(-np.mean(y_true * np.log(p) + (1 - y_true) * np.log(1 - p)))


# --------------------------------------------------------------- regression ---

def r2_score(y_true, y_pred, sample_weight=None) -> float:
    """Reference R2Score regression.go:83-151 (uniform_average)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    w = np.ones_like(y_true) if sample_weight is None else \
        np.asarray(sample_weight, dtype=np.float64)
    num = np.sum(w * (y_true - y_pred) ** 2, axis=0)
    mean = np.average(y_true, axis=0, weights=w)
    den = np.sum(w * (y_true - mean) ** 2, axis=0)
    return float(np.mean(1.0 - num / np.maximum(den, 1e-300)))


def mean_squared_error(y_true, y_pred, sample_weight=None) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    w = np.ones_like(y_true) if sample_weight is None else \
        np.asarray(sample_weight, dtype=np.float64)
    return float(np.average((y_true - y_pred) ** 2, weights=w))


def mean_absolute_error(y_true, y_pred, sample_weight=None) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    w = np.ones_like(y_true) if sample_weight is None else \
        np.asarray(sample_weight, dtype=np.float64)
    return float(np.average(np.abs(y_true - y_pred), weights=w))
