"""MovieLens reference app: the RecSys implementation driving the example
pipeline (port of goctr_tpu/data/movielens.py) — feature parity with the
reference's example/movielens/.

Feature vectors (bit-compatible with the Go example):
  item (feature.go:87-143): 5 genres × 10-dim FNV-1 hash one-hot +
    (year-1990)/20 + avg_rating/5 + log2(cnt_rating)
  user (feature.go:145-196): avgRating/5, cntRating/100 + top-5 genres ×
    10-dim hash one-hot (count-desc, first-seen tiebreak)
Labels binarize at rating > 3.5 (feature.go:386-398). Stage-keyed table
sourcing (train vs test, feature.go:156-163); user-behavior via prefilled
ub caches with SQL fallback (prepare.go:13-67).
"""
from __future__ import annotations

import math
import re
import sqlite3
import threading
from typing import Iterator, Optional

import numpy as np

from goctr_tpu_torch.features.hashing import hash_onehot
from goctr_tpu_torch.features.ubcache import UserBehaviorCache
from goctr_tpu_torch.recommend.rcmd import Context, Sample, Stage
from goctr_tpu_torch.utils.util import parse_int64_seq, top_n_occurrences

_YEAR_RE = re.compile(r"\((\d{4})\)$")


def genre_feature(genre: str) -> np.ndarray:
    """feature.go:199-201: HashOneHot32(genre, 10)."""
    return hash_onehot(genre, 10)


def binarize_label(rating: float) -> float:
    """feature.go:386-398."""
    return 1.0 if rating > 3.5 else 0.0


class MovielensRec:

    def __init__(self, data_path: str, sample_cnt: int = 80000):
        self.data_path = data_path
        self.sample_cnt = sample_cnt
        self._local = threading.local()
        self.m_rating_map: dict[int, tuple[float, float]] = {}
        self.ubc_train: Optional[UserBehaviorCache] = None
        self.ubc_predict: Optional[UserBehaviorCache] = None

    # --------------------------------------------------------------- db ----
    @property
    def db(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(f"file:{self.data_path}?mode=ro", uri=True)
            self._local.conn = conn
        return conn

    # --------------------------------------------------- required surface --
    def get_item_feature(self, ctx: Context, item_id: int) -> np.ndarray:
        row = self.db.execute(
            "SELECT title, genres FROM movies WHERE movieId = ?",
            (item_id,)).fetchone()
        if row is None:
            raise KeyError(f"itemId {item_id} not found")
        return self._item_vec(item_id, *row)

    def get_user_feature(self, ctx: Context, user_id: int) -> np.ndarray:
        table = ("user_feature_train" if ctx.stage == Stage.TRAIN
                 else "user_feature_test")
        row = self.db.execute(
            f"SELECT ugenres, avgRating, cntRating FROM {table} "
            f"WHERE userId = ?", (user_id,)).fetchone()
        if row is None:
            raise KeyError(f"userId {user_id} not found")
        return self._user_vec(*row)

    # batched fetch used by the vectorized serving path (one SQL IN query
    # per unique-id set instead of a query per row)
    def get_item_features_batch(self, ctx: Context,
                                item_ids: list[int]) -> dict:
        out: dict[int, np.ndarray] = {}
        for chunk_start in range(0, len(item_ids), 500):
            chunk = item_ids[chunk_start:chunk_start + 500]
            ph = ",".join("?" * len(chunk))
            rows = self.db.execute(
                f"SELECT movieId, title, genres FROM movies "
                f"WHERE movieId IN ({ph})", chunk).fetchall()
            for item_id, title, genres in rows:
                out[int(item_id)] = self._item_vec(int(item_id), title,
                                                   genres)
        return out

    def _item_vec(self, item_id: int, title: str, genres: str) -> np.ndarray:
        m = _YEAR_RE.search(title or "")
        year = int(m.group(1)) if m else 0
        gt = np.zeros(50, np.float32)
        for i, g in enumerate((genres or "").split("|")[:5]):
            gt[i * 10:(i + 1) * 10] = genre_feature(g)
        avg_r, cnt_r = 0.0, 0.0
        mr = self.m_rating_map.get(item_id)
        if mr:
            avg_r = mr[0] / 5.0
            cnt_r = math.log2(mr[1]) if mr[1] > 0 else 0.0
        return np.concatenate([gt, np.asarray(
            [(year - 1990) / 20.0, avg_r, cnt_r], np.float32)])

    def get_user_features_batch(self, ctx: Context,
                                user_ids: list[int]) -> dict:
        table = ("user_feature_train" if ctx.stage == Stage.TRAIN
                 else "user_feature_test")
        out: dict[int, np.ndarray] = {}
        for chunk_start in range(0, len(user_ids), 500):
            chunk = user_ids[chunk_start:chunk_start + 500]
            ph = ",".join("?" * len(chunk))
            rows = self.db.execute(
                f"SELECT userId, ugenres, avgRating, cntRating FROM {table} "
                f"WHERE userId IN ({ph})", chunk).fetchall()
            for user_id, ugenres, avg_r, cnt_r in rows:
                out[int(user_id)] = self._user_vec(ugenres, avg_r, cnt_r)
        return out

    def _user_vec(self, ugenres, avg_r, cnt_r) -> np.ndarray:
        genre_list = [g for g in re.split(r"[|,]", ugenres or "") if g]
        top5 = top_n_occurrences(genre_list, 5)
        gt = np.zeros(50, np.float32)
        for i, (g, _) in enumerate(top5):
            gt[i * 10:(i + 1) * 10] = genre_feature(g)
        head = np.asarray([(avg_r or 0.0) / 5.0, (cnt_r or 0.0) / 100.0],
                          np.float32)
        return np.concatenate([head, gt])

    def sample_generator(self, ctx: Context) -> Iterator[Sample]:
        cur = self.db.execute(
            "SELECT userId, movieId, rating, timestamp FROM ratings_train "
            "ORDER BY timestamp, userId ASC LIMIT ?", (self.sample_cnt,))
        for user_id, movie_id, rating, ts in cur:
            yield Sample(user_id=int(user_id), item_id=int(movie_id),
                         label=binarize_label(rating), timestamp=int(ts))

    def sample_generator_arrays(self, ctx: Context):
        """Column-array sample stream (same rows/order as sample_generator)
        — feeds the orchestrator's vectorized assembly without 14.4M Sample
        objects at the reference's ML-20M protocol scale
        (dinimpl_test.go:26 SampleCnt=14,400,000)."""
        import os
        sidecar = self.data_path + ".cols.npz"
        if os.path.exists(sidecar):
            # (ts, userId)-ordered column sidecar written by the ml20m
            # generator — skips the 14.4M-row SQL-cursor read (117 s at
            # full scale, BENCH_NOTES r5)
            with np.load(sidecar) as z:
                k = self.sample_cnt
                return (z["train_uid"][:k], z["train_iid"][:k],
                        (z["train_rating"][:k] > 3.5).astype(np.float32),
                        z["train_ts"][:k])
        cur = self.db.execute(
            "SELECT userId, movieId, rating, timestamp FROM ratings_train "
            "ORDER BY timestamp, userId ASC LIMIT ?", (self.sample_cnt,))
        chunks = []
        while True:
            rows = cur.fetchmany(1_000_000)
            if not rows:
                break
            chunks.append(np.asarray(rows, np.float64))
        if not chunks:
            return (np.zeros(0, np.int64),) * 2 + (
                np.zeros(0, np.float32), np.zeros(0, np.int64))
        arr = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        return (arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
                (arr[:, 2] > 3.5).astype(np.float32),   # binarize_label
                arr[:, 3].astype(np.int64))

    def get_user_behaviors_bulk(self, ctx: Context, user_ids, timestamps,
                                max_len: int) -> np.ndarray:
        """Vectorized counterpart of get_user_behavior: [n, max_len] int64
        item ids (-1 pad), newest-first with ts <= timestamps[i] — one
        UserBehaviorCache.bulk_get instead of n per-row lookups."""
        if ctx.stage == Stage.TRAIN:
            if self.ubc_train is None:
                self.pre_train(ctx)
            cache = self.ubc_train
        else:
            if self.ubc_predict is None:
                self.pre_rank(ctx)
            cache = self.ubc_predict
        return cache.bulk_get(np.asarray(user_ids, np.int64),
                              np.asarray(timestamps, np.int64), max_len)

    # --------------------------------------------------- optional surface --
    def item_seq_generator(self, ctx: Context) -> Iterator[list[str]]:
        """Per-user liked-item docs. The reference streams one global
        ordered item stream (feature.go:47-84); per-user docs avoid
        cross-user windows and train the same similarity structure."""
        cur = self.db.execute(
            "SELECT userId, movieId FROM ratings_train WHERE rating > 3.5 "
            "ORDER BY userId, timestamp")
        doc: list[str] = []
        prev_user = None
        for user_id, movie_id in cur:
            if prev_user is not None and user_id != prev_user and doc:
                yield doc
                doc = []
            prev_user = user_id
            doc.append(str(movie_id))
        if doc:
            yield doc

    def get_user_behavior(self, ctx: Context, user_id: int, max_len: int,
                          max_pk: int, max_ts: int) -> list[int]:
        cache = (self.ubc_train if ctx.stage == Stage.TRAIN
                 else self.ubc_predict)
        if cache is not None:
            seq = cache.get(user_id, max_ts=max_ts, count=max_len)
            if seq is not None:
                return [int(x) for x in seq.items]
        table = ("ratings_train" if ctx.stage == Stage.TRAIN
                 else "ratings_test")
        cur = self.db.execute(
            f"SELECT movieId FROM {table} WHERE userId = ? AND "
            f"timestamp <= ? ORDER BY timestamp DESC LIMIT ?",
            (user_id, max_ts, max_len))
        return [int(r[0]) for r in cur.fetchall()]

    def pre_train(self, ctx: Context) -> None:
        """feature.go:255-296: rating aggregates + train ub-cache fill."""
        cur = self.db.execute(
            "SELECT movieId, avg(rating), count(rating) FROM ratings_train "
            "GROUP BY movieId")
        self.m_rating_map = {int(m): (float(a), float(c)) for m, a, c in cur}
        if self.ubc_train is None:
            self.ubc_train = UserBehaviorCache()
            self._fill_ub_cache(self.ubc_train, "ub_train")

    def pre_rank(self, ctx: Context) -> None:
        """prepare.go:116-126: fill predict-stage ub cache."""
        if self.ubc_predict is None:
            self.ubc_predict = UserBehaviorCache()
            self._fill_ub_cache(self.ubc_predict, "ub_test")

    def _fill_ub_cache(self, ubc: UserBehaviorCache, table: str) -> None:
        cur = self.db.execute(
            f"SELECT userId, movieIds, timestamps FROM {table}")
        for user_id, movie_ids, timestamps in cur:
            items = parse_int64_seq(movie_ids or "")
            ts = parse_int64_seq(timestamps or "")
            if len(items) != len(ts):
                continue
            ubc.set(int(user_id), ts=ts, items=items)

    # ----------------------------------------------------- dashboard hooks --
    def get_users_feature_overview(self, ctx: Context, offset: int,
                                   size: int, opts=None) -> dict:
        q = "SELECT userId, is_train FROM user"
        if size > 0:
            q += f" LIMIT {int(size)} OFFSET {int(offset)}"
        users = [{"user_id": int(u), "UserFeatures": {"is_train": bool(t)}}
                 for u, t in self.db.execute(q)]
        return {"users": users}

    def get_items_feature_overview(self, ctx: Context, offset: int,
                                   size: int, opts=None) -> dict:
        q = "SELECT movieId, title, genres FROM movies"
        if size > 0:
            q += f" LIMIT {int(size)} OFFSET {int(offset)}"
        items = [{"item_id": int(m),
                  "ItemFeatures": {"title": t, "generes": g}}
                 for m, t, g in self.db.execute(q)]
        return {"items": items}

    def get_dashboard_overview(self, ctx: Context) -> dict:
        """Dashboard counts (GetDashboardOverview parity,
        feature.go:358-384 + DTO keys the frontend reads,
        frontend/src/views/overview/index.vue). The reference returns the
        positive/negative fields but never fills them (they render as 0);
        here they are real: positive = rating > 3.5 (the label binarization
        threshold, feature.go:386-398). `rating_hist` is an addition feeding
        the dashboard's rating-distribution chart."""
        one = lambda q: int(self.db.execute(q).fetchone()[0])
        hist = [{"rating": float(r), "count": int(c)} for r, c in
                self.db.execute("SELECT rating, count(*) FROM ratings "
                                "GROUP BY rating ORDER BY rating")]
        return {
            "users": one("SELECT count(*) FROM user"),
            "items": one("SELECT count(*) FROM movies"),
            "total_positive":
                one("SELECT count(*) FROM ratings WHERE rating > 3.5"),
            "valid_positive":
                one("SELECT count(*) FROM ratings_train WHERE rating > 3.5"),
            "valid_negative":
                one("SELECT count(*) FROM ratings_train WHERE rating <= 3.5"),
            "rating_hist": hist,
        }

    def get_feature_distributions(self, ctx: Context, kind: str = "items",
                                  bins: int = 12, sample: int = 1000) -> dict:
        """Per-feature histograms over assembled feature vectors — the
        data source behind the dashboard's feature-distribution charts
        (the echarts views in the reference frontend,
        frontend/src/views/overview/index.vue). Scalar features get named
        columns; the 5×10 hash-one-hot genre blocks are summarized by their
        per-row active-bucket count instead of 50 near-constant columns."""
        if kind == "users":
            ids = [int(u) for (u,) in self.db.execute(
                f"SELECT userId FROM user LIMIT {int(sample)}")]
            feats = self.get_user_features_batch(ctx, ids)
            scalar_cols = {"avg_rating": 0, "cnt_rating": 1}
            genre_block = (2, 52)
        else:
            if not self.m_rating_map:
                self.pre_train(ctx)
            ids = [int(m) for (m,) in self.db.execute(
                f"SELECT movieId FROM movies LIMIT {int(sample)}")]
            feats = self.get_item_features_batch(ctx, ids)
            scalar_cols = {"year": 50, "avg_rating": 51, "cnt_rating": 52}
            genre_block = (0, 50)
        if not feats:
            return {"features": []}
        mat = np.stack(list(feats.values()))
        out = []
        for name, col in scalar_cols.items():
            v = mat[:, col]
            counts, edges = np.histogram(v, bins=bins)
            out.append({
                "feature": name,
                "buckets": [{"x": f"{edges[i]:.2g}", "count": int(c)}
                            for i, c in enumerate(counts)],
                "min": float(v.min()), "max": float(v.max()),
                "mean": float(v.mean()),
            })
        g0, g1 = genre_block
        active = (np.abs(mat[:, g0:g1]) > 1e-9).sum(axis=1)
        counts, edges = np.histogram(active, bins=min(bins, 10))
        out.append({
            "feature": "genre_active_dims",
            "buckets": [{"x": f"{edges[i]:.0f}", "count": int(c)}
                        for i, c in enumerate(counts)],
            "min": float(active.min()), "max": float(active.max()),
            "mean": float(active.mean()),
        })
        return {"features": out, "kind": kind, "sampled": int(mat.shape[0])}

    # -------------------------------------------------------------- eval ---
    def test_samples(self, limit: int = 0) -> list[Sample]:
        q = ("SELECT userId, movieId, rating, timestamp FROM ratings_test "
             "ORDER BY timestamp, userId")
        if limit:
            q += f" LIMIT {int(limit)}"
        return [Sample(user_id=int(u), item_id=int(m),
                       label=binarize_label(r), timestamp=int(t))
                for u, m, r, t in self.db.execute(q)]
