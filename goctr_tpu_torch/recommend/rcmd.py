"""Recommendation orchestrator: the user-facing Train / Rank / BatchPredict
pipeline (port of goctr_tpu/recommend/rcmd.py, after the reference's
recommend/rcmd.go).

The contract mirrors the reference's interface-driven design (rcmd.go:72-182):
a user object implements `get_user_feature` / `get_item_feature` /
`sample_generator`, optionally `get_user_behavior`, `item_seq_generator`,
`pre_train`, `pre_rank` — composed by duck-typed hasattr checks, the Python
analogue of Go type assertions (rcmd.go:199,207,279,509).

Sample row layout (identical to rcmd.go:400-447):
    [ user_profile | behavior_emb (T×D) | item_emb (D) | item_raw→ctx ]
with ITEM_EMB_DIM=16, USER_BEHAVIOR_LEN=10 (rcmd.go:19-28). The reference's
16-goroutine assembly fan-out (rcmd.go:375-397) becomes a thread pool for
IO-bound feature fetches feeding one NumPy matrix; rows are assembled on
the host (native/), item2vec and the ranker train on `device`.

Differences from the JAX package, each on purpose:
- `RankerFitter(use_bf16=True)` sets `compute_dtype=torch.bfloat16`
  (False: float32); `fit` trains the port's models with the port's
  `train_ranker` on the fitter's device.
- `Train(..., device=)` hands its device to `train_embedding` and refuses
  a fitter made for another device. Both default to "cuda" and raise
  without a card.
- `LRUCache` takes a lock: the HTTP server ranks on many threads at once,
  and JAX's unlocked `in` then `move_to_end` raises KeyError when another
  thread evicts the key in between.
- An unknown user, or an unknown first item, raises `UnknownIdError` (a
  KeyError, as JAX raises) naming the id, so the HTTP API can answer 400.
"""
from __future__ import annotations

import dataclasses
import enum
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional, Protocol

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.embedding.store import EmbeddingMap, train_embedding
from goctr_tpu_torch.models.base import SampleInfo, TrainSample

log = logging.getLogger(__name__)

SAMPLE_ASSEMBLER = 16        # rcmd.go:20
ITEM_EMB_DIM = 16            # rcmd.go:22
ITEM_EMB_WINDOW = 5          # rcmd.go:23
USER_BEHAVIOR_LEN = 10       # rcmd.go:24
USER_FEATURE_CACHE_SIZE = 200_000
ITEM_FEATURE_CACHE_SIZE = 2_000_000

# Debug hooks (rcmd.go:43-44): set DEBUG_ITEM_ID (and optionally
# DEBUG_USER_ID; 0/-1 = any user) to log the assembled feature vector and
# score for matching (user, item) pairs during BatchPredict
# (rcmd.go:319-323,334).
DEBUG_USER_ID: int = 0
DEBUG_ITEM_ID: int = 0


class Stage(enum.Enum):
    TRAIN = 0
    PREDICT = 1


@dataclasses.dataclass
class Context:
    """Replaces Go's context.WithValue(StageKey, ...) stage routing."""
    stage: Stage = Stage.TRAIN
    values: dict = dataclasses.field(default_factory=dict)

    def with_stage(self, stage: Stage) -> "Context":
        return Context(stage=stage, values=self.values)


@dataclasses.dataclass
class Sample:
    user_id: int
    item_id: int
    label: float = 0.0
    timestamp: int = 0


@dataclasses.dataclass
class ItemScore:
    item_id: int
    score: float


class UnknownIdError(KeyError):
    """A request's user, or its first item, has no features (`kind` is
    "userId" or "itemId")."""

    def __init__(self, kind: str, id_: int):
        super().__init__(kind, id_)
        self.kind, self.id = kind, id_

    def __str__(self) -> str:
        return f"{self.kind} {self.id} not found"


class LRUCache:
    """Feature cache (replaces ccache, rcmd.go:344-353); safe to share
    between threads. `fn` runs outside the lock, so two threads that miss
    the same key may both compute it."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self._d: OrderedDict[Any, Any] = OrderedDict()
        self._lock = threading.Lock()

    def fetch(self, key, fn):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        v = fn()
        with self._lock:
            self._d[key] = v
            self._d.move_to_end(key)
            if len(self._d) > self.max_size:
                self._d.popitem(last=False)
        return v

    def peek(self, key):
        """The cached value or None, without touching its recency."""
        with self._lock:
            return self._d.get(key)

    def __len__(self):
        return len(self._d)

    def clear(self):
        with self._lock:
            self._d.clear()


# ---------------------------------------------------------------- fitters ---

class PredictAbstract(Protocol):
    def predict(self, x: np.ndarray) -> np.ndarray: ...


class RankerFitter:
    """Fitter building a DIN / YouTube-DNN / MLP ranker from the assembled
    sample (the counterpart of dinimpl.Fit / SimpleMlpFitWrap.Fit), trained
    on `device`."""

    def __init__(self, model_name: str = "mlp", trainer_config=None,
                 use_bf16: Optional[bool] = None, *,
                 device: str | torch.device = "cuda", **model_kw):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.trainer_config = trainer_config
        self.model_kw = model_kw
        if use_bf16 is not None and "compute_dtype" not in model_kw:
            self.model_kw["compute_dtype"] = (torch.bfloat16 if use_bf16
                                              else torch.float32)
        self.ranker = None

    def fit(self, sample: TrainSample):
        from goctr_tpu_torch.models import (
            DIN, MLPTower, YoutubeDNN, train_ranker)
        from goctr_tpu_torch.models.trainer import TrainerConfig

        info = sample.info
        up, t, d, it, cx = info.dims(USER_BEHAVIOR_LEN)
        name = self.model_name.lower()
        if name == "din":
            model = DIN(up, t, d, it, cx, **self.model_kw)
        elif name in ("youtube_dnn", "youtube", "ytdnn"):
            model = YoutubeDNN(up, t, d, it, cx, **self.model_kw)
        else:
            model = MLPTower(in_dim=sample.x_cols, **self.model_kw)
        cfg = self.trainer_config or TrainerConfig()
        self.ranker = train_ranker(model, sample, cfg, device=self.device)
        return self.ranker


# ----------------------------------------------------------- sample build ---

class _State:
    """Per-Train() mutable state (replaces reference package globals
    rcmd.go:30-45; kept instance-local so concurrent trains don't collide)."""

    def __init__(self):
        self.user_cache = LRUCache(USER_FEATURE_CACHE_SIZE)
        self.item_cache = LRUCache(ITEM_FEATURE_CACHE_SIZE)
        self.item_embedding_map: Optional[EmbeddingMap] = None


@dataclasses.dataclass
class Predictor:
    """Train() result: feature provider + fitted model (rcmd.go:232-243);
    `state` keeps Train's feature caches warm for serving (the reference
    reuses its package-level caches, rcmd.go:34-36)."""
    rec_sys: Any
    model: PredictAbstract
    item_embedding_map: Optional[EmbeddingMap] = None
    state: Optional[_State] = dataclasses.field(default=None, repr=False)


def _sample_info(u_width: int, i_width: int) -> SampleInfo:
    ub0 = u_width
    ub1 = ub0 + ITEM_EMB_DIM * USER_BEHAVIOR_LEN
    it1 = ub1 + ITEM_EMB_DIM
    return SampleInfo(
        user_profile_range=(0, u_width),
        user_behavior_range=(ub0, ub1),
        item_feature_range=(ub1, it1),    # embeddings only (rcmd.go:408-409)
        ctx_feature_range=(it1, it1 + i_width),  # raw item feats → ctx
    )


def get_sample_vector(ctx: Context, state: _State, rec_sys,
                      key: Sample) -> tuple[np.ndarray, int, int]:
    """One flat row (GetSampleVector rcmd.go:462-536): returns
    (vec, user_width, item_width)."""
    user = state.user_cache.fetch(
        key.user_id, lambda: np.asarray(
            rec_sys.get_user_feature(ctx, key.user_id), dtype=np.float32))
    item = state.item_cache.fetch(
        key.item_id, lambda: np.asarray(
            rec_sys.get_item_feature(ctx, key.item_id), dtype=np.float32))

    emb_map = state.item_embedding_map
    item_emb = np.zeros(ITEM_EMB_DIM, np.float32)
    behaviors = np.zeros(ITEM_EMB_DIM * USER_BEHAVIOR_LEN, np.float32)
    if emb_map:
        item_emb = emb_map.get_vec(str(key.item_id), ITEM_EMB_DIM)
        if hasattr(rec_sys, "get_user_behavior"):
            item_seq = rec_sys.get_user_behavior(
                ctx, key.user_id, USER_BEHAVIOR_LEN, -1, key.timestamp)
            for i, item_id in enumerate(item_seq[:USER_BEHAVIOR_LEN]):
                behaviors[i * ITEM_EMB_DIM:(i + 1) * ITEM_EMB_DIM] = \
                    emb_map.get_vec(str(item_id), ITEM_EMB_DIM)

    vec = np.concatenate([user, behaviors, item_emb, item])
    return vec, user.shape[0], item.shape[0]


def get_sample(rec_sys, ctx: Context,
               state: Optional[_State] = None) -> TrainSample:
    """Assemble the whole training matrix (GetSample rcmd.go:339-460).

    Fast path: providers exposing get_user_features_batch /
    get_item_features_batch get vectorized assembly (unique-id batch SQL +
    native gather-concat, dropping rows with missing features like the
    reference's per-sample skip, rcmd.go:385-388). Otherwise: threaded
    per-sample fetch mirroring the 16-goroutine fan-out.
    """
    state = state or _State()
    if (hasattr(rec_sys, "get_user_features_batch")
            and hasattr(rec_sys, "get_item_features_batch")):
        return _get_sample_vectorized(rec_sys, ctx, state)
    samples: Iterator[Sample] = rec_sys.sample_generator(ctx)

    rows: list[np.ndarray] = []
    labels: list[float] = []
    u_width = i_width = -1

    def assemble(s: Sample):
        try:
            return s, get_sample_vector(ctx, state, rec_sys, s)
        except Exception as e:     # drop bad samples (rcmd.go:385-388)
            log.debug("get sample vector error: %s", e)
            return s, None

    with ThreadPoolExecutor(max_workers=SAMPLE_ASSEMBLER) as pool:
        for s, res in pool.map(assemble, samples):
            if res is None:
                continue
            vec, uw, iw = res
            if u_width < 0:
                u_width, i_width = uw, iw
            elif uw != u_width or iw != i_width:
                raise ValueError(
                    f"feature width mismatch: user {uw}!={u_width} "
                    f"item {iw}!={i_width}")
            rows.append(vec)
            labels.append(s.label)

    if not rows:
        raise ValueError("no samples assembled")
    x = np.stack(rows)
    y = np.asarray(labels, dtype=np.float32)
    return TrainSample(x=x, y=y, info=_sample_info(u_width, i_width))


def _get_sample_vectorized(rec_sys, ctx: Context,
                           state: _State) -> TrainSample:
    if hasattr(rec_sys, "sample_generator_arrays"):
        # array fast path: the provider streams (uid, iid, label, ts)
        # columns directly — no per-row Sample objects at ML-20M scale
        uid, iid, y, ts = rec_sys.sample_generator_arrays(ctx)
        uid = np.asarray(uid, np.int64)
        iid = np.asarray(iid, np.int64)
        y = np.asarray(y, np.float32)
        ts = np.asarray(ts, np.int64)
    else:
        keys = list(rec_sys.sample_generator(ctx))
        if not keys:
            raise ValueError("no samples generated")
        uid = np.asarray([k.user_id for k in keys], np.int64)
        iid = np.asarray([k.item_id for k in keys], np.int64)
        y = np.asarray([k.label for k in keys], np.float32)
        ts = np.asarray([k.timestamp for k in keys], np.int64)
    if uid.size == 0:
        raise ValueError("no samples generated")
    users = _fetch_features_unique(
        ctx, state, rec_sys, np.unique(uid).tolist(), "user")
    items = _fetch_features_unique(
        ctx, state, rec_sys, np.unique(iid).tolist(), "item")
    # training drops rows whose features are missing (rcmd.go:385-388)
    _, u_rows = _feature_matrix(users)
    _, i_rows = _feature_matrix(items)
    keep = (u_rows(uid) > 0) & (i_rows(iid) > 0)
    dropped = int(uid.size - keep.sum())
    if dropped:
        log.debug("dropped %d samples with missing features", dropped)
        uid, iid, y, ts = uid[keep], iid[keep], y[keep], ts[keep]
    if uid.size == 0:
        raise ValueError("no samples assembled")
    x = _assemble_rows(ctx, state, rec_sys, uid, iid, ts, users, items)
    u_width = next(iter(users.values())).shape[0]
    i_width = next(iter(items.values())).shape[0]
    return TrainSample(x=x, y=y, info=_sample_info(u_width, i_width))


def _feature_matrix(feat: dict[int, np.ndarray]):
    """dict id→row → (mat [k+1, w] with zero row 0, rows_of(ids) vectorized
    lookup returning 1-based matrix rows, 0 for missing ids)."""
    k = len(feat)
    w = next(iter(feat.values())).shape[0] if k else 0
    ids = np.fromiter(feat.keys(), np.int64, count=k)
    order = np.argsort(ids)
    ids_sorted = ids[order]
    mat = np.zeros((k + 1, w), np.float32)
    vals = list(feat.values())
    for r, i in enumerate(order):
        mat[r + 1] = vals[i]

    def rows_of(query) -> np.ndarray:
        q = np.asarray(query, np.int64)
        if ids_sorted.size == 0:
            return np.zeros(q.shape, np.int64)
        pos = np.searchsorted(ids_sorted, q).clip(0, ids_sorted.size - 1)
        return np.where(ids_sorted[pos] == q, pos + 1, 0)

    return mat, rows_of


def _word_rows(words) -> tuple[Optional[np.ndarray], dict]:
    """Embedding words → (int64 id array for vectorized lookup or None if
    words aren't integer-like, str→1-based-row dict fallback)."""
    row_of = {w: r for r, w in enumerate(words, start=1)}
    try:
        int_words = np.asarray([int(w) for w in words], np.int64)
    except (ValueError, TypeError):
        int_words = None
    return int_words, row_of


def _assemble_rows(ctx, state, rec_sys, uid, iid, ts, users, items
                   ) -> np.ndarray:
    """Shared vectorized row materialization (training fast path and
    BatchPredict; zero row 0 backs missing ids). uid/iid/ts are parallel
    int64 arrays; behavior sequences resolve through the provider's
    `get_user_behaviors_bulk` (one vectorized call) when available, else
    the per-row `get_user_behavior` loop."""
    from goctr_tpu_torch.native.hashing import (
        gather_emb_rows_into, gather_rows_into)

    n = uid.shape[0]
    u_mat, u_rows = _feature_matrix(users)
    i_mat, i_rows = _feature_matrix(items)
    u_idx = u_rows(uid)
    i_idx = i_rows(iid)

    # assemble straight into the output matrix: no [n, 160]
    # behavior-embedding intermediate and no recopy of it
    u_w, i_w = u_mat.shape[1], i_mat.shape[1]
    ub0 = u_w
    ub1 = ub0 + ITEM_EMB_DIM * USER_BEHAVIOR_LEN
    it1 = ub1 + ITEM_EMB_DIM
    out = np.empty((n, it1 + i_w), np.float32)
    gather_rows_into(out, 0, u_mat, u_idx)
    gather_rows_into(out, it1, i_mat, i_idx)

    emb_map = state.item_embedding_map
    if not emb_map:
        out[:, ub0:it1] = 0.0
        return out
    words, emb_mat = emb_map.as_arrays()
    emb_mat = np.concatenate(
        [np.zeros((1, emb_mat.shape[1]), np.float32), emb_mat])
    int_words, row_of = _word_rows(words)
    if int_words is not None:
        max_w = int(int_words.max()) if int_words.size else 0
        if 0 <= max_w < 4_000_000:
            # dense id→row LUT: item ids are small dense ints in every
            # MovieLens-shaped catalogue, and direct indexing beats the
            # searchsorted path on the n×10 behavior lookup
            lut = np.zeros(max_w + 2, np.int64)
            lut[int_words] = np.arange(1, int_words.size + 1)

            def emb_rows_of(q):
                q = np.asarray(q, np.int64)
                return lut[q.clip(0, max_w + 1)]
        else:
            order = np.argsort(int_words)
            iw_sorted = int_words[order]

            def emb_rows_of(q):
                q = np.asarray(q, np.int64)
                pos = np.searchsorted(iw_sorted, q).clip(
                    0, iw_sorted.size - 1)
                return np.where(iw_sorted[pos] == q, order[pos] + 1, 0)

        item_emb_idx = emb_rows_of(iid)
    else:
        item_emb_idx = np.asarray(
            [row_of.get(str(i), 0) for i in iid.tolist()], np.int64)
    gather_rows_into(out, ub1, emb_mat, item_emb_idx)

    bulk = getattr(rec_sys, "get_user_behaviors_bulk", None)
    if bulk is not None and int_words is not None:
        beh_items = bulk(ctx, uid, ts, USER_BEHAVIOR_LEN)   # [n, L]
        beh_idx = np.where(beh_items >= 0,
                           emb_rows_of(beh_items.clip(0)), 0)
    elif hasattr(rec_sys, "get_user_behavior"):
        beh_idx = np.zeros((n, USER_BEHAVIOR_LEN), np.int64)
        seq_cache: dict[tuple, list] = {}
        uid_l, ts_l = uid.tolist(), ts.tolist()
        for r in range(n):
            ck = (uid_l[r], ts_l[r])
            seq = seq_cache.get(ck)
            if seq is None:
                seq = rec_sys.get_user_behavior(
                    ctx, uid_l[r], USER_BEHAVIOR_LEN, -1, ts_l[r])
                seq_cache[ck] = seq
            for j, item_id in enumerate(seq[:USER_BEHAVIOR_LEN]):
                beh_idx[r, j] = row_of.get(str(item_id), 0)
    else:
        beh_idx = np.zeros((n, USER_BEHAVIOR_LEN), np.int64)
    gather_emb_rows_into(out, ub0, emb_mat, beh_idx)
    return out


# ------------------------------------------------------------ entrypoints ---

def _same_device(a: torch.device, b: torch.device) -> bool:
    """"cuda" names the current card, so it matches "cuda:0"."""
    return a.type == b.type and (a.index == b.index
                                 or None in (a.index, b.index))


def Train(ctx: Context, rec_sys, fitter, *,
          device: str | torch.device = "cuda") -> Predictor:
    """Training pipeline (rcmd.go:196-246): PreTrain → item2vec (on
    `device`) → sample assembly (host) → fit (the fitter's device, which
    must be `device`)."""
    dev = resolve_device(device)
    fit_dev = getattr(fitter, "device", None)
    if fit_dev is not None and not _same_device(torch.device(fit_dev), dev):
        raise ValueError(f"the fitter trains on {fit_dev}, Train was asked "
                         f"for {dev}")
    ctx = ctx.with_stage(Stage.TRAIN)
    state = _State()

    if hasattr(rec_sys, "pre_train"):
        rec_sys.pre_train(ctx)

    if hasattr(rec_sys, "item_seq_generator"):
        t0 = time.perf_counter()
        seqs = rec_sys.item_seq_generator(ctx)
        state.item_embedding_map = train_embedding(
            seqs, window=ITEM_EMB_WINDOW, dim=ITEM_EMB_DIM, iters=1,
            device=dev)
        log.info("item2vec: %d embeddings in %.1fs",
                 len(state.item_embedding_map), time.perf_counter() - t0)

    sample = get_sample(rec_sys, ctx, state)
    log.info("start training with %d x %d samples", sample.rows,
             sample.x_cols)
    model = fitter.fit(sample)
    return Predictor(rec_sys=rec_sys, model=model,
                     item_embedding_map=state.item_embedding_map,
                     state=state)


def BatchPredict(ctx: Context, predictor: Predictor,
                 sample_keys: list[Sample]) -> np.ndarray:
    """Scores [n] (rcmd.go:277-337): PredictStage feature sourcing, PreRank
    hook, zero-fill for rows whose features fail after the first.

    Assembly is vectorized: features are fetched once per unique user/item
    (batch SQL when the provider implements get_*_features_batch), behavior
    embeddings resolve through one indexed gather, and rows materialize via
    the native gather-concat — in place of the reference's per-sample
    loop (rcmd.go:294-324)."""
    uid = np.asarray([k.user_id for k in sample_keys], np.int64)
    iid = np.asarray([k.item_id for k in sample_keys], np.int64)
    ts = np.asarray([k.timestamp for k in sample_keys], np.int64)
    return batch_predict_arrays(ctx, predictor, uid, iid, ts)


def batch_predict_arrays(ctx: Context, predictor: Predictor,
                         user_ids: np.ndarray, item_ids: np.ndarray,
                         timestamps: np.ndarray) -> np.ndarray:
    """BatchPredict over parallel id/ts columns — the array-native scoring
    entry (no per-row Sample objects; at the reference's own ML-20M eval
    protocol the test slice is 5.61M rows, dinimpl_test.go:55)."""
    ctx = ctx.with_stage(Stage.PREDICT)
    rec_sys = predictor.rec_sys
    if hasattr(rec_sys, "pre_rank"):
        rec_sys.pre_rank(ctx)

    state = predictor.state or _State()
    state.item_embedding_map = predictor.item_embedding_map
    uid = np.asarray(user_ids, np.int64)
    iid = np.asarray(item_ids, np.int64)
    ts = np.asarray(timestamps, np.int64)
    x = _assemble_batch(ctx, state, rec_sys, uid, iid, ts)
    scores = np.asarray(predictor.model.predict(x)).ravel()
    if DEBUG_ITEM_ID > 0:
        for i in np.flatnonzero(iid == DEBUG_ITEM_ID).tolist():
            if DEBUG_USER_ID in (0, -1, int(uid[i])):
                log.info("user %d: item %d: feature %s", uid[i],
                         iid[i], x[i].tolist())
                log.info("user %d: item %d: score %s", uid[i],
                         iid[i], scores[i])
    return scores


def _fetch_features_unique(ctx, state: _State, rec_sys, ids: list[int],
                           kind: str) -> dict[int, np.ndarray]:
    """id → feature row for unique ids, preferring the provider's batch
    method, caching every hit."""
    cache = state.user_cache if kind == "user" else state.item_cache
    single = getattr(rec_sys, f"get_{kind}_feature")
    batch = getattr(rec_sys, f"get_{kind}_features_batch", None)
    out: dict[int, np.ndarray] = {}
    missing: list[int] = []
    for i in ids:
        hit = cache.peek(i)
        if hit is not None:
            out[i] = hit
        else:
            missing.append(i)
    if missing and batch is not None:
        fetched = batch(ctx, missing)   # id → row (absent = failed)
        for i, row in fetched.items():
            row = np.asarray(row, dtype=np.float32)
            out[i] = row
            cache.fetch(i, lambda r=row: r)
        missing = [i for i in missing if i not in fetched]
    for i in missing:
        try:
            row = np.asarray(single(ctx, i), dtype=np.float32)
        except Exception as e:      # a failed row is zero-filled
            log.debug("%s feature fetch failed for %s: %s", kind, i, e)
            continue
        out[i] = row
        cache.fetch(i, lambda r=row: r)
    return out


def _assemble_batch(ctx: Context, state: _State, rec_sys,
                    uid: np.ndarray, iid: np.ndarray,
                    ts: np.ndarray) -> np.ndarray:
    users = _fetch_features_unique(
        ctx, state, rec_sys, np.unique(uid).tolist(), "user")
    items = _fetch_features_unique(
        ctx, state, rec_sys, np.unique(iid).tolist(), "item")
    if uid.size and int(uid[0]) not in users:
        raise UnknownIdError("userId", int(uid[0]))
    if iid.size and int(iid[0]) not in items:
        raise UnknownIdError("itemId", int(iid[0]))
    # rows with missing ids hit the zero row → reference zero-fill
    # semantics (rcmd.go:300-307)
    return _assemble_rows(ctx, state, rec_sys, uid, iid, ts, users, items)


def Rank(ctx: Context, predictor: Predictor, user_id: int,
         item_ids: list[int]) -> list[ItemScore]:
    """Score a candidate list for one user (rcmd.go:248-275)."""
    now = int(time.time())
    keys = [Sample(user_id=user_id, item_id=i, timestamp=now)
            for i in item_ids]
    scores = BatchPredict(ctx, predictor, keys)
    return [ItemScore(item_id=i, score=float(s))
            for i, s in zip(item_ids, scores)]
