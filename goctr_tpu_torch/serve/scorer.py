"""Device-resident candidate scoring (port of goctr_tpu/serve/scorer.py).

The item table (plain [V, D], packed [V, 128] or grouped [L, 128] lines)
and the dense tower stay on the card; a request ships only its ids and
dense blocks:

    (user profile [U] f32, behavior ids [T] i32, ctx [C] f32,
     candidate ids [K] i32)

`score_batch` scores R requests × K candidates in one forward: one row
gather (kernel K1) of every behavior and candidate id, the behavior rows
broadcast to [R·K, T, D] as the JAX scorer does, the DIN pool (kernel
K2), the tower, and one copy of the scores to the host (the only
synchronisation of the batch). Shapes are padded to the same bucket
ladders as the JAX scorer.

Unlike the JAX scorer, a batch of more than `req_buckets[-1]` requests,
or a request of more than `cand_buckets[-1]` candidates, is split into
chunks that each fit the largest bucket; nothing is truncated. Device
work runs under one lock, on the current stream of the calling thread
(the default stream unless the caller sets one).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.ops.kernels.row_gather import gather_rows
from goctr_tpu_torch.ops.kernels.row_optimizer import LANES, group_size
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR


def _bucket(n: int, ladder: tuple[int, ...]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


@dataclasses.dataclass
class DeviceScorer:
    """Bucket-padded, layout-aware scorer over a resident table.

    Build via `from_scanned` (a TrainedScanned, plain or grouped table)
    or directly from (model, table). The model and the table are moved
    to `device` (a no-op when they are there already)."""
    model: SparseCTR
    table: torch.Tensor                 # resident; layout per fields below
    packed_group: int = 1               # >1: grouped [L, 128] lines
    table_packed: bool = False          # True: [V, 128] (w | acc | pad)
    cand_buckets: tuple[int, ...] = (128, 512, 2048)
    req_buckets: tuple[int, ...] = (1, 8, 32)
    device: str | torch.device = "cuda"

    @classmethod
    def from_scanned(cls, ranker, **kw) -> "DeviceScorer":
        """From parallel/scanned.TrainedScanned (plain or grouped table)."""
        return cls(model=ranker.model, table=ranker.table,
                   packed_group=ranker.packed_group, **kw)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model.to(self.device).eval()
        self.table = self.table.to(self.device)
        d = self.model.emb_dim
        if self.packed_group > 1:
            if (self.packed_group != group_size(d)
                    or self.table.shape[1] != LANES):
                raise ValueError(
                    f"grouped table must be [L, {LANES}] with G = "
                    f"{group_size(d)} for emb_dim {d}")
        elif self.table.shape[1] != (LANES if self.table_packed else d):
            raise ValueError(f"table width {self.table.shape[1]} does not "
                             f"match its layout (emb_dim {d})")
        self._lock = threading.Lock()

    # ---------------------------------------------------------- device --
    def rows_of(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows of `ids` ([n] int32 on the device) in the compute dtype:
        one launch of K1 for any layout."""
        return gather_rows(self.table, ids, group=self.packed_group,
                           dim=self.model.emb_dim,
                           out_dtype=self.model.compute_dtype)

    def _forward(self, prof: np.ndarray, bids: np.ndarray, ctx: np.ndarray,
                 iids: np.ndarray) -> torch.Tensor:
        """prof [R, U], bids [R, T] (-1 pad), ctx [R, C], iids [R, K]
        (-1 pad), all numpy → scores [R, K] on the device, 0 at pads."""
        dev = self.device
        R, K = iids.shape
        T = bids.shape[1]
        D = self.model.emb_dim
        bids_t = torch.from_numpy(bids).to(dev)
        iids_t = torch.from_numpy(iids).to(dev)
        ids = torch.cat([bids_t.reshape(-1), iids_t.reshape(-1)]).clamp_min(0)
        rows = self.rows_of(ids)
        emb_b = rows[:R * T].reshape(R, T, D)
        emb_i = rows[R * T:]                                   # [R*K, D]
        mask = (bids_t >= 0).float()
        # per-candidate DIN attention: (request, candidate) flattens into
        # the batch dim; the behavior broadcast is materialised, as in the
        # JAX scorer
        eb = emb_b[:, None].expand(R, K, T, D).reshape(R * K, T, D)
        mk = mask[:, None].expand(R, K, T).reshape(R * K, T)
        # (with R = 1 the reshapes are stride-0 views, which K2 refuses)
        eb, mk = eb.contiguous(), mk.contiguous()
        pr = torch.from_numpy(prof).to(dev)
        cx = torch.from_numpy(ctx).to(dev)
        pr = pr[:, None].expand(R, K, pr.shape[1]).reshape(R * K, -1)
        cx = cx[:, None].expand(R, K, cx.shape[1]).reshape(R * K, -1)
        logits = self.model.apply_pooled(pr, eb, emb_i, cx, mk)
        scores = torch.sigmoid(logits).reshape(R, K)
        return torch.where(iids_t >= 0, scores, 0.0)

    def _score_chunk(self, profiles, behavior_ids, ctx, cand_ids
                     ) -> list[np.ndarray]:
        """At most req_buckets[-1] requests of at most cand_buckets[-1]
        candidates each, in one forward."""
        R = len(cand_ids)
        k_max = max((len(c) for c in cand_ids), default=1)
        K = _bucket(k_max, self.cand_buckets)
        Rp = _bucket(R, self.req_buckets)
        iids = np.full((Rp, K), -1, np.int32)
        for r, c in enumerate(cand_ids):
            iids[r, :len(c)] = c

        def padr(a, dtype, fill=0):
            out = np.full((Rp,) + a.shape[1:], fill, dtype)
            out[:R] = a
            return out

        with self._lock, torch.inference_mode():
            out = self._forward(padr(profiles, np.float32),
                                padr(behavior_ids, np.int32, -1),
                                padr(ctx, np.float32), iids)
            out = out.cpu().numpy()
        return [out[r, :len(c)] for r, c in enumerate(cand_ids)]

    # ---------------------------------------------------------- scoring --
    def score_batch(self, profiles: np.ndarray, behavior_ids: np.ndarray,
                    ctx: np.ndarray, cand_ids: list[np.ndarray]
                    ) -> list[np.ndarray]:
        """R requests: profiles [R, U], behavior_ids [R, T] (-1 padded),
        ctx [R, C]; cand_ids = R int arrays (ragged). Returns R score
        arrays aligned with each request's candidates. Requests beyond
        the largest request bucket, and candidates beyond the largest
        candidate bucket, go to further forwards."""
        profiles = np.asarray(profiles)
        behavior_ids = np.asarray(behavior_ids)
        ctx = np.asarray(ctx)
        k_cap = self.cand_buckets[-1]
        pieces = []                     # (request, candidate slice)
        for r, c in enumerate(cand_ids):
            c = np.asarray(c, np.int32)
            pieces += [(r, c[s:s + k_cap])
                       for s in range(0, max(len(c), 1), k_cap)]
        outs: list[list[np.ndarray]] = [[] for _ in cand_ids]
        r_cap = self.req_buckets[-1]
        for s in range(0, len(pieces), r_cap):
            chunk = pieces[s:s + r_cap]
            rows = [r for r, _ in chunk]
            scores = self._score_chunk(profiles[rows], behavior_ids[rows],
                                       ctx[rows], [c for _, c in chunk])
            for (r, _), o in zip(chunk, scores):
                outs[r].append(o)
        return [np.concatenate(o) for o in outs]

    def score(self, profile: np.ndarray, behavior_ids: np.ndarray,
              ctx: np.ndarray, cand_ids: np.ndarray) -> np.ndarray:
        return self.score_batch(profile[None], behavior_ids[None],
                                ctx[None], [cand_ids])[0]


class MicroBatcher:
    """Coalesce concurrent rank requests into one device forward.

    Each server thread calls submit(); the first waiter becomes the
    flusher: it waits up to max_wait_s, or until max_requests are queued,
    then takes everything queued, scores it with one score_batch call and
    hands each waiter its result. An item is queued and the flusher is
    chosen under one lock, and the flusher takes the queue under that
    lock, so every item is taken by exactly one flusher. If scoring
    raises, every waiter of that batch raises too (none is left waiting).
    """

    def __init__(self, scorer: DeviceScorer, max_requests: int = 32,
                 max_wait_s: float = 0.004):
        self.scorer = scorer
        self.max_requests = max_requests
        self.max_wait_s = max_wait_s
        self._lock = threading.Lock()
        self._queue: list[dict] = []

    def submit(self, profile, behavior_ids, ctx, cand_ids) -> np.ndarray:
        item = {"profile": profile, "bids": behavior_ids, "ctx": ctx,
                "cands": np.asarray(cand_ids, np.int32),
                "ev": threading.Event(), "out": None, "err": None}
        with self._lock:
            self._queue.append(item)
            flusher = len(self._queue) == 1
            if len(self._queue) >= self.max_requests:
                self._queue[0]["ev"].set()      # wake the flusher early
        if flusher:
            item["ev"].wait(self.max_wait_s)    # let concurrent peers queue
            with self._lock:
                batch, self._queue = self._queue, []
            self._flush(batch)
        else:
            item["ev"].wait()                   # the flusher fills + signals
            if item["err"] is not None:
                raise RuntimeError("batched scoring failed") from item["err"]
        return item["out"]

    def _flush(self, batch: list[dict]) -> None:
        try:
            outs = self.scorer.score_batch(
                np.stack([b["profile"] for b in batch]),
                np.stack([b["bids"] for b in batch]),
                np.stack([b["ctx"] for b in batch]),
                [b["cands"] for b in batch])
        except Exception as e:
            for b in batch:
                b["err"] = e
                b["ev"].set()
            raise
        for b, o in zip(batch, outs):
            b["out"] = o
            b["ev"].set()


class ItemIdsOutsideTable(ValueError):
    """Candidate item ids outside [0, item_vocab): the table has no row for
    them (K1 would give a NaN row past the table, a negative id is a pad).
    `ids` lists them, in request order."""

    def __init__(self, ids: list[int], item_vocab: int):
        self.ids = ids
        super().__init__(f"item ids outside [0, {item_vocab}): {ids}")


@dataclasses.dataclass
class SparseRankPredictor:
    """Predictor-shaped adapter for serve/api.py over a DeviceScorer:
    holds host-side per-user state (profile rows, behavior cache, ctx) and
    answers rank(user_id, item_ids) by shipping ids to the device.
    Implements the `rank_direct` duck type RecApiServer routes to
    (api.go:106-131 semantics)."""
    scorer: DeviceScorer
    user_profiles: np.ndarray           # [n_users, U] f32
    user_behaviors: np.ndarray          # [n_users, T] i32, -1 padded
    default_ctx: np.ndarray             # [C] f32
    batcher: Optional[MicroBatcher] = None
    rec_sys: object = None              # dashboard endpoints (optional)

    def __post_init__(self):
        if self.batcher is None:
            self.batcher = MicroBatcher(self.scorer)

    def rank_direct(self, user_id: int, item_ids: list[int]
                    ) -> list[tuple[int, float]]:
        """Scores of `item_ids` for `user_id`; raises ItemIdsOutsideTable
        for ids outside [0, item_vocab)."""
        vocab = self.scorer.model.item_vocab
        bad = [i for i in item_ids if not 0 <= i < vocab]
        if bad:
            raise ItemIdsOutsideTable(bad, vocab)
        n_users = self.user_profiles.shape[0]
        uid = user_id if 0 <= user_id < n_users else 0
        scores = self.batcher.submit(self.user_profiles[uid],
                                     self.user_behaviors[uid],
                                     self.default_ctx,
                                     np.asarray(item_ids, np.int32))
        return [(int(i), float(s)) for i, s in zip(item_ids, scores)]
