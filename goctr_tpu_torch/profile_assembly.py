"""Host sample-assembly profiler of the port (the counterpart of the JAX
repository's scripts/profile_assembly.py: its stages, their labels and
order, its lines).

    python3 -m goctr_tpu_torch.profile_assembly --db=<fixture.db>
        [--cnt=1440000] [--fake-emb] [--cpu]

Stage-times the training sample assembly on a fixture database: the SQL
aggregates of pre_train, the item2vec map (one iteration, trained on the
card; `--fake-emb`: random vectors instead, no training), the sample
read, the user and item feature fetches, the feature matrices, the
embedding rows and the behaviors, and the direct assembly into the
[rows, width] f32 matrix through the native gathers. Prints one line a
stage and, last, `rows N  width W  total Ts (R rows/s)`.

Runs on the card unless given --cpu; without a card and without --cpu it
exits 2. Only the item2vec stage uses the device.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from goctr_tpu_torch.data.movielens import MovielensRec
from goctr_tpu_torch.embedding.store import EmbeddingMap, train_embedding
from goctr_tpu_torch.native.hashing import (
    gather_emb_rows_into, gather_rows_into)
from goctr_tpu_torch.recommend import rcmd
from goctr_tpu_torch.recommend.rcmd import (
    Context, Stage, _feature_matrix, _fetch_features_unique, _State)

VALUE_FLAGS = {"db": None, "cnt": "1440000"}
SWITCHES = ("fake-emb", "cpu")


def fake_embedding_map(rec: MovielensRec) -> EmbeddingMap:
    """Random ITEM_EMB_DIM vectors, default_rng(0), one a movie in the
    movies table's order (the JAX script's `--fake-emb` map)."""
    mids = [r[0] for r in rec.db.execute("SELECT movieId FROM movies")]
    rng = np.random.default_rng(0)
    return EmbeddingMap({str(m): rng.standard_normal(
        rcmd.ITEM_EMB_DIM).astype(np.float32) for m in mids})


def profile(db: str, cnt: int = 1_440_000, fake_emb: bool = False,
            device: str | torch.device = "cuda", say=print):
    """Assemble the training matrix of the first `cnt` samples of `db`
    stage by stage, each stage's seconds (rounded to 10 ms, as the JAX
    script keeps them) printed by `say` as it ends. Returns (the [n, W]
    f32 matrix, {stage label: seconds})."""
    rec = MovielensRec(db, sample_cnt=cnt)
    ctx = Context(stage=Stage.TRAIN)
    state = _State()
    stages: dict[str, float] = {}

    class clock:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t = time.perf_counter()

        def __exit__(self, *exc):
            stages[self.name] = round(time.perf_counter() - self.t, 2)
            say(f"  {self.name:24s} {stages[self.name]:8.2f}s")

    with clock("pre_train (SQL aggregates)"):
        rec.pre_train(ctx)
    if fake_emb:
        with clock("fake emb map"):
            state.item_embedding_map = fake_embedding_map(rec)
    else:
        with clock("item2vec (1 iter)"):
            state.item_embedding_map = train_embedding(
                rec.item_seq_generator(ctx), window=rcmd.ITEM_EMB_WINDOW,
                dim=rcmd.ITEM_EMB_DIM, iters=1, device=device)
    with clock("sample_generator (SQL read)"):
        uid, iid, _, ts = rec.sample_generator_arrays(ctx)
        uid = np.asarray(uid, np.int64)
        iid = np.asarray(iid, np.int64)
        ts = np.asarray(ts, np.int64)
    n = uid.size
    with clock("fetch user features"):
        users = _fetch_features_unique(ctx, state, rec,
                                       np.unique(uid).tolist(), "user")
    with clock("fetch item features"):
        items = _fetch_features_unique(ctx, state, rec,
                                       np.unique(iid).tolist(), "item")
    with clock("feature matrices + idx"):
        u_mat, u_rows = _feature_matrix(users)
        i_mat, i_rows = _feature_matrix(items)
        u_idx = u_rows(uid)
        i_idx = i_rows(iid)
    with clock("emb map as_arrays"):
        words, emb_mat = state.item_embedding_map.as_arrays()
        emb_mat = np.concatenate(
            [np.zeros((1, emb_mat.shape[1]), np.float32), emb_mat])
        int_words = np.asarray([int(w) for w in words], np.int64)
        order = np.argsort(int_words)
        iw_sorted = int_words[order]

        def emb_rows_of(q):
            q = np.asarray(q, np.int64)
            pos = np.searchsorted(iw_sorted, q).clip(0, iw_sorted.size - 1)
            return np.where(iw_sorted[pos] == q, order[pos] + 1, 0)
    with clock("item emb gather"):
        emb_mat[emb_rows_of(iid)]
    with clock("behaviors bulk_get"):
        beh_items = rec.get_user_behaviors_bulk(ctx, uid, ts,
                                                rcmd.USER_BEHAVIOR_LEN)
    with clock("behavior emb idx"):
        beh_idx = np.where(beh_items >= 0,
                           emb_rows_of(beh_items.clip(0)), 0)
    with clock("direct assembly (r5 C paths)"):
        u_w, i_w = u_mat.shape[1], i_mat.shape[1]
        ub0 = u_w
        ub1 = ub0 + rcmd.ITEM_EMB_DIM * rcmd.USER_BEHAVIOR_LEN
        it1 = ub1 + rcmd.ITEM_EMB_DIM
        x = np.empty((n, it1 + i_w), np.float32)
        gather_rows_into(x, 0, u_mat, u_idx)
        gather_rows_into(x, it1, i_mat, i_idx)
        gather_rows_into(x, ub1, emb_mat, emb_rows_of(iid))
        gather_emb_rows_into(x, ub0, emb_mat, beh_idx)
    return x, stages


def summary(x: np.ndarray, stages: dict) -> str:
    """The JAX script's last line."""
    n, total = x.shape[0], sum(stages.values())
    return (f"rows {n}  width {x.shape[1]}  total {total:.1f}s  "
            f"({n / max(total, 1e-9):,.0f} rows/s)")


def parse(argv: list[str]) -> tuple[dict, set]:
    """(--name=value flags with their defaults, switches); raises
    ValueError naming an unknown argument or a missing --db."""
    flags, switches = dict(VALUE_FLAGS), set()
    for a in argv:
        name, eq, value = a.removeprefix("--").partition("=")
        if a.startswith("--") and not eq and name in SWITCHES:
            switches.add(name)
        elif a.startswith("--") and eq and name in VALUE_FLAGS:
            flags[name] = value
        else:
            raise ValueError(f"unknown argument {a!r}")
    if flags["db"] is None:
        raise ValueError("--db=<fixture.db> required")
    return flags, switches


def main(argv: list[str]) -> int:
    try:
        flags, switches = parse(argv)
        cnt = int(flags["cnt"])
    except ValueError as e:
        print(f"profile_assembly: {e}", file=sys.stderr)
        return 2
    cpu = "cpu" in switches
    if not cpu and not torch.cuda.is_available():
        print("profile_assembly: torch.cuda.is_available() is False; pass "
              "--cpu to run on the CPU", file=sys.stderr)
        return 2
    x, stages = profile(flags["db"], cnt, "fake-emb" in switches,
                        "cpu" if cpu else "cuda",
                        say=lambda m: print(m, flush=True))
    print(summary(x, stages), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
