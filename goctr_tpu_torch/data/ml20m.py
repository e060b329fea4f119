"""MovieLens-20M-statistics synthetic fixture, the quality-parity dataset
(the port's own copy of goctr_tpu/data/ml20m.py: the same draws from the
same scale, seed, knobs and oversample, so the same SQLite tables and the
same `<db>.cols.npz` column sidecar, table for table and array for
array; numpy and sqlite3 only).

The reference's headline numbers are three GAUCs on the real ML-20M
dataset (the reference's README.md:17,25,33; its harness
example/movielens/dinimpl_test.go: SampleCnt 14,400,000 train rows /
5,610,000 test rows, by-user 80/20 split per example/movielens/readme.md:
16-50). There is no dataset download, so this module generates a
deterministic dataset with ML-20M's *statistics* — 138k users, 26.7k
movies, 20M ratings, zipf item popularity, lognormal user activity,
half-star ratings with mean ≈ 3.5 — and a planted preference structure
whose signal tiers mirror what the real data rewards:

  * item quality  q_m — correlated with popularity, visible to models only
    through the item avg-rating/cnt features (noisy for rare movies);
  * static user taste — per-user sparse genre-preference weights, visible
    through the user top-5-genre × item-genre feature interaction;
  * drifting interest — a per-user Markov chain over preferred genres; the
    CURRENT interest boosts ratings of matching movies and is visible ONLY
    through the recent-behavior sequence (item2vec embeddings of the last
    10 rated movies) — the signal DIN's attention can exploit but a
    mean-pool (YouTube-DNN) blurs, reproducing the reference's
    DIN > MLP > YT-DNN ordering.

Everything is vectorized NumPy (a 20M-row generate takes minutes, not hours)
and lands in the same SQLite schema as data/fixture.py, so the full
reference protocol (PreTrain → item2vec → assembly → train → GAUC) runs
unchanged on top (scripts/parity_ml20m_torch.py).
"""
from __future__ import annotations

import dataclasses
import sqlite3
import time
from pathlib import Path

import numpy as np

GENRES_18 = [
    "Action", "Adventure", "Animation", "Children", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]

# ML-20M full-scale shape (movielens README / grouplens stats)
ML20M_USERS = 138_493
ML20M_MOVIES = 26_744
ML20M_RATINGS = 20_000_263


@dataclasses.dataclass
class SignalKnobs:
    """Generative-model strengths. Defaults calibrated (the JAX package's
    scripts/parity_ml20m.py --calibrate) so the pipeline's GAUCs land in the
    reference's published band (MLP 0.771 / YT 0.760 / DIN 0.791)."""
    mu0: float = 3.78          # base rating level (→ P(rating>3.5) ≈ 0.45)
    sb: float = 0.35           # user harshness spread
    sq: float = 0.50           # item quality spread (idiosyncratic part)
    qpop: float = 0.25         # quality-popularity correlation strength
    alpha: float = 0.55        # static genre-taste match strength
    beta: float = 0.55         # CURRENT-interest match strength (behavior)
    noise: float = 0.95        # per-rating noise
    p_stay: float = 0.85       # interest Markov chain stickiness
    p_follow: float = 0.70     # P(watch from current interest genre)
    # item popularity law. s=0.55 reproduces ML-20M's top-item share
    # (~0.33% of all ratings): for bounded zipf, p(rank 1) ≈ (1-s)/V^(1-s);
    # s≥1 would make the top movie 3-15% of traffic — nothing like the
    # real catalogue. (s must be != 1 for the closed-form inverse CDF.)
    zipf_s: float = 0.55
    # --- item-level taste chaining: the attention-shaped signal ----------
    # Movies carry unit latent taste vectors (genre anchor + idiosyncratic);
    # with prob p_chain a user's next movie is a random walk step among the
    # previous movie's K nearest latent neighbors, and the rating earns
    # beta_item * max_{i<=chain_w} cos(v_prev_i, v_cand). A candidate-
    # specific MAX-similarity against recent behaviors is what DIN's cosine
    # attention computes natively and a flat MLP can only approximate with
    # bilinear features — the structural reason DIN > MLP on the real data
    # (genre-level drift alone is flat-learnable: measured MLP 0.782 >
    # DIN 0.751 before this signal existed).
    p_chain: float = 0.35
    beta_item: float = 0.9
    chain_k: int = 20          # latent-NN fanout of the walk
    chain_w: int = 5           # how many previous watches the bonus sees
    latent_dim: int = 8
    latent_genre_w: float = 0.8  # genre anchor weight in the latent mix
    # sharpening threshold for the max-sim bonus: m_item =
    # clip((maxsim - thr) / (1 - thr), 0, 1). 0 = r4 behavior. A higher
    # thr makes the bonus bimodal (chained watches score ~1, random pairs
    # ~0), widening the attention-oracle vs pooled-oracle AUC gap — the
    # property the reference's real data evidently has (DIN +0.019 over
    # MLP, README.md:17,33) and the r4 fixture lacked (VERDICT r4 #1).
    item_thr: float = 0.0
    act_mu: float = 4.35       # user activity lognormal (ML-20M mean ≈ 144)
    act_sigma: float = 0.95


def _bounded_zipf(rng, shape, n_ranks, s):
    """Closed-form inverse-CDF bounded zipf ranks in [0, n_ranks);
    n_ranks may be a per-row array (vectorized pools)."""
    u = rng.random(shape)
    nr = np.asarray(n_ranks, np.float64)
    t = nr ** (1.0 - s)
    x = (1.0 - u * (1.0 - t)) ** (1.0 / (1.0 - s))
    return np.minimum(x.astype(np.int64) - 1, (nr - 1).astype(np.int64)) \
        .clip(0)


def _fill_forward(values: np.ndarray, fresh: np.ndarray) -> np.ndarray:
    """values where fresh, else the most recent fresh value before it.
    Every block start must be fresh (guaranteed by callers)."""
    idx = np.where(fresh, np.arange(values.shape[0]), -1)
    np.maximum.accumulate(idx, out=idx)
    return values[idx]


def build_derived_tables(cur) -> None:
    """user split + user_feature_{train,test} + ub_{train,test} from an
    existing `ratings`/`movies`/`user` table set — the by-user 80/20 SQL
    protocol of the reference's example/movielens/readme.md:16-50 (the
    same SQL as data/fixture.py's small fixture)."""
    for name, flag in (("ratings_train", 1), ("ratings_test", 0)):
        cur.execute(
            f"CREATE TABLE {name} AS SELECT r.userId, movieId, rating, "
            f"timestamp FROM ratings r LEFT JOIN user u ON "
            f"r.userId = u.userId WHERE is_train = {flag}")
    for suffix, src in (("train", "ratings_train"), ("test", "ratings_test")):
        cur.execute(
            f"CREATE TABLE user_feature_{suffix} AS "
            f"SELECT r.userId, group_concat(m.genres) ugenres, "
            f"avg(r.rating) avgRating, count(r.rating) cntRating "
            f"FROM {src} r JOIN movies m ON r.movieId = m.movieId "
            f"GROUP BY r.userId")
    for suffix, src in (("train", "ratings_train"), ("test", "ratings_test")):
        cur.execute(
            f"CREATE TABLE ub_{suffix} AS "
            f"SELECT userId, group_concat(movieId) movieIds, "
            f"group_concat(timestamp) timestamps FROM "
            f"(SELECT userId, movieId, timestamp FROM {src} "
            f" ORDER BY userId, timestamp DESC) GROUP BY userId")


def generate_ml20m_fixture(path: str | Path, scale: float = 1.0,
                           seed: int = 7, train_frac: float = 0.8,
                           knobs: SignalKnobs | None = None,
                           oversample: float = 1.25,
                           verbose: bool = False,
                           debug_signals: str | None = None) -> dict:
    """Generate the scaled fixture; returns summary stats. scale=1.0 is the
    full ML-20M shape (users/movies/ratings all scale together so per-user
    and per-movie count distributions stay invariant — what the feature
    noise model depends on). `oversample` inflates the pre-dedup draw count
    to compensate for dropped duplicate (u,m) pairs (each user rates a
    movie once); smaller scales collide more (fewer movies per user draw),
    so calibration runs may pass 2.0."""
    k = knobs or SignalKnobs()
    path = Path(path)
    if path.exists():
        path.unlink()
    rng = np.random.default_rng(seed)
    n_users = max(int(ML20M_USERS * scale), 50)
    n_movies = max(int(ML20M_MOVIES * scale), 100)
    n_target = int(ML20M_RATINGS * scale * oversample)
    G = len(GENRES_18)
    t0 = time.perf_counter()

    def say(msg):
        if verbose:
            print(f"[ml20m +{time.perf_counter() - t0:6.1f}s] {msg}",
                  flush=True)

    # ---- movies ---------------------------------------------------------
    # primary genre skewed (Drama/Comedy-heavy, like the real catalogue)
    g_skew = (np.arange(G) + 1.0) ** -0.7
    g_perm = rng.permutation(G)
    g_probs = g_skew[np.argsort(g_perm)] / g_skew.sum()
    primary = rng.choice(G, n_movies, p=g_probs)
    extra1 = rng.integers(0, G, n_movies)
    extra2 = rng.integers(0, G, n_movies)
    has1 = rng.random(n_movies) < 0.55
    has2 = rng.random(n_movies) < 0.18
    year = (1930 + (85 * rng.beta(5.0, 2.0, n_movies))).astype(np.int64)
    # popularity ranks: random permutation; quality correlated with rank
    pop_rank_of_movie = rng.permutation(n_movies)     # 0 = hottest
    movie_of_rank = np.argsort(pop_rank_of_movie)
    zpop = -np.log(pop_rank_of_movie + 2.0)
    zpop = (zpop - zpop.mean()) / zpop.std()
    quality = k.qpop * zpop + rng.normal(0, k.sq, n_movies)

    # per-genre popularity-ordered pools (primary genre membership)
    pool_len = np.bincount(primary, minlength=G)
    max_pool = int(pool_len.max())
    pools = np.zeros((G, max_pool), np.int64)
    for g in range(G):
        members = np.flatnonzero(primary == g)
        members = members[np.argsort(pop_rank_of_movie[members])]
        pools[g, :members.size] = members
    say(f"movies: {n_movies} (max pool {max_pool})")

    # latent taste vectors + K-NN neighbor lists (the chain-walk graph)
    anchors = rng.normal(0, 1, (G, k.latent_dim))
    v_lat = (k.latent_genre_w * anchors[primary]
             + rng.normal(0, 0.6, (n_movies, k.latent_dim)))
    v_lat /= np.linalg.norm(v_lat, axis=1, keepdims=True)
    K = min(k.chain_k, n_movies - 1)
    nbrs = np.empty((n_movies, K), np.int64)
    chunk = max(1, int(2e8 / max(n_movies, 1)))       # ~200M sims per block
    for s in range(0, n_movies, chunk):
        e = min(s + chunk, n_movies)
        sims = v_lat[s:e] @ v_lat.T
        sims[np.arange(e - s), np.arange(s, e)] = -np.inf
        nbrs[s:e] = np.argpartition(sims, -K, axis=1)[:, -K:]
    say(f"latent K-NN graph built (K={K})")

    # ---- users ----------------------------------------------------------
    counts = np.exp(rng.normal(k.act_mu, k.act_sigma, n_users))
    counts = np.clip(counts, 20, 6000)
    counts = np.maximum((counts * (n_target / counts.sum())).astype(np.int64),
                        15)
    n = int(counts.sum())
    b_u = rng.normal(0, k.sb, n_users)
    # 3 distinct preferred genres per user, aggregate demand skewed
    pref_g = np.empty((n_users, 3), np.int64)
    pref_g[:, 0] = rng.choice(G, n_users, p=g_probs)
    pref_g[:, 1] = (pref_g[:, 0] + rng.integers(1, G, n_users)) % G
    pref_g[:, 2] = (pref_g[:, 0] + rng.integers(1, G, n_users)) % G
    pref_w = rng.dirichlet([2.2, 1.0, 0.7], n_users)  # [U, 3] desc-ish
    say(f"users: {n_users}, ratings target {n}")

    # ---- per-rating draws ----------------------------------------------
    user_of = np.repeat(np.arange(n_users), counts)
    block_start = np.zeros(n, bool)
    block_start[np.cumsum(counts)[:-1]] = True
    block_start[0] = True

    # timestamps: per-user start in [2000, 2015), gaps ~ hours..weeks
    start_ts = rng.integers(946_684_800, 1_420_070_400, n_users)
    gaps = rng.exponential(2.0 * 86400, n).astype(np.int64) + 60
    cum = np.cumsum(gaps)
    base = _fill_forward(cum - gaps, block_start)      # cum before block
    ts = start_ts[user_of] + (cum - gaps - base)
    say("timestamps done")

    # interest chain over the user's 3 preferred genres
    fresh = block_start | (rng.random(n) >= k.p_stay)
    u3 = rng.random(n)
    cw = np.cumsum(pref_w, axis=1)[user_of]           # [n, 3]
    slot = (u3[:, None] > cw).sum(axis=1).clip(0, 2)
    interest = _fill_forward(pref_g[user_of, slot], fresh)
    say("interest chain done")

    # movie choice: independent draws (interest-genre pool or global zipf)
    follow = rng.random(n) < k.p_follow
    plen = pool_len[interest]
    r_pool = _bounded_zipf(rng, n, np.maximum(plen, 1), k.zipf_s)
    m_follow = pools[interest, r_pool]
    r_glob = _bounded_zipf(rng, n, n_movies, k.zipf_s)
    m_glob = movie_of_rank[r_glob]
    movie = np.where(follow & (plen > 0), m_follow, m_glob)

    # chain walk: positions with chain=True replace their draw with a
    # random latent-NN step from the previous position's movie. Chains are
    # sequential by nature; vectorize by resolving depth-by-depth (depth =
    # distance to the last independent draw; geometric, so max depth is
    # small even at 20M rows).
    chain = (rng.random(n) < k.p_chain) & ~block_start
    step_pick = rng.integers(0, K, n)
    nonchain_pos = np.where(~chain, np.arange(n), -1)
    np.maximum.accumulate(nonchain_pos, out=nonchain_pos)
    depth = np.arange(n) - nonchain_pos
    max_depth = int(depth.max()) if n else 0
    for d in range(1, max_depth + 1):
        at = np.flatnonzero(depth == d)
        movie[at] = nbrs[movie[at - 1], step_pick[at]]
    say(f"movie choice done (chain max depth {max_depth})")

    # dedup (u, m): keep first occurrence, preserve order
    key = user_of.astype(np.int64) * n_movies + movie
    _, first_idx = np.unique(key, return_index=True)
    keep = np.zeros(n, bool)
    keep[first_idx] = True
    say(f"dedup: dropped {n - keep.sum()} duplicate (u,m) pairs")

    user_of, movie, ts, interest = (a[keep] for a in
                                    (user_of, movie, ts, interest))
    n = user_of.shape[0]

    # rating — computed on the KEPT rows so the max-similarity bonus sees
    # exactly the watch history the model's behavior sequence will see
    m_static = np.where(primary[movie] == pref_g[user_of, 0],
                        pref_w[user_of, 0],
                        np.where(primary[movie] == pref_g[user_of, 1],
                                 pref_w[user_of, 1],
                                 np.where(primary[movie] == pref_g[user_of, 2],
                                          pref_w[user_of, 2], 0.0)))
    m_recent = (primary[movie] == interest).astype(np.float64)
    # max cosine similarity of the candidate vs the previous chain_w
    # watches of the same user (the attention-shaped signal)
    vm = v_lat[movie]
    maxsim = np.full(n, -1.0)
    simsum = np.zeros(n)
    simcnt = np.zeros(n)
    for i in range(1, k.chain_w + 1):
        sim_i = np.full(n, -1.0)
        same_user = user_of[i:] == user_of[:-i]   # blocks are contiguous
        sim_i[i:] = np.where(same_user,
                             np.einsum("ij,ij->i", vm[i:], vm[:-i]), -1.0)
        np.maximum(maxsim, sim_i, out=maxsim)
        valid = sim_i > -1.0
        simsum += np.where(valid, sim_i, 0.0)
        simcnt += valid
    meansim = simsum / np.maximum(simcnt, 1.0)    # pooled-oracle's view
    m_item = np.clip((maxsim - k.item_thr) / (1.0 - k.item_thr), 0.0, 1.0)
    rstar = (k.mu0 + b_u[user_of] + quality[movie]
             + k.alpha * (m_static - m_static.mean())
             + k.beta * (m_recent - m_recent.mean())
             + k.beta_item * (m_item - m_item.mean())
             + rng.normal(0, k.noise, n))
    rating = np.clip(np.round(rstar * 2.0) / 2.0, 0.5, 5.0)
    if debug_signals is not None:
        np.savez(debug_signals, user=user_of + 1, movie=movie + 1, ts=ts,
                 rating=rating, m_item=m_item, m_static=m_static,
                 m_recent=m_recent, quality=quality[movie],
                 b_u=b_u[user_of], maxsim=maxsim, meansim=meansim)
    say(f"ratings: {n}, mean {rating.mean():.3f}, "
        f"P(>3.5) {(rating > 3.5).mean():.3f}")

    # ---- SQLite ---------------------------------------------------------
    conn = sqlite3.connect(path)
    cur = conn.cursor()
    cur.execute("PRAGMA journal_mode=OFF")
    cur.execute("PRAGMA synchronous=OFF")
    cur.execute("PRAGMA cache_size=-2000000")
    cur.execute("PRAGMA temp_store=MEMORY")

    cur.execute("CREATE TABLE movies (movieId INTEGER, title TEXT, "
                "genres TEXT)")
    names = np.asarray(GENRES_18)
    gstr = []
    for m in range(n_movies):
        gs = [names[primary[m]]]
        if has1[m] and extra1[m] != primary[m]:
            gs.append(names[extra1[m]])
        if has2[m] and extra2[m] not in (primary[m], extra1[m]):
            gs.append(names[extra2[m]])
        gstr.append("|".join(gs))
    cur.executemany(
        "INSERT INTO movies VALUES (?,?,?)",
        [(m + 1, f"Movie {m + 1} ({year[m]})", gstr[m])
         for m in range(n_movies)])
    say("movies table written")

    cur.execute("CREATE TABLE ratings (userId INTEGER, movieId INTEGER, "
                "rating FLOAT, timestamp INTEGER)")
    uid_l = (user_of + 1).tolist()
    mid_l = (movie + 1).tolist()
    r_l = rating.tolist()
    ts_l = ts.tolist()
    step = 1_000_000
    for s in range(0, n, step):
        cur.executemany(
            "INSERT INTO ratings VALUES (?,?,?,?)",
            zip(uid_l[s:s + step], mid_l[s:s + step], r_l[s:s + step],
                ts_l[s:s + step]))
    del uid_l, mid_l, r_l, ts_l
    say("ratings table written")

    n_train_users = int(n_users * train_frac)
    is_train = np.zeros(n_users, np.int64)
    is_train[rng.permutation(n_users)[:n_train_users]] = 1
    cur.execute("CREATE TABLE user (userId INTEGER, is_train INTEGER)")
    cur.executemany("INSERT INTO user VALUES (?,?)",
                    zip(range(1, n_users + 1), is_train.tolist()))
    say("user split written")

    build_derived_tables(cur)
    say("derived tables (train/test, user_feature, ub) written")
    cur.execute("CREATE INDEX idx_rt_user ON ratings_train(userId)")
    cur.execute("CREATE INDEX idx_rs_user ON ratings_test(userId)")
    conn.commit()
    conn.close()
    # column sidecar: the (ts, userId)-ordered train/test rating columns
    # as npz — the SQL cursor read of 14.4M rows through Python tuples
    # measured 117 s at full scale (BENCH_NOTES r5 assembly profile);
    # consumers (MovielensRec.sample_generator_arrays, parity test slice)
    # use the sidecar when present, SQL otherwise
    tr_mask = is_train[user_of] == 1
    cols = {}
    for nm, m in (("train", tr_mask), ("test", ~tr_mask)):
        o = np.lexsort((user_of[m], ts[m]))
        cols[f"{nm}_uid"] = (user_of[m][o] + 1).astype(np.int64)
        cols[f"{nm}_iid"] = (movie[m][o] + 1).astype(np.int64)
        cols[f"{nm}_rating"] = rating[m][o].astype(np.float32)
        cols[f"{nm}_ts"] = ts[m][o].astype(np.int64)
    np.savez(str(path) + ".cols.npz", **cols)
    say("column sidecar written")
    return {
        "n_users": n_users, "n_movies": n_movies, "n_ratings": int(n),
        "pos_rate": float((rating > 3.5).mean()),
        "mean_rating": float(rating.mean()),
        "train_users": n_train_users,
        "wall_s": round(time.perf_counter() - t0, 1),
    }
