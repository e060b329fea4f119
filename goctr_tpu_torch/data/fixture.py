"""Deterministic synthetic MovieLens-shaped SQLite fixture (port of
goctr_tpu/data/fixture.py: the same draws from the same seed, so the same
database, table for table and row for row).

The reference's integration tests require a downloaded movielens.db
(example/movielens/readme.md:5-13). For hermetic tests this generates one
with the exact table set the example app queries — ratings /
ratings_train / ratings_test (80/20 by-user split, readme.md:16-50),
movies, user, user_feature_{train,test}, ub_{train,test} (prepare.go:70-113
SQL) — from a planted preference model: each user has a favorite genre;
rating ~ 4-5 for favorite-genre movies, 1-4 otherwise, so learnable signal
exists and AUC assertions are meaningful.
"""
from __future__ import annotations

import sqlite3
from pathlib import Path

import numpy as np

GENRES = ["Action", "Adventure", "Animation", "Comedy", "Crime", "Drama",
          "Fantasy", "Horror", "Romance", "Sci-Fi", "Thriller", "War"]


def generate_movielens_fixture(path: str | Path, n_users: int = 300,
                               n_movies: int = 500, n_ratings: int = 20000,
                               seed: int = 7, train_frac: float = 0.8) -> None:
    path = Path(path)
    if path.exists():
        path.unlink()
    rng = np.random.default_rng(seed)
    conn = sqlite3.connect(path)
    cur = conn.cursor()

    # ---- movies ----------------------------------------------------------
    cur.execute("CREATE TABLE movies (movieId INTEGER, title TEXT, "
                "genres TEXT)")
    movie_genre = rng.integers(0, len(GENRES), n_movies)
    for m in range(1, n_movies + 1):
        g1 = GENRES[movie_genre[m - 1]]
        extra = rng.integers(0, len(GENRES))
        genres = g1 if extra == movie_genre[m - 1] else f"{g1}|{GENRES[extra]}"
        year = 1950 + int(rng.integers(0, 70))
        cur.execute("INSERT INTO movies VALUES (?,?,?)",
                    (m, f"Movie {m} ({year})", genres))

    # ---- ratings (planted preference) ------------------------------------
    cur.execute("CREATE TABLE ratings (userId INTEGER, movieId INTEGER, "
                "rating FLOAT, timestamp INTEGER)")
    user_fav = rng.integers(0, len(GENRES), n_users)
    # users watch (and rate) their favorite genre more — without this skew
    # the per-user genre aggregates would carry no preference signal
    by_genre = [np.flatnonzero(movie_genre == g) + 1
                for g in range(len(GENRES))]
    seen: set[tuple[int, int]] = set()
    t = 800_000_000
    inserted = 0
    while inserted < n_ratings:
        u = int(rng.integers(1, n_users + 1))
        fav_pool = by_genre[user_fav[u - 1]]
        if fav_pool.size and rng.random() < 0.5:
            m = int(rng.choice(fav_pool))
        else:
            m = int(rng.integers(1, n_movies + 1))
        if (u, m) in seen:
            continue
        seen.add((u, m))
        fav = movie_genre[m - 1] == user_fav[u - 1]
        if fav:
            rating = float(rng.choice([4.0, 4.5, 5.0], p=[0.3, 0.3, 0.4]))
        else:
            rating = float(rng.choice([1.0, 2.0, 3.0, 3.5, 4.0],
                                      p=[0.2, 0.3, 0.25, 0.15, 0.1]))
        t += int(rng.integers(1, 1000))
        cur.execute("INSERT INTO ratings VALUES (?,?,?,?)", (u, m, rating, t))
        inserted += 1

    # ---- user split + derived tables (readme.md SQL) ---------------------
    n_train_users = int(n_users * train_frac)
    train_users = set(rng.permutation(np.arange(1, n_users + 1))
                      [:n_train_users].tolist())
    cur.execute("CREATE TABLE user (userId INTEGER, is_train INTEGER)")
    for u in range(1, n_users + 1):
        cur.execute("INSERT INTO user VALUES (?,?)",
                    (u, 1 if u in train_users else 0))

    for name, flag in (("ratings_train", 1), ("ratings_test", 0)):
        cur.execute(
            f"CREATE TABLE {name} AS SELECT r.userId, movieId, rating, "
            f"timestamp FROM ratings r LEFT JOIN user u ON "
            f"r.userId = u.userId WHERE is_train = {flag}")

    # user_feature_{train,test}: genre concat + rating stats per user
    for suffix, src in (("train", "ratings_train"), ("test", "ratings_test")):
        cur.execute(
            f"CREATE TABLE user_feature_{suffix} AS "
            f"SELECT r.userId, group_concat(m.genres) ugenres, "
            f"avg(r.rating) avgRating, count(r.rating) cntRating "
            f"FROM {src} r JOIN movies m ON r.movieId = m.movieId "
            f"GROUP BY r.userId")

    # ub_{train,test}: per-user item/ts sequences, ts desc (prepare.go:70-83)
    for suffix, src in (("train", "ratings_train"), ("test", "ratings_test")):
        cur.execute(
            f"CREATE TABLE ub_{suffix} AS "
            f"SELECT userId, group_concat(movieId) movieIds, "
            f"group_concat(timestamp) timestamps FROM "
            f"(SELECT userId, movieId, timestamp FROM {src} "
            f" ORDER BY userId, timestamp DESC) GROUP BY userId")

    conn.commit()
    conn.close()
