"""Predict-Future-Sales example on the port (the counterpart of the JAX
package's examples/futuresales.py, itself the hermetic version of the
reference's example/futuresales/main_test.go).

It generates a synthetic Kaggle-style `sales_train` / `items` SQLite
database with a planted seasonality + category + price signal (the same
draws as the JAX example's, so the same rows), builds the reference's
feature recipe (main_test.go:33-62: day / month / year / date_block /
shop / category / weekday one-hots, an FNV item-id hash one-hot, log2
price, an item-name split multi-hot) with the port's `data.schema` and
`features.hashing`, scales the target by 1/20 (outputTransform,
main_test.go:65-67), and trains two regressors on the device:

  * the legacy `Neural` engine with the reference's [in, 64, 64, 1]
    sigmoid layout (main_test.go:155-166), and
  * `MLPRegressor` (relu + adam) as the recommended path.

Run on the card, or on the CPU with --device=cpu:
    python -m goctr_tpu_torch.examples.futuresales [--device=cpu]
"""
from __future__ import annotations

import argparse
import datetime
import math
import os
import sqlite3
import tempfile

import numpy as np
import torch

from goctr_tpu_torch.data.schema import SqliteScanner
from goctr_tpu_torch.features.hashing import (hash_onehot, simple_onehot,
                                              string_split_multihot)
from goctr_tpu_torch.utils.util import concat_slices

N_SHOPS = 60
N_CATEGORIES = 84
N_MONTHS = 34                       # date_block_num 0..33: 2013-01..2015-10
_ADJ = ("mega", "ultra", "classic", "mini", "pro", "lite", "max", "eco")
_NOUN = ("widget", "gadget", "console", "album", "book", "toy", "lamp",
         "board")


def generate_db(path: str, n_items: int = 400, n_rows: int = 20000,
                seed: int = 0) -> None:
    """Create sales_train + items tables (readme.md data fields) with a
    planted signal: sales ~ category effect × month seasonality × shop
    effect / price."""
    rng = np.random.default_rng(seed)
    conn = sqlite3.connect(path)
    conn.executescript("""
        CREATE TABLE items (
            item_id INTEGER PRIMARY KEY, item_name TEXT,
            item_category_id INTEGER);
        CREATE TABLE sales_train (
            date TEXT, date_block_num INTEGER, shop_id INTEGER,
            item_id INTEGER, item_price REAL, item_cnt_day REAL);
    """)
    cats = rng.integers(0, N_CATEGORIES, n_items)
    names = [f"{_ADJ[i % 8]} {_NOUN[(i // 8) % 8]} {i}"
             for i in range(n_items)]
    conn.executemany("INSERT INTO items VALUES (?,?,?)",
                     list(zip(range(n_items), names, cats.tolist())))

    cat_eff = rng.gamma(2.0, 2.0, N_CATEGORIES)
    shop_eff = rng.uniform(0.5, 2.0, N_SHOPS)
    prices = rng.uniform(2.0, 2000.0, n_items)

    items = rng.integers(0, n_items, n_rows)
    shops = rng.integers(0, N_SHOPS, n_rows)
    blocks = rng.integers(0, N_MONTHS, n_rows)
    months = blocks % 12
    years = 2013 + blocks // 12
    days = rng.integers(1, 29, n_rows)
    season = 1.0 + 0.6 * np.cos(2 * np.pi * (months - 11) / 12.0)
    lam = (cat_eff[cats[items]] * shop_eff[shops] * season
           * (20.0 / np.sqrt(prices[items])))
    cnt = rng.poisson(lam).astype(np.float64)
    rows = [(f"{d:02d}.{m + 1:02d}.{y}", int(b), int(s), int(it),
             float(prices[it]), float(c))
            for d, m, y, b, s, it, c
            in zip(days, months, years, blocks, shops, items, cnt)]
    conn.executemany("INSERT INTO sales_train VALUES (?,?,?,?,?,?)", rows)
    conn.commit()
    conn.close()


def feature_transform(date: str, date_block_num: float, shop_id: float,
                      item_id: float, item_price: float,
                      item_category_id: float, item_name: str) -> np.ndarray:
    """Reference featureTransform (main_test.go:33-62), same block layout."""
    day, month, year = (int(p) for p in date.split("."))
    # Go's time.Weekday() is Sun=0, Python's weekday() Mon=0
    weekday = (datetime.date(year, month, day).weekday() + 1) % 7
    return concat_slices(
        simple_onehot(day - 1, 31),
        simple_onehot(month - 1, 12),
        simple_onehot(year - 2013, 3),
        simple_onehot(int(date_block_num), N_MONTHS),
        simple_onehot(int(shop_id), N_SHOPS),
        simple_onehot(int(item_category_id), N_CATEGORIES),
        simple_onehot(weekday, 7),
        hash_onehot(np.float64(item_id).tobytes(), 10),
        np.asarray([math.log2(item_price)], np.float32),
        string_split_multihot(item_name, " ", 100),
    )


def output_transform(y: np.ndarray) -> np.ndarray:
    return np.asarray(y, np.float32) / 20.0          # main_test.go:65-67


def output_recovery(y: np.ndarray) -> np.ndarray:
    return np.asarray(y, np.float32) * 20.0          # main_test.go:69-71


def load_samples(db_path: str, limit: int, offset: int = 0):
    """SQL join + featureTransform, mirroring main_test.go:90-151."""
    scanner = SqliteScanner(db_path)
    X, Y = [], []
    for row in scanner.scan_rows(
            "SELECT date, date_block_num, shop_id, s.item_id, item_price,"
            " item_category_id, item_name, item_cnt_day FROM sales_train s"
            " LEFT JOIN items i ON s.item_id = i.item_id"
            " LIMIT ? OFFSET ?", (limit, offset)):
        (date, block, shop, item, price, cat, name, cnt) = row
        X.append(feature_transform(date, block, shop, item, price,
                                   cat or 0.0, name or ""))
        Y.append(cnt)
    scanner.close()
    return np.stack(X), output_transform(np.asarray(Y))


def run(db_path: str | None = None, train_count: int = 10000,
        test_count: int = 1000, epochs: int = 2, verbose: bool = True,
        device: str | torch.device = "cuda"):
    """Train Neural + MLPRegressor on `device`; return {name: (mse, r2)}."""
    from goctr_tpu_torch.core.dtypes import resolve_device
    from goctr_tpu_torch.core.metrics import mean_squared_error, r2_score
    from goctr_tpu_torch.models.mlp_regressor import MLPRegressor
    from goctr_tpu_torch.models.neural import Neural, NeuralConfig

    device = resolve_device(device)          # raises without a card
    tmp = None
    if db_path is None:
        tmp = tempfile.NamedTemporaryFile(suffix=".db", delete=False)
        tmp.close()
        db_path = tmp.name
        generate_db(db_path, n_rows=train_count + test_count)

    Xtr, ytr = load_samples(db_path, train_count)
    Xte, yte = load_samples(db_path, test_count, offset=train_count)
    if verbose:
        print(f"training data count: {len(Xtr)}  (width {Xtr.shape[1]})")
        print(f"test data count: {len(Xte)}")

    results = {}
    # Legacy engine, reference layout [in, 64, 64, 1] sigmoid
    # (main_test.go:155-161): sigmoid output suits the /20-scaled target.
    neural = Neural(NeuralConfig(
        inputs=Xtr.shape[1], layout=(64, 64, 1), activation="sigmoid",
        mode="regression", loss="mse", weight_std=0.5), seed=0,
        device=device)
    neural.train(Xtr, ytr, lr=0.05, epochs=epochs, batch_size=64)
    pred = neural.predict(Xte)[:, 0]
    results["neural"] = (mean_squared_error(yte, pred), r2_score(yte, pred))

    mlp = MLPRegressor(hidden_layer_sizes=(64, 64), activation="relu",
                       solver="adam", learning_rate_init=1e-3,
                       max_iter=max(epochs * 5, 10), batch_size=256,
                       random_state=0, device=device)
    mlp.fit(Xtr, ytr)
    pred = mlp.predict(Xte)
    results["mlp"] = (mean_squared_error(yte, pred), r2_score(yte, pred))

    if verbose:
        for name, (mse, r2) in results.items():
            print(f"{name:7s} test MSE {mse:.5f}  R2 {r2:.4f}")
        for i in range(5):     # per-row printouts à la main_test.go:188-206
            print(f"sample {i}: actual {output_recovery(yte[i]):.1f} "
                  f"predicted {output_recovery(pred[i]):.1f}")
    if tmp is not None:
        os.unlink(db_path)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--db", default=None,
                   help="an existing sales database (default: generate one)")
    p.add_argument("--train_count", type=int, default=10000)
    p.add_argument("--test_count", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=2)
    a = p.parse_args(argv)
    run(a.db, a.train_count, a.test_count, a.epochs, device=a.device)


if __name__ == "__main__":
    main()
