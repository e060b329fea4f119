"""item2vec throughput of the port on the ML-10M-shaped corpus (the
counterpart of the JAX repository's scripts/bench_item2vec.py, with its
corpora, flags and printed lines).

    python3 -m goctr_tpu_torch.bench_item2vec [--batch=65536] [--iters=3]
        [--model=skipgram] [--optimizer=hs] [--overlap=1] [--quality]
        [--stagebreak] [--cpu]

Corpus: ~9.5M words as 100k user-history "docs" drawn from a 10k-item zipf
vocabulary, the shape of the reference's README.md:133-141 run (9.5M
words, SkipGram + HS, dim 16, window 5); with --quality the same size with
500 planted co-occurrence clusters, and the top-5 neighbour purity after
training. One warm-up iteration, then the steady line: pair-updates/s and
words/s over all iterations of a fresh run. --stagebreak times instead
the epoch's ablations (front end only; + gathers and products; the full
epoch). Runs on the card unless given --cpu; without a card and without
--cpu it exits nonzero.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

FLAGS = {"batch": "65536", "iters": "3", "model": "skipgram",
         "optimizer": "hs", "overlap": "1"}
SWITCHES = ("quality", "stagebreak", "cpu")
STAGES = (("frontonly", "front-end + scan skeleton"),
          ("noscatter", "+ gathers + einsums"),
          ("", "+ table scatters (FULL)"))


def make_corpus(n_words: int = 9_500_000, vocab: int = 10_000,
                n_docs: int = 100_000, seed: int = 0) -> list[np.ndarray]:
    """Zipf (s = 1.05) item draws cut into n_docs docs at random points."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.05
    p /= p.sum()
    words = rng.choice(vocab, size=n_words, p=p).astype(np.int64)
    cuts = np.sort(rng.choice(n_words, n_docs - 1, replace=False))
    return [w for w in np.split(words, cuts) if len(w)]


def make_cluster_corpus(n_words: int = 9_500_000, vocab: int = 10_000,
                        n_clusters: int = 500, n_docs: int = 100_000,
                        p_in: float = 0.85, seed: int = 0):
    """The corpus with planted co-occurrence clusters: items partition
    into clusters of vocab / n_clusters; each doc owns a zipf-popular home
    cluster and draws p_in of its words from it, the rest globally.
    Returns (docs as int arrays, cluster_of [vocab])."""
    rng = np.random.default_rng(seed)
    per = vocab // n_clusters
    cluster_of = np.minimum(np.arange(vocab) // per, n_clusters - 1)
    p = 1.0 / np.arange(1, n_clusters + 1) ** 1.05
    p /= p.sum()
    doc_len = np.maximum(rng.poisson(n_words / n_docs, n_docs), 4)
    docs = []
    home = rng.choice(n_clusters, n_docs, p=p)
    for d in range(n_docs):
        L = doc_len[d]
        inside = rng.random(L) < p_in
        w = np.where(inside, home[d] * per + rng.integers(0, per, L),
                     rng.integers(0, vocab, L))
        docs.append(w.astype(np.int64))
    return docs, cluster_of


def item_ids(w2v) -> np.ndarray:
    """The item id of each row of a trained model's vectors."""
    d = w2v.dictionary
    return np.asarray([int(d.word(i)) for i in range(len(d))])


def neighbor_purity(vecs, ids, cluster_of, k: int = 5, n_query: int = 500,
                    seed: int = 0) -> float:
    """Share of the top-k cosine neighbours that share the query's planted
    cluster (a numpy oracle; `ids` maps rows of `vecs` to item ids)."""
    vn = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True),
                           1e-12)
    rng = np.random.default_rng(seed)
    q = rng.choice(len(ids), min(n_query, len(ids)), replace=False)
    sims = vn[q] @ vn.T
    sims[np.arange(len(q)), q] = -np.inf
    top = np.argpartition(sims, -k, axis=1)[:, -k:]
    return float((cluster_of[ids[top]] == cluster_of[ids[q]][:, None]
                  ).mean())


def options(batch: int = 65_536, model: str = "skipgram",
            optimizer: str = "hs", overlap: bool = True) -> dict:
    """The bench's Word2Vec options (dim 16, window 5, min_count 1,
    seed 1)."""
    return dict(dim=16, window=5, model=model, optimizer=optimizer,
                batch_size=batch, min_count=1, verbose=False, seed=1,
                overlap=overlap)


def timed_train(docs, iters: int, device, **kw):
    """A fresh Word2Vec of `iters` iterations trained on `docs` (its
    tables end on the host). Returns (model, seconds)."""
    from goctr_tpu_torch.embedding.word2vec import Word2Vec

    w2v = Word2Vec(iters=iters, device=device, **kw)
    t0 = time.perf_counter()
    w2v.train(docs)
    return w2v, time.perf_counter() - t0


def steady_line(pairs: int, seconds: float, n_words: int, iters: int,
                kw: dict) -> str:
    return (f"steady: {pairs} pair-updates / {seconds:.1f}s = "
            f"{pairs / seconds / 1e6:.2f}M pairs/s  "
            f"({n_words * iters / seconds / 1e3:.0f}k words/s) "
            f"batch={kw['batch_size']} iters={iters} "
            f"{kw['model']}+{kw['optimizer']}")


def main(argv: list[str]) -> int:
    for a in argv:
        name, eq, value = a[2:].partition("=")
        if not a.startswith("--") or not (
                name in FLAGS and eq and value or a[2:] in SWITCHES):
            raise SystemExit(f"bench_item2vec: unknown argument {a!r}")

    def arg(name: str) -> str:
        for a in argv:
            if a.startswith(f"--{name}="):
                return a.split("=", 1)[1]
        return FLAGS[name]

    cpu = "--cpu" in argv
    if not cpu and not torch.cuda.is_available():
        print("bench_item2vec: torch.cuda.is_available() is False; pass "
              "--cpu to run on the CPU", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if cpu else "cuda")
    print("backend:", dev.type, flush=True)
    iters = int(arg("iters"))
    kw = options(int(arg("batch")), arg("model"), arg("optimizer"),
                 arg("overlap") == "1")
    quality = "--quality" in argv
    t0 = time.perf_counter()
    if quality:
        raw, cluster_of = make_cluster_corpus()
    else:
        raw = make_corpus()
    docs = [[str(w) for w in d] for d in raw]
    n_words = sum(len(d) for d in docs)
    print(f"corpus: {n_words} words, {len(docs)} docs "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    _, dt = timed_train(docs, 1, dev, **kw)
    print(f"warm-up iter (incl. first calls): {dt:.1f}s", flush=True)

    if "--stagebreak" in argv:
        # where the epoch goes: the front end (subsample, compaction, the
        # block loop's skeleton), + gathers and products, + table adds
        for ab, label in STAGES:
            timed_train(docs, 1, dev, ablate=ab, **kw)      # first calls
            _, dt = timed_train(docs, iters, dev, ablate=ab, **kw)
            print(f"  {label:32s} {dt / iters:7.2f}s/iter", flush=True)
        return 0

    w2v, total = timed_train(docs, iters, dev, **kw)
    print(steady_line(w2v.words_trained, total, n_words, iters, kw),
          flush=True)
    if quality:
        pur = neighbor_purity(w2v.vectors(), item_ids(w2v), cluster_of)
        print(f"at-scale top-5 neighbor cluster purity: {pur:.3f} "
              f"(planted 500 clusters / 10k vocab)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
