"""The port's item2vec (goctr_tpu_torch/embedding/) against the JAX
package's, on the CPU.

Word2Vec: JAX's threefry streams cannot be reproduced in torch, so the
port's epoch takes its three draws as inputs and `JaxDraws` hands it
JAX's own: for an iteration's key (`key(seed * 1000 + it)`, chunk c > 0
of train_file `fold_in(key, c)`), `uniform(k_sub, (n,))`,
`randint(k_rad, (n,), 1, W + 1)` and, for block b,
`randint(fold_in(key, b), (bp, K), 0, table_size)` — the draws of
goctr_tpu/embedding/word2vec.py:385-396, 472-474. The w_in init is the
same numpy draw in both packages. Then every combination (skipgram or
CBOW, hierarchical softmax or negative sampling) trains the same tables.

Tolerances. Dictionary, Huffman paths, unigram table, keep
probabilities, row scales and the pair counts are exact, and so are the
saved text files for the same vectors. Tables: both packages do the same
f32 arithmetic, but the batched products sum over D in other orders (XLA's
dot vs torch.bmm) and each block's row adds land on rows that later
blocks read; over 1-2 iterations of ~20-60 blocks: atol 1e-6, rtol 1e-5
(observed ≤ 2.4e-7 on entries up to 1.13). Search similarities are one
f32 product each: atol 1e-6.
"""
import dataclasses
import io
import sys

import jax
import numpy as np
import pytest
import torch

from goctr_tpu.embedding import console as jconsole
from goctr_tpu.embedding import search as jsearch
from goctr_tpu.embedding import store as jstore
from goctr_tpu.embedding.dictionary import Dictionary as JDict
from goctr_tpu.embedding.huffman import build_huffman_paths as jhuff
from goctr_tpu.embedding.word2vec import Word2Vec as JW

from goctr_tpu_torch.convert import word2vec_from_jax
from goctr_tpu_torch.embedding import console as tconsole
from goctr_tpu_torch.embedding import store as tstore
from goctr_tpu_torch.embedding.dictionary import Dictionary as TDict
from goctr_tpu_torch.embedding.huffman import build_huffman_paths as thuff
from goctr_tpu_torch.embedding.search import Searcher
from goctr_tpu_torch.embedding.word2vec import EpochDraws, Word2Vec, _cli

CPU = "cpu"
ATOL, RTOL = 1e-6, 1e-5
COMBOS = [(m, o) for m in ("skipgram", "cbow") for o in ("hs", "ns")]


class JaxDraws(Word2Vec):
    """The port's Word2Vec fed the JAX package's random draws."""

    def _draws(self, gen, it, chunk, n):
        o = self.opts
        key = jax.random.key(o.seed * 1000 + it)
        if chunk:
            key = jax.random.fold_in(key, chunk)
        k_sub, k_rad = jax.random.split(key)
        uniform = torch.from_numpy(np.array(jax.random.uniform(k_sub, (n,))))
        radius = torch.from_numpy(np.array(jax.random.randint(
            k_rad, (n,), 1, o.window + 1), np.int64))
        shape = (self._block_positions(), o.negative)

        def negatives(b):
            return torch.from_numpy(np.array(jax.random.randint(
                jax.random.fold_in(key, b), shape, 0, o.table_size),
                np.int64))
        return EpochDraws(uniform, radius,
                          None if o.optimizer == "hs" else negatives)


def corpus(n_docs=600, seed=0, ints=False):
    """Four clusters of 25 words; documents of 3-39 words from one
    cluster (the test corpus of tests/test_embedding.py, grown)."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        c = rng.integers(0, 4)
        ids = c * 25 + rng.integers(0, 25, size=rng.integers(3, 40))
        docs.append([int(i) for i in ids] if ints else
                    [f"w{i}" for i in ids])
    return docs


def assert_tables(j, t):
    np.testing.assert_allclose(t.w_in, j.w_in, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t.w_out, j.w_out, atol=ATOL, rtol=RTOL)
    assert t.words_trained == j.words_trained


# ------------------------------------------------------------ numpy parts --

@pytest.mark.parametrize("ints", [False, True], ids=["str", "int"])
def test_dictionary_matches_jax(ints):
    docs = corpus(200, seed=1, ints=ints) + ([] if ints else ["w3 W3 w7"])
    jd, jenc = JDict.build(docs, to_lower=not ints)
    td, tenc = TDict.build(docs, to_lower=not ints)
    assert td.id2word == jd.id2word and td.counts == jd.counts
    assert td.word2id == jd.word2id
    for a, b in zip(jenc, tenc):
        np.testing.assert_array_equal(a, b)
    doc = docs[5]
    np.testing.assert_array_equal(td.encode(doc), jd.encode(doc))
    for th in (1e-3, 1e-2, 0.0):
        np.testing.assert_array_equal(td.keep_probs(th), jd.keep_probs(th))
    np.testing.assert_array_equal(td.unigram_table(4096),
                                  jd.unigram_table(4096))
    td.add("new", "w1")
    jd.add("new", "w1")
    assert (td.freq("new"), td.id_of("new"), td.word(0)) == \
        (jd.freq("new"), jd.id_of("new"), jd.word(0))


@pytest.mark.parametrize("counts", [
    [50, 30, 10, 5, 5], [7] * 9, [1, 1], [3], [], list(range(1, 200)),
    list(np.random.default_rng(2).integers(1, 1000, 300))],
    ids=["small", "ties", "two", "one", "empty", "ramp", "random"])
def test_huffman_paths_match_jax(counts):
    for max_depth in (100, 4):
        for a, b in zip(jhuff(counts, max_depth), thuff(counts, max_depth)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model,opt", COMBOS)
def test_static_row_scales_match_jax(model, opt):
    docs = corpus(300, seed=3)
    kw = dict(dim=8, window=3, model=model, optimizer=opt, batch_size=512,
              table_size=1 << 12)
    j, t = JW(**kw), Word2Vec(**kw, device=CPU)
    for m, dictionary in ((j, JDict), (t, TDict)):
        m.dictionary, _ = dictionary.build(docs)
        m._init_state(m.dictionary.counts_array(),
                      np.random.default_rng(0))
    counts = j.dictionary.counts_array()
    for a, b in zip(j._static_row_scales(counts),
                    t._static_row_scales(counts)):
        np.testing.assert_array_equal(np.asarray(a), b)


# ------------------------------------------------------------- training ---

@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("model,opt", COMBOS)
def test_word2vec_matches_jax_with_its_draws(model, opt, iters):
    """One iteration checks the epoch; two also the lr schedule across
    iterations (each block's lr interpolated over b / (n_blocks - 1))."""
    docs = corpus()
    kw = dict(dim=8, window=3, iters=iters, min_count=2, batch_size=512,
              seed=3, model=model, optimizer=opt)
    j = JW(**kw).train(docs)
    t = JaxDraws(**kw, device=CPU).train(docs)
    assert t.dictionary.id2word == j.dictionary.id2word
    assert_tables(j, t)
    np.testing.assert_allclose(t.vectors(), j.vectors(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("ablate", ["noscatter", "frontonly"])
def test_word2vec_ablations_match_jax(ablate):
    kw = dict(dim=8, window=3, iters=1, min_count=1, batch_size=512,
              seed=4, model="skipgram", optimizer="ns", ablate=ablate)
    docs = corpus(300, seed=4)
    assert_tables(JW(**kw).train(docs), JaxDraws(**kw, device=CPU).train(
        docs))


@pytest.mark.parametrize("batch_docs", [10_000, 70],
                         ids=["one chunk", "bucketed chunks"])
def test_train_file_matches_jax(tmp_path, batch_docs):
    """One chunk pads as train() does; several chunks are padded to bp
    times a power of two, which sets each chunk's n_blocks, lr fractions
    and draw shapes."""
    docs = corpus(300, seed=5)
    p = tmp_path / "corpus.txt"
    p.write_text("\n".join(" ".join(d) for d in docs) + "\n")
    kw = dict(dim=8, window=3, iters=2, min_count=1, batch_size=512,
              seed=1, model="skipgram", optimizer="ns")
    j = JW(**kw).train_file(p, batch_docs=batch_docs)
    t = JaxDraws(**kw, device=CPU).train_file(p, batch_docs=batch_docs)
    assert_tables(j, t)
    if batch_docs > len(docs):
        mem = JaxDraws(**kw, device=CPU).train(docs)
        np.testing.assert_array_equal(mem.w_in, t.w_in)
        np.testing.assert_array_equal(mem.w_out, t.w_out)


def test_port_draws_train_clusters_and_repeat():
    """With its own generator the port learns the planted clusters (the
    JAX package's quality test) and repeats itself bit for bit."""
    docs = corpus(800, seed=6)
    emb = tstore.train_embedding(docs, window=3, dim=16, iters=3,
                                 min_count=1, batch_size=1024, device=CPU)
    again = tstore.train_embedding(docs, window=3, dim=16, iters=3,
                                   min_count=1, batch_size=1024, device=CPU)
    words, mat = emb.as_arrays()
    np.testing.assert_array_equal(mat, again.as_arrays()[1])
    mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
    sims = mat @ mat.T
    cl = np.array([int(w[1:]) // 25 for w in words])
    same = cl[:, None] == cl[None, :]
    assert sims[same].mean() > sims[~same].mean() + 0.2


def test_min_count_and_entry_points_refuse_without_a_card(monkeypatch):
    docs = [["x", "y"] * 10, ["rare", "x"]]
    emb = tstore.train_embedding(docs, window=2, dim=4, iters=1,
                                 min_count=2, device=CPU)
    assert set(emb) == {"x", "y"} and emb.get_vec("nope").shape == (4,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tstore.train_embedding(docs, window=2, dim=4, min_count=1)
    with pytest.raises(RuntimeError, match="is_available"):
        Searcher(emb)


# ------------------------------------------------- store, search, console --

def test_text_files_are_byte_equal_and_load_back(tmp_path):
    docs = corpus(300, seed=7)
    j = JW(dim=6, window=2, iters=1, min_count=3, optimizer="ns",
           batch_size=512).train(docs)
    t = word2vec_from_jax(j.w_in, j.w_out, j.dictionary.id2word,
                          j.dictionary.counts, dataclasses.asdict(j.opts),
                          device=CPU)
    jemb = jstore.embedding_map_from_model(j)
    temb = tstore.embedding_map_from_model(t)
    assert list(temb) == list(jemb)
    jp, tp = tmp_path / "jax.txt", tmp_path / "port.txt"
    jstore.save_embedding_map(jp, jemb)
    tstore.save_embedding_map(tp, temb)
    assert tp.read_bytes() == jp.read_bytes()
    loaded = tstore.load_embedding_map(tp)
    assert list(loaded) == list(temb)
    for w in temb:
        np.testing.assert_array_equal(loaded[w], temb[w])
    buf = io.StringIO()
    tstore.save_embedding_map(buf, temb)
    buf.seek(0)
    assert buf.getvalue() == jp.read_text()
    # an HS model's Huffman paths are rebuilt by the converter
    jh = JW(dim=6, window=2, iters=1, min_count=1, optimizer="hs",
            batch_size=512).train(docs)
    th = word2vec_from_jax(jh.w_in, jh.w_out, jh.dictionary.id2word,
                           jh.dictionary.counts, dataclasses.asdict(jh.opts),
                           device=CPU)
    np.testing.assert_array_equal(th._paths, jh._paths)
    np.testing.assert_array_equal(th.vectors(), jh.vectors())


def test_searcher_top_k_matches_jax():
    rng = np.random.default_rng(8)
    emb = {f"i{k}": rng.normal(size=12).astype(np.float32)
           for k in range(300)}
    emb["zero"] = np.zeros(12, np.float32)
    j, t = jsearch.Searcher(emb), Searcher(emb, device=CPU)
    q = rng.normal(size=(40, 12)).astype(np.float32)
    for a, b in zip(j.search_vec(q, 10), t.search_vec(q, 10)):
        assert [w for w, _ in a] == [w for w, _ in b]
        np.testing.assert_allclose([s for _, s in b], [s for _, s in a],
                                   atol=1e-6)
    for word in ("i0", "i17", "zero", "missing"):
        a, b = j.search(word, 5), t.search(word, 5)
        assert [w for w, _ in a] == [w for w, _ in b]
        np.testing.assert_allclose([s for _, s in b], [s for _, s in a],
                                   atol=1e-6)


def _run_console(module, argv, lines, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(
        f"{w}\n" for w in lines)))
    monkeypatch.setattr(sys, "argv", ["console"] + argv)
    rc = module.main()
    return rc, capsys.readouterr().out


def test_console_answers_as_jax_does(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(9)
    path = tmp_path / "model.txt"
    tstore.save_embedding_map(path, {
        f"w{k}": rng.normal(size=8).astype(np.float32) for k in range(50)})
    words = ["w3", "nope", "w40", ""]
    rc_j, out_j = _run_console(jconsole, [str(path), "4"], words,
                               monkeypatch, capsys)
    rc_t, out_t = _run_console(tconsole, [str(path), "4", CPU], words,
                               monkeypatch, capsys)
    assert rc_j == rc_t == 0

    def parse(out):
        rows = [ln.split() for ln in out.splitlines()]
        return [r[:-1] for r in rows], [float(r[-1]) for r in rows
                                        if r and r[0].isdigit()]
    (tj, sj), (tt, st) = parse(out_j), parse(out_t)
    assert tt == tj and len(st) == 8
    np.testing.assert_allclose(st, sj, atol=2e-6)
    assert tconsole.main([]) == 1


def test_cli_round_trip(tmp_path):
    """`python -m goctr_tpu_torch.embedding.word2vec` trains from a corpus
    file and writes a text model that both packages load."""
    docs = corpus(300, seed=10)
    src = tmp_path / "corpus.txt"
    src.write_text("\n".join(" ".join(d) for d in docs) + "\n")
    out = tmp_path / "model.txt"
    rc = _cli(["-i", str(src), "-o", str(out), "--dim", "8", "--iter", "2",
               "--min-count", "1", "--window", "3", "--optimizer", "hs",
               "--subsample-threshold", "0", "--device", CPU])
    assert rc == 0
    emb = tstore.load_embedding_map(out)
    assert len(emb) == 100 and emb.dim == 8
    assert list(jstore.load_embedding_map(out)) == list(emb)
