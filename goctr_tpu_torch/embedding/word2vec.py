"""item2vec / word2vec on the card (port of goctr_tpu/embedding/word2vec.py).

The flat corpus is shipped to the device once; each iteration is one call
of `train_epoch`, which does everything there: the subsample mask, the
stable compaction of the kept words, a window radius for each centre, and
a Python loop over corpus blocks whose body gathers, multiplies (batched
products) and adds rows into the [V, D] tables in place (`index_add_`).
The host syncs once an iteration, to learn how many blocks hold kept
words: blocks past them hold no centre and would add nothing.

The update uses the JAX package's corpus-block layout: a block of `bp`
consecutive kept centres is expanded to its [bp, 2W] context matrix
(masked by document and by each centre's radius), logits come from one
batched product, and each centre's Huffman-path nodes (HS) or sampled
negatives (NS) receive one summed row update across its 2W contexts.
Row steps are scaled by the static expectation caps of
`_static_row_scales`. NS draws K negatives per centre, shared by its
contexts. The learning rate falls linearly over the iteration, block by
block (`b / max(n_blocks - 1, 1)`).

Random draws. An iteration takes three draws: a uniform [n] for the
subsample, a radius in [1, W] for each of the n slots, and each block's
[bp, K] indices into the unigram table (NS). They are explicit inputs of
`train_epoch` (`EpochDraws`); `Word2Vec._draws` makes them from a
generator on the device seeded with `opts.seed * 1000 + iteration`
(chunks of one `train_file` iteration continue its stream), drawing one
block's negatives at a time. JAX's threefry streams cannot be reproduced
in torch, so parity tests override `_draws` with JAX's own draws.

Supported: SkipGram | CBOW × negative sampling | hierarchical softmax,
window shrink, frequency subsampling, min_count filtering, linear LR
decay.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.embedding.dictionary import Dictionary
from goctr_tpu_torch.embedding.huffman import build_huffman_paths

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Word2VecOptions:
    """The JAX package's options, field for field (reference defaults:
    dim 10, window 5, lr 0.025, iter 15, min_count 5, negative 5,
    subsample 1e-3; train_embedding overrides to skipgram + hs)."""
    dim: int = 10
    window: int = 5
    init_lr: float = 0.025
    min_lr: Optional[float] = None          # default init_lr * 1e-4
    iters: int = 15
    min_count: int = 5
    negative: int = 5
    subsample_threshold: float = 1e-3
    model: str = "skipgram"                 # skipgram | cbow
    optimizer: str = "ns"                   # ns | hs
    batch_size: int = 8192
    max_depth: int = 100
    to_lower: bool = False
    seed: int = 0
    verbose: bool = False
    table_size: int = 1 << 20
    # no effect: kept so that both packages take the same options
    overlap: bool = True
    # measurement-only ablation of the epoch (never set in production):
    # "noscatter" drops the table adds (keeps gathers and products live),
    # "frontonly" drops the whole block body (subsample, compaction and
    # the block loop's skeleton remain)
    ablate: str = ""

    def __post_init__(self):
        if self.min_lr is None:
            self.min_lr = self.init_lr * 1e-4


@dataclasses.dataclass
class EpochDraws:
    """The random inputs of one `train_epoch` call over n corpus slots:
    `uniform` [n] float32 in [0, 1) (subsample), `radius` [n] int64 in
    [1, W], and `negatives(b)` the [bp, K] int64 indices into the unigram
    table of block b (NS only; None for HS)."""
    uniform: torch.Tensor
    radius: torch.Tensor
    negatives: Optional[Callable[[int], torch.Tensor]] = None


def train_epoch(w_in: torch.Tensor, w_out: torch.Tensor,
                tab_a: torch.Tensor, tab_b: Optional[torch.Tensor],
                scale_in: torch.Tensor, scale_out: torch.Tensor,
                flat: torch.Tensor, doc_id: torch.Tensor,
                keep: torch.Tensor, lr_start: float, lr_end: float,
                draws: EpochDraws, opts: Word2VecOptions,
                bp: int) -> torch.Tensor:
    """One iteration over the padded device corpus `flat` / `doc_id`
    ([n] int64, -1 = no word; n a multiple of `bp`), updating `w_in` and
    `w_out` in place. `tab_a` / `tab_b` are the HS paths [V, P] (int64)
    and codes [V, P], or the NS unigram table [T] (int64) and None.
    Returns the number of (centre, context) examples trained, a device
    scalar."""
    dev = w_in.device
    n = flat.shape[0]
    n_blocks = n // bp
    W, dim = opts.window, w_in.shape[1]
    is_hs, is_cbow = opts.optimizer == "hs", opts.model == "cbow"
    m = (flat >= 0) & (draws.uniform < keep[flat.clamp(min=0)])
    pos = torch.arange(n, device=dev)
    # stable compaction: kept words first, in their order (unique keys)
    ordr = torch.argsort(torch.where(m, pos, n + pos))
    n_kept = m.sum()
    live = pos < n_kept
    fk = torch.where(live, flat[ordr], -1)
    dk = torch.where(live, doc_id[ordr], -2)
    offs = torch.tensor([o for o in range(-W, W + 1) if o != 0],
                        device=dev)
    abs_offs = offs.abs()
    base = torch.arange(bp, device=dev)[:, None] + offs[None, :]
    if not is_hs:
        labels = torch.zeros((bp, opts.negative + 1), device=dev)
        labels[:, 0] = 1.0
    n_ex = torch.zeros((), dtype=torch.int64, device=dev)
    # blocks past the kept words have no centre: all their updates are 0
    n_live = min(-(-int(n_kept) // bp), n_blocks)
    denom_blocks = np.float32(max(n_blocks - 1, 1))
    lr0, lr1 = np.float32(lr_start), np.float32(lr_end)

    def add_rows(tab, ids, rows):
        if opts.ablate == "noscatter":
            tab[0, 0] += rows[:, :1].sum() * 1e-20
            return
        tab.index_add_(0, ids.clamp(min=0),
                       rows * (ids >= 0).to(rows.dtype)[:, None])

    for b in range(n_live):
        i0 = b * bp
        centers = fk[i0:i0 + bp]
        if opts.ablate == "frontonly":
            n_b = (centers >= 0).sum()
            w_in[0, 0] += n_b.to(w_in.dtype) * 1e-20
            n_ex += n_b
            continue
        dctr = dk[i0:i0 + bp]
        rad = draws.radius[i0:i0 + bp]
        idx = base + i0
        inb = (idx >= 0) & (idx < n)
        idxc = idx.clamp(0, n - 1)
        cx, dcx = fk[idxc], dk[idxc]                    # [bp, 2W]
        valid = (inb & (centers[:, None] >= 0) & (cx >= 0)
                 & (dcx == dctr[:, None])
                 & (rad[:, None] >= abs_offs[None, :]))
        vmask = valid.float()
        # the lr in float32, as the JAX epoch forms it
        frac = np.float32(b) / denom_blocks
        lr = float(lr0 + (lr1 - lr0) * frac)
        c_safe = centers.clamp(min=0)
        cx_safe = cx.clamp(min=0)
        vs = w_in[cx_safe]                              # [bp, 2W, D]
        cmask = (centers >= 0).float()
        if is_cbow:
            # input = mean of the context vectors; target = the centre
            denom = vmask.sum(1, keepdim=True).clamp(min=1.0)
            t_mask = ((vmask.sum(1) > 0) & (centers >= 0)).float()
            v_eff = ((vs * vmask[..., None]).sum(1) / denom)[:, None, :]
            wmask = t_mask[:, None]                     # [bp, 1]
        else:
            # each context word's input vector trains against the centre
            v_eff = vs
            wmask = vmask
        if is_hs:
            paths = tab_a[c_safe]                       # [bp, P]
            codes = tab_b[c_safe]
            pmask = (paths >= 0).float() * cmask[:, None]
            ids = paths.clamp(min=0)
            u = w_out[ids]                              # [bp, P, D]
            z = torch.bmm(v_eff, u.transpose(1, 2))     # [bp, w, P]
            g = ((1.0 - codes[:, None, :] - torch.sigmoid(z))
                 * wmask[:, :, None] * pmask[:, None, :] * lr)
            out_ids = torch.where(pmask > 0, ids, -1)
        else:
            negs = tab_a[draws.negatives(b)]            # [bp, K]
            ids = torch.cat([c_safe[:, None], negs], 1)
            kmask = cmask[:, None]
            u = w_out[ids]                              # [bp, K+1, D]
            z = torch.bmm(v_eff, u.transpose(1, 2))
            g = ((labels[:, None, :] - torch.sigmoid(z))
                 * wmask[:, :, None] * kmask[:, None, :] * lr)
            out_ids = torch.where(kmask > 0, ids, -1)
        dv = torch.bmm(g, u)                            # [bp, w, D]
        du = torch.bmm(g.transpose(1, 2), v_eff)        # [bp, P|K+1, D]
        add_rows(w_out, out_ids.reshape(-1),
                 (du * scale_out[ids][..., None]).reshape(-1, dim))
        sc_in = scale_in[cx_safe]                       # [bp, 2W]
        if is_cbow:
            upd = ((dv[:, 0, :] / denom)[:, None, :]
                   * (vmask * sc_in)[..., None])
        else:
            upd = dv * (vmask * sc_in)[..., None]
        add_rows(w_in, torch.where(valid, cx_safe, -1).reshape(-1),
                 upd.reshape(-1, dim))
        n_ex += (wmask > 0).sum()
    return n_ex


class Word2Vec:

    def __init__(self, opts: Optional[Word2VecOptions] = None, *,
                 device: str | torch.device = "cuda", **kw):
        self.opts = opts or Word2VecOptions(**kw)
        self.device = device
        self.dictionary: Optional[Dictionary] = None
        self.w_in: Optional[np.ndarray] = None
        self.w_out: Optional[np.ndarray] = None
        self._paths = self._codes = self._lengths = None
        self.words_trained = 0

    # ----------------------------------------------------------- training --
    def train(self, docs: Iterable[Sequence[str] | str]) -> "Word2Vec":
        o = self.opts
        dev = resolve_device(self.device)
        t0 = time.perf_counter()
        self.dictionary, encoded = Dictionary.build(docs, o.to_lower)
        if len(self.dictionary) == 0:
            raise ValueError("empty corpus")
        counts = self.dictionary.counts_array()
        # min_count filter (corpus filter semantics; ids keep their slots so
        # the exported map covers only surviving words)
        valid = counts >= o.min_count
        if o.verbose:
            log.info("vocab %d (%d ≥ min_count) read in %.2fs",
                     len(self.dictionary), int(valid.sum()),
                     time.perf_counter() - t0)
        self._init_state(counts, np.random.default_rng(o.seed))
        total_words = int(sum(len(d) for d in encoded))
        flat, doc_id = self._flatten_corpus([d[valid[d]] for d in encoded])
        words_per_iter = int(flat.size)
        d_flat, d_doc = self._device_corpus(flat, doc_id, dev)
        epoch, w_in, w_out = self._epoch_fn(counts, dev)

        words_done = 0
        total_train_words = max(total_words * o.iters, 1)
        pair_counts = []
        for it in range(o.iters):
            te = time.perf_counter()
            lr_start, words_done, lr_end = self._lr_span(
                words_done, words_per_iter, total_train_words)
            gen = self._generator(it, dev)
            n_pairs = epoch(d_flat, d_doc, lr_start, lr_end,
                            self._draws(gen, it, 0, d_flat.shape[0]))
            pair_counts.append(n_pairs)
            if o.verbose:
                n_ex = int(n_pairs)             # device sync: honest timing
                dt = max(time.perf_counter() - te, 1e-9)
                log.info("iter %d: %d examples in %.2fs (%.0f/s)", it, n_ex,
                         dt, n_ex / dt)
        self.words_trained += int(sum(int(c) for c in pair_counts))
        self._store(w_in, w_out)
        return self

    def train_file(self, path, *, batch_docs: int = 20_000) -> "Word2Vec":
        """Out-of-core twin of train(): pass 1 builds the dictionary line by
        line; each iteration then re-reads the file in `batch_docs`-line
        chunks and trains each chunk with the same epoch, so host memory
        stays O(chunk). A corpus that fits one chunk trains exactly as
        train() does."""
        o = self.opts
        dev = resolve_device(self.device)
        t0 = time.perf_counter()
        d = Dictionary()
        total_words = 0
        with open(path) as f:
            for line in f:
                toks = line.split()
                if o.to_lower:
                    toks = [t.lower() for t in toks]
                if toks:
                    d.add(*toks)
                    total_words += len(toks)
        self.dictionary = d
        if len(d) == 0:
            raise ValueError("empty corpus")
        counts = d.counts_array()
        valid = counts >= o.min_count
        if o.verbose:
            log.info("vocab %d (%d ≥ min_count) read in %.2fs", len(d),
                     int(valid.sum()), time.perf_counter() - t0)
        self._init_state(counts, np.random.default_rng(o.seed))
        epoch, w_in, w_out = self._epoch_fn(counts, dev)
        words_done = 0
        total_train_words = max(total_words * o.iters, 1)
        for it in range(o.iters):
            gen = self._generator(it, dev)
            chunk: list[np.ndarray] = []
            chunk_idx = 0

            def flush(words_done, chunk_idx):
                flat_c, doc_c = self._flatten_corpus(chunk)
                lr_start, words_done, lr_end = self._lr_span(
                    words_done, sum(len(c) for c in chunk),
                    total_train_words)
                if flat_c.size:
                    # a corpus that fits ONE chunk pads exactly like
                    # train(); mid-stream chunks bucket to a power of two,
                    # as the JAX package does (its lr curve depends on it)
                    single = chunk_idx == 0 and len(chunk) < batch_docs
                    d_flat, d_doc = self._device_corpus(
                        flat_c, doc_c, dev, bucket=not single)
                    n_pairs = epoch(d_flat, d_doc, lr_start, lr_end,
                                    self._draws(gen, it, chunk_idx,
                                                d_flat.shape[0]))
                    self.words_trained += int(n_pairs)
                return words_done, chunk_idx + 1

            with open(path) as f:
                for line in f:
                    ids = d.encode(line, o.to_lower)
                    if ids.size:
                        chunk.append(ids[valid[ids]])
                    if len(chunk) >= batch_docs:
                        words_done, chunk_idx = flush(words_done, chunk_idx)
                        chunk = []
            if chunk:
                words_done, chunk_idx = flush(words_done, chunk_idx)
        self._store(w_in, w_out)
        return self

    def _lr_span(self, words_done: int, n_words: int, total: int):
        """(lr at the start, words done after, lr at the end) of a span of
        n_words: linear decay over all iterations' words, floored."""
        o = self.opts
        lr_start = max(o.min_lr, o.init_lr * (1 - words_done / total))
        words_done += n_words
        lr_end = max(o.min_lr, o.init_lr * (1 - words_done / total))
        return lr_start, words_done, lr_end

    def _generator(self, it: int, dev: torch.device) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(
            self.opts.seed * 1000 + it)

    def _draws(self, gen: torch.Generator, it: int, chunk: int,
               n: int) -> EpochDraws:
        """The random inputs of one epoch call over n slots (iteration
        `it`, chunk `chunk` of it), drawn from `gen`; a block's negatives
        are drawn when the block runs."""
        o = self.opts
        dev = gen.device
        uniform = torch.rand(n, generator=gen, device=dev)
        radius = torch.randint(1, o.window + 1, (n,), generator=gen,
                               device=dev)
        negatives = None
        if o.optimizer != "hs":
            shape = (self._block_positions(), o.negative)
            negatives = lambda b: torch.randint(       # noqa: E731
                0, o.table_size, shape, generator=gen, device=dev)
        return EpochDraws(uniform, radius, negatives)

    def _epoch_fn(self, counts: np.ndarray, dev: torch.device):
        """(epoch, w_in, w_out): the tables on the device and a closure
        running `train_epoch` on them, (flat, doc_id, lr_start, lr_end,
        draws) → examples."""
        o = self.opts
        keep = torch.from_numpy(self.dictionary.keep_probs(
            o.subsample_threshold).astype(np.float32)).to(dev)
        w_in = torch.from_numpy(self.w_in).to(dev)
        w_out = torch.from_numpy(self.w_out).to(dev)
        if o.optimizer == "hs":
            tab_a = torch.from_numpy(self._paths).to(dev, torch.int64)
            tab_b = torch.from_numpy(self._codes).to(dev)
        else:
            tab_a = torch.from_numpy(self.dictionary.unigram_table(
                o.table_size)).to(dev, torch.int64)
            tab_b = None
        s_in, s_out = (torch.from_numpy(s).to(dev)
                       for s in self._static_row_scales(counts))
        bp = self._block_positions()

        def epoch(flat, doc_id, lr_start, lr_end, draws):
            return train_epoch(w_in, w_out, tab_a, tab_b, s_in, s_out,
                               flat, doc_id, keep, lr_start, lr_end, draws,
                               o, bp)
        return epoch, w_in, w_out

    def _store(self, w_in: torch.Tensor, w_out: torch.Tensor):
        self.w_in = w_in.cpu().numpy()
        self.w_out = w_out.cpu().numpy()

    def _init_state(self, counts: np.ndarray, rng: np.random.Generator):
        """w_in init + HS Huffman paths or the NS output table, from a
        built dictionary (the JAX package's numpy draw)."""
        o = self.opts
        v = len(self.dictionary)
        self.w_in = ((rng.random((v, o.dim)).astype(np.float32) - 0.5)
                     / o.dim)
        if o.optimizer == "hs":
            paths, codes, lengths = build_huffman_paths(
                counts.tolist(), o.max_depth)
            self._paths, self._codes, self._lengths = paths, codes, lengths
            self.w_out = np.zeros((max(v - 1, 1), o.dim), np.float32)
        else:
            self.w_out = np.zeros((v, o.dim), np.float32)

    # ------------------------------------------------------ example build --
    @staticmethod
    def _flatten_corpus(docs: list[np.ndarray]):
        """(flat [N] int32, doc_id [N] int32); static across iterations."""
        docs = [d for d in docs if d.size]
        if not docs:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        flat = np.concatenate(docs).astype(np.int32)
        doc_id = np.repeat(np.arange(len(docs), dtype=np.int32),
                           [d.size for d in docs])
        return flat, doc_id

    def _block_positions(self) -> int:
        """Centres per corpus block: update rows per block stay near the
        pairs-per-batch budget (batch_size)."""
        o = self.opts
        return max(o.batch_size // (2 * o.window), 64)

    def _device_corpus(self, flat: np.ndarray, doc_id: np.ndarray,
                       dev: torch.device, bucket: bool = False):
        """Pad the flat corpus to a block multiple (-1 = no word) and ship
        it as int64. bucket=True rounds the length up to bp times a power
        of two, as the JAX package does for streaming chunks: the padded
        length sets n_blocks, so the lr schedule and the draws' shapes."""
        bp = self._block_positions()
        n = flat.size
        target = -(-max(n, 1) // bp) * bp
        if bucket:
            b = bp
            while b < target:
                b *= 2
            target = b
        out = np.full((2, target), -1, np.int64)
        out[0, :n], out[1, :n] = flat, doc_id
        out = torch.from_numpy(out).to(dev)
        return out[0], out[1]

    def _static_row_scales(self, counts: np.ndarray, cap: float = 16.0):
        """Expectation-based per-row update caps (float32 numpy [V] and
        [rows of w_out]): word i appears ≈ B·p(i) times among a batch's
        input rows, a Huffman node n ≈ B·Σ_{w: n ∈ path(w)} p(w) times
        among output rows, an NS output row ≈ B·(p(i) + K·q(i)) with q
        the unigram^0.75 table law; each row's step is capped at `cap`
        examples' worth."""
        o = self.opts
        p = counts / max(counts.sum(), 1)
        B = float(o.batch_size)
        if o.model == "cbow":
            exp_in = B * 2 * o.window * p      # one hit per context slot
        else:
            exp_in = B * p                     # ctx word's input vector
        if o.optimizer == "hs":
            node_p = np.zeros(self.w_out.shape[0], np.float64)
            valid = self._paths >= 0
            np.add.at(node_p, np.maximum(self._paths, 0).ravel(),
                      (p[:, None] * valid).ravel())
            exp_out = B * node_p
        else:
            tab = self.dictionary.unigram_table(o.table_size)
            q = np.bincount(tab, minlength=len(counts)) / max(len(tab), 1)
            exp_out = B * (p + o.negative * q)
        s_in = np.minimum(1.0, cap / np.maximum(exp_in, 1.0))
        s_out = np.minimum(1.0, cap / np.maximum(exp_out, 1.0))
        return s_in.astype(np.float32), s_out.astype(np.float32)

    # --------------------------------------------------------------- export --
    def vectors(self, agg: bool = True) -> np.ndarray:
        """[V, D] float32. agg adds the output vectors for NS (the
        reference's vector.Agg path); HS exports w_in."""
        if self.w_in is None:
            raise RuntimeError("not trained")
        if agg and self.opts.optimizer == "ns":
            return self.w_in + self.w_out
        return self.w_in


def _cli(argv: Optional[Sequence[str]] = None) -> int:
    """`python -m goctr_tpu_torch.embedding.word2vec -i corpus.txt -o
    model.txt [--device cuda] ...`: the JAX package's flags (the
    reference's cobra bindings) plus --device."""
    import argparse

    p = argparse.ArgumentParser(
        prog="goctr_tpu_torch.embedding.word2vec",
        description="Train item2vec/word2vec from a text corpus "
                    "(one document per line).")
    p.add_argument("-i", "--input", required=True, help="corpus file")
    p.add_argument("-o", "--output", required=True,
                   help="output text model (`word v1..vn` per line)")
    p.add_argument("-d", "--dim", type=int, default=10)
    p.add_argument("-w", "--window", type=int, default=5)
    p.add_argument("--iter", type=int, default=15)
    p.add_argument("--min-count", type=int, default=5)
    p.add_argument("--negative", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.025)
    p.add_argument("--model", choices=("skipgram", "cbow"), default="skipgram")
    p.add_argument("--optimizer", choices=("ns", "hs"), default="ns")
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--subsample-threshold", type=float, default=1e-3)
    p.add_argument("--to-lower", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    a = p.parse_args(argv)

    if a.verbose:
        logging.basicConfig(level=logging.INFO)
    w2v = Word2Vec(Word2VecOptions(
        dim=a.dim, window=a.window, iters=a.iter, min_count=a.min_count,
        negative=a.negative, init_lr=a.lr, model=a.model,
        optimizer=a.optimizer, batch_size=a.batch_size,
        subsample_threshold=a.subsample_threshold, to_lower=a.to_lower,
        seed=a.seed, verbose=a.verbose), device=a.device)
    w2v.train_file(a.input)

    from goctr_tpu_torch.embedding.store import (
        embedding_map_from_model, save_embedding_map,
    )
    emb = embedding_map_from_model(w2v)
    save_embedding_map(a.output, emb)
    log.info("saved %d x %d vectors to %s", len(emb), emb.dim, a.output)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_cli(sys.argv[1:]))
