"""The one traffic generator: a planted-parity click log drawn on the device
from a seed, with the law of the JAX bench's draw (frozen copy of
goctr_tpu_torch/bench.py `make_workload` and `_zipf_ranks`), rewritten in
torch so that a run draws millions of rows in a fraction of a second.

A traffic file (`traffic/<name>.json`) gives the sizes and the law's
parameters; the model configuration gives the vocabulary and the dense
widths. Each row: a user (one of rows / rows_per_user users, each with a
taste parity), T behavior ids of which a share `p_taste` carry the
user's taste parity, one candidate item id, U profile and C context
floats in [0, 1), and a label. Ids are 2·slot + parity, the slot drawn
from a bounded zipf over ranks scattered across the id space by a fixed
multiplicative hash (`ids: zipf`), or uniformly (`ids: uniform`). With
`noisy`, the label is 1 with probability p_rule if the item's parity is
the user's taste (1 - p_rule if not), plus hot_bonus for the top
`hot_share` of ranks and minus cold_malus for the rest, clipped to
p_clip; without it the label is the rule itself. No behavior is padded.

The same seed gives the same rows on the same kind of device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Knuth's multiplicative hash (odd, coprime with every even half-vocab)
PRIME = 2_654_435_761
# rows drawn at a time: bounds the float64 temporaries of the zipf draw
CHUNK_ROWS = 1 << 20


@dataclasses.dataclass
class Draw:
    """One draw, on the device it was drawn on."""
    user_profile: torch.Tensor     # [N, U] float32
    behavior_ids: torch.Tensor     # [N, T] int32
    item_ids: torch.Tensor         # [N] int32
    ctx: torch.Tensor              # [N, C] float32
    labels: torch.Tensor           # [N] float32
    taste: torch.Tensor            # [N] int64, the row's user's parity

    @property
    def rows(self) -> int:
        return self.item_ids.shape[0]

    def host(self) -> dict:
        """The five arrays the trainer takes, as NumPy arrays."""
        return {k: getattr(self, k).cpu().numpy() for k in
                ("user_profile", "behavior_ids", "item_ids", "ctx",
                 "labels")}


def zipf_ranks(u: torch.Tensor, n_ranks: int, s: float) -> torch.Tensor:
    """Bounded-zipf ranks in [0, n_ranks) from uniforms u (float64):
    P(r) ≈ (r+1)^-s, the closed-form inverse CDF of the continuous
    bounded power law."""
    t = float(n_ranks) ** (1.0 - s)
    x = (1.0 - u * (1.0 - t)) ** (1.0 / (1.0 - s))
    return (x.to(torch.int64) - 1).clamp(0, n_ranks - 1)


def _ids(gen: torch.Generator, shape, half: int, law: dict):
    """(slot, rank) int64 tensors of `shape`."""
    dev = gen.device
    if law["ids"] == "zipf":
        u = torch.rand(shape, generator=gen, dtype=torch.float64,
                       device=dev)
        r = zipf_ranks(u, half, law["zipf_s"])
        return (r * PRIME) % half, r
    if law["ids"] == "uniform":
        v = torch.randint(0, half, shape, generator=gen, device=dev)
        return v, v
    raise ValueError(f"unknown id law {law['ids']!r}")


def draw(law: dict, vocab: int, u_dim: int, c_dim: int, seed: int,
         device: str | torch.device) -> Draw:
    """`law['rows']` rows of the traffic `law` over `vocab` ids."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 4 + 2)
    n, t = int(law["rows"]), int(law["t"])
    half = vocab // 2
    users = max(n // int(law["rows_per_user"]), 1)
    user_taste = torch.randint(0, 2, (users,), generator=gen, device=dev)
    uids = torch.randint(0, users, (n,), generator=gen, device=dev)
    taste = user_taste[uids]
    bids = torch.empty((n, t), dtype=torch.int32, device=dev)
    iids = torch.empty(n, dtype=torch.int32, device=dev)
    labels = torch.empty(n, dtype=torch.float32, device=dev)
    lo, hi = law["p_clip"]
    for s in range(0, n, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, n)
        m, ts = e - s, taste[s:e]
        b_slot, _ = _ids(gen, (m, t), half, law)
        b_alt, _ = _ids(gen, (m, t), half, law)
        coin = torch.rand((m, t), generator=gen, device=dev)
        alt_par = torch.randint(0, 2, (m, t), generator=gen, device=dev)
        bids[s:e] = torch.where(coin < law["p_taste"],
                                b_slot * 2 + ts[:, None],
                                b_alt * 2 + alt_par).to(torch.int32)
        i_slot, i_rank = _ids(gen, (m,), half, law)
        item = i_slot * 2 + torch.randint(0, 2, (m,), generator=gen,
                                          device=dev)
        iids[s:e] = item.to(torch.int32)
        parity = (item % 2) == ts
        if law["noisy"]:
            hot = i_rank < max(int(half * law["hot_share"]), 1)
            p_pos = (torch.where(parity, law["p_rule"], 1 - law["p_rule"])
                     + torch.where(hot, law["hot_bonus"],
                                   -law["cold_malus"])).clamp(lo, hi)
            labels[s:e] = (torch.rand(m, generator=gen, device=dev)
                           < p_pos).float()
        else:
            labels[s:e] = parity.float()
    prof = torch.rand((n, u_dim), generator=gen, device=dev)
    ctx = torch.rand((n, c_dim), generator=gen, device=dev)
    return Draw(prof, bids, iids, ctx, labels, taste)


def batch_ids(d: Draw, b: int, batch: int) -> torch.Tensor:
    """The ids of batch b in draw order (behaviors then items), int64."""
    sl = slice(b * batch, (b + 1) * batch)
    return torch.cat([d.behavior_ids[sl].reshape(-1),
                      d.item_ids[sl]]).long()


def unique_share(d: Draw, batch: int, batches: int = 4) -> float:
    """Mean share of a batch's ids that are distinct, over the draw's
    first `batches` batches of the cell's size."""
    k = max(1, min(batches, d.rows // batch))
    shares = []
    for b in range(k):
        ids = batch_ids(d, b, batch)
        shares.append(torch.unique(ids).numel() / ids.numel())
    return float(np.mean(shares))


def compact_cap(d: Draw, batch: int) -> int:
    """The JAX bench's auto compact_cap (frozen copy of bench.py
    `bench_compact_cap`): the first batch's distinct ids + 15%, rounded
    up to a multiple of 1024."""
    uniq0 = torch.unique(batch_ids(d, 0, batch)).numel()
    return -(-int(uniq0 * 1.15) // 1024) * 1024
