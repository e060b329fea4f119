"""Training steps that promise not to make the host wait on the card, on
the CPU: a dispatch recorder (`Waits`) flags every operation that waits
for the card on a CUDA tensor — `nonzero`, `masked_select`, indexing by
a boolean mask, `_local_scalar_dense` (`.item()`, `int()`, `float()`),
`unique*` and `repeat_interleave` without `output_size` — and one step
of each path that runs the same code on the CPU as on the card (the
scanned trainer's and the 1×1 mesh step's dedup, sorted and plain modes,
and the capped lookup's `_dedup_flat`) must call none after its first
call. The kernel modes run their kernels' plain versions here, which may
use such operations, and are held on the card instead
(tests/test_torch_cuda.py, chip_smoke.py's [sync] phase).

`scatter_add_rows` drops ids outside the table without a mask: held bit
for bit to numpy's ordered `np.add.at` over the kept entries, with NaN
and Inf rows at the dropped ids, +0.0 and -0.0 in the table, and ids
whose kept rows are all -0.0 (where a +0.0 in place of a dropped row
would show).
`_dedup_flat` writes its overflow slots into one extra slot: held bit for
bit to the masked version it replaced (kept below), at caps below, at
and above the unique count. Everything here is exact.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from goctr_tpu_torch.ops.scatter import scatter_add_rows
from goctr_tpu_torch.parallel.embedding import _dedup_flat
from goctr_tpu_torch.parallel.step_cases import step_cases

WAITS = ("nonzero", "masked_select", "_local_scalar_dense",
         "repeat_interleave")


class Waits(TorchDispatchMode):
    """Records the operations that make the host wait on a CUDA tensor."""

    def __init__(self):
        super().__init__()
        self.seen: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name == "repeat_interleave" and kwargs.get("output_size"):
            pass
        elif name in WAITS or name.lstrip("_").startswith("unique"):
            self.seen.append(name)
        elif name == "index" and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.seen.append("index with a boolean mask")
        return func(*args, **kwargs)


def mask_scatter_add_rows(table, ids, rows):
    """scatter_add_rows as it was: the dropped ids cut by a boolean mask."""
    keep = (ids >= 0) & (ids < table.shape[0])
    ids, rows = ids[keep].long(), rows[keep]
    if table.device.type == "cpu":
        return table.index_add_(0, ids, rows)
    return table.index_put_((ids,), rows, accumulate=True)


def mask_dedup_flat(flat, cap):
    """_dedup_flat as it was: slots past the cap cut by a boolean mask."""
    s, order = torch.sort(flat, stable=True)
    new = torch.cat([torch.ones(1, dtype=torch.bool, device=flat.device),
                     s[1:] != s[:-1]])
    slot_sorted = torch.cumsum(new, 0) - 1
    keep = slot_sorted < cap
    uniq = flat.new_full((cap,), -1)
    uniq[slot_sorted[keep]] = s[keep]
    inv = torch.empty_like(slot_sorted)
    inv[order] = slot_sorted
    return uniq, inv, slot_sorted[-1] + 1


@pytest.mark.parametrize("what", ["mask", "float", "nonzero", "unique",
                                  "repeat_interleave"])
def test_recorder_flags_the_waits(what):
    """Controls: the recorder sees each kind of wait, today's mask among
    them, and lets repeat_interleave with output_size pass."""
    x = torch.arange(10)
    calls = {
        "mask": lambda: mask_scatter_add_rows(
            torch.zeros(4, 2), x - 3, torch.ones(10, 2)),
        "float": lambda: float(x.sum()),
        "nonzero": lambda: torch.nonzero(x > 3),
        "unique": lambda: torch.unique(x),
        "repeat_interleave": lambda: torch.repeat_interleave(x, x),
    }
    with Waits() as w:
        calls[what]()
    assert w.seen
    with Waits() as w:
        torch.repeat_interleave(x, x, output_size=45)
        scatter_add_rows(torch.zeros(4, 2), x - 3, torch.ones(10, 2))
    assert w.seen == []


MODEL = dict(item_vocab=500, emb_dim=16, u_profile_dim=4, ctx_dim=3,
             behavior_len=5, hidden=(16, 8), activation="relu")
RANKER = dict(u_profile_dim=4, behavior_len=3, behavior_dim=4,
              i_feature_dim=4, c_feature_dim=3)
CASES = dict(step_cases("cpu", MODEL, dict(MODEL, emb_dim=8), RANKER, 64))
SAME_CODE = ["scanned dedup", "scanned sorted", "scanned plain",
             "mesh dedup", "mesh sorted", "mesh plain", "dedup_flat"]


@pytest.mark.parametrize("name", SAME_CODE)
def test_step_never_waits(name):
    step = CASES[name]()
    step()                              # first call: caches fill
    with Waits() as w:
        step()
    assert w.seen == [], f"{name} waits on the card: {w.seen}"


def _stream(kind: str, rng, v: int, n: int):
    """(ids, dropped) of a scatter stream: ids below 0 and at or past v
    among in-range ids with a hot id; as the sorted mode gives them (-1
    pads first, then ascending); or as the mesh's stage 4 (distinct
    ascending ids, most slots past the shard)."""
    if kind == "interleaved":
        ids = rng.integers(-3, v + 3, n)
        ids[rng.random(n) < 0.3] = 7
    elif kind == "pads first":
        ids = np.sort(np.where(rng.random(n) < 0.25, -1,
                               rng.integers(0, v, n)))
    else:
        real = np.sort(rng.choice(v, v // 2, replace=False))
        ids = np.concatenate([real, v + 1 + np.arange(n - real.size)])
    return ids.astype(np.int32), (ids < 0) | (ids >= v)


@pytest.mark.parametrize("d", [1, 16, 64])
@pytest.mark.parametrize("kind", ["interleaved", "pads first", "stage 4"])
def test_scatter_add_rows_equals_ordered_add_at(kind, d):
    rng = np.random.default_rng(3)
    v, n = 300, 20_000
    ids, dropped = _stream(kind, rng, v, n)
    rows = rng.normal(0, 1, (n, d)).astype(np.float32)
    rows[ids % 5 == 0] = -0.0           # ids whose sums stay -0.0
    rows[dropped] = rng.choice(np.array([np.nan, np.inf, -np.inf, 1e30],
                                        np.float32), (dropped.sum(), d))
    table = rng.normal(0, 1, (v, d)).astype(np.float32)
    zero = rng.random((v, d))
    table[zero < 0.1] = 0.0
    table[zero > 0.9] = -0.0
    want = table.copy()
    np.add.at(want, ids[~dropped], rows[~dropped])
    got = scatter_add_rows(torch.from_numpy(table.copy()),
                           torch.from_numpy(ids), torch.from_numpy(rows))
    assert dropped.any() and (~dropped).any()
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("cap", [8, 60, 61, 200])
def test_dedup_flat_equals_the_mask_version(cap):
    """61 unique ids (-1 among them) in 400: caps below, one below, at
    and above the unique count."""
    rng = np.random.default_rng(cap)
    flat = rng.permutation(np.concatenate([np.arange(-1, 60),
                                           rng.integers(-1, 60, 339)]))
    flat = torch.from_numpy(flat.astype(np.int32))
    for got, want in zip(_dedup_flat(flat, cap), mask_dedup_flat(flat, cap)):
        assert got.dtype == want.dtype and torch.equal(got, want)
