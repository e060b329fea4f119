"""The (data, model) mesh over torch.distributed ranks (port of
goctr_tpu/core/meshes.py).

The JAX package routes all parallelism through a `jax.sharding.Mesh`
with a `data` axis (batch) and a `model` axis (row-sharded embedding
tables), and writes its steps for one device of it inside `shard_map`.
The port runs the same SPMD program as one process (rank) a device: rank
r sits at mesh coordinate (r // model, r % model), the order
`np.asarray(devices).reshape(d, m)` gives in JAX. A `Mesh` holds the axis
sizes, this rank's device and coordinates, and two process groups: the
model group (the ranks that share this rank's data index; `psum` over
`model` runs in it) and the data group (the ranks that share its model
index; `psum` and `all_gather` over `data` run in it). An axis of size 1
keeps no group and its collectives are the identity, so the 1×1 mesh,
which needs no process group at all, runs the single-device code as it
was.

The backend is the caller's: NCCL when each rank has its own card, gloo
on the CPU (or, to stage the collectives through the host, for ranks that
share one card). Gloo refuses CUDA tensors in some collectives, so the
helpers here stage a CUDA tensor through pinned host memory whenever the
backend is gloo; nothing is retried on another backend after a failure.
NCCL with two ranks on one device is refused before it starts.

`launch` runs a function on n local ranks (the `spawn` start method,
127.0.0.1 and a free port): each rank initializes the process group with
a finite timeout, a rank that fails or a run that outlasts its time kills
every rank, and the error reports each failed rank's traceback.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from goctr_tpu_torch.core.dtypes import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)
# seconds a collective may wait for its peers before it fails
DIST_TIMEOUT_S = 600.0


def data_axis() -> str:
    return DATA_AXIS


def model_axis() -> str:
    return MODEL_AXIS


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to slice the device set into (data, model) axes."""

    data: int = -1  # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        if n_devices % model != 0:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"model={model}")
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh: its axis sizes, this rank's device and rank,
    and the process groups of its axes (None for an axis of size 1)."""

    data: int
    model: int
    device: torch.device
    rank: int = 0
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)
    backend: Optional[str] = None

    def __post_init__(self):
        if self.data < 1 or self.model < 1 or not (
                0 <= self.rank < self.data * self.model):
            raise ValueError(f"rank {self.rank} is not on a {self.data}x"
                             f"{self.model} mesh")
        for axis, group in ((DATA_AXIS, self.data_group),
                            (MODEL_AXIS, self.model_group)):
            if (group is None) != (self.shape[axis] == 1):
                raise ValueError(f"the {axis} axis of size "
                                 f"{self.shape[axis]} needs a process group "
                                 "exactly when it is above 1")

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as `jax.sharding.Mesh.shape` gives them."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (data, model) coordinate."""
        return divmod(self.rank, self.model)

    def index(self, axis: str) -> int:
        """This rank's index along `axis` (`jax.lax.axis_index`)."""
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return {DATA_AXIS: self.data_group,
                MODEL_AXIS: self.model_group}[axis]


def _check_nccl_devices(devices: Sequence[torch.device]) -> None:
    """NCCL runs one rank a card: two ranks on one device is an error."""
    seen: dict[torch.device, int] = {}
    for r, dev in enumerate(devices):
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend needs a CUDA device a rank; "
                             f"rank {r} is on {dev}")
        if dev in seen:
            raise ValueError(f"the NCCL backend runs one rank a card: ranks "
                             f"{seen[dev]} and {r} both name {dev}; give "
                             "each rank its own card, or use gloo")
        seen[dev] = r


def _devices(devices, world: int) -> list[torch.device]:
    if devices is None:
        resolve_device("cuda")
        n = torch.cuda.device_count()
        return [torch.device("cuda", r % n) for r in range(world)]
    return [torch.device(x) for x in devices]


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[str | torch.device]] = None
              ) -> Mesh:
    """The mesh over the default process group's ranks (one rank without a
    process group). `devices` names each rank's device in rank order
    (default: the cards, rank r on card r mod count); the spec must
    resolve against their number, and that number must be the world's.
    Every rank must call this in the same order: it creates the axes'
    process groups."""
    spec = spec or MeshSpec()
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    devices = _devices(devices, world)
    d, m = spec.resolve(len(devices))
    if d * m != world:
        raise ValueError(f"a {d}x{m} mesh needs {d * m} ranks; the process "
                         f"group has {world}")
    dev = resolve_device(devices[rank])
    if world == 1:
        return Mesh(1, 1, dev)
    backend = dist.get_backend()
    if backend == "nccl":
        _check_nccl_devices(devices)
    data_group = model_group = None
    # every rank creates every group, in the same order
    if m > 1:
        for i in range(d):
            g = dist.new_group(list(range(i * m, (i + 1) * m)))
            if i == rank // m:
                model_group = g
    if d > 1:
        for j in range(m):
            g = dist.new_group(list(range(j, world, m)))
            if j == rank % m:
                data_group = g
    return Mesh(d, m, dev, rank, data_group, model_group, backend)


def single_device_mesh(device: str | torch.device = "cuda") -> Mesh:
    return Mesh(1, 1, resolve_device(device))


# ------------------------------------------------------------ collectives --

def _staged(x: torch.Tensor, mesh: Mesh) -> bool:
    """Gloo takes host tensors: a CUDA tensor goes through pinned host
    memory (named by the backend, not found by a failure)."""
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x
    if _staged(x, mesh):
        h = _to_host(x.contiguous())
        dist.all_reduce(h, group=group)
        return h.to(x.device)
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _PSum(torch.autograd.Function):
    """psum whose backward is the identity, the transpose JAX gives a
    psum inside shard_map: each rank's cotangent flows back to its own
    contribution."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over the ranks of `axis` (`jax.lax.psum`); x itself on
    an axis of size 1. Differentiable: its backward is the identity."""
    if mesh.group(axis) is None:
        return x
    return _PSum.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ranks' x of `axis` concatenated along dim 0 in axis-index order
    (`jax.lax.all_gather(..., tiled=True)`); x itself on an axis of size
    1. Every rank's x has the same shape."""
    group = mesh.group(axis)
    if group is None:
        return x
    src = _to_host(x.contiguous()) if _staged(x, mesh) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (a no-op on one rank)."""
    if mesh.size > 1:
        dist.barrier()


# -------------------------------------------------------------- placements --

@dataclasses.dataclass(frozen=True)
class Placement:
    """How a global tensor lies on the mesh: dim 0 split over `axis` in
    axis-index order, or whole on every rank (axis None)."""

    mesh: Mesh
    axis: Optional[str] = None

    def span(self, n: int, multiple: int = 1) -> tuple[int, int]:
        """(start, size) of this rank's part of a dim 0 of n rows padded
        to a multiple of (shards · multiple) rows: the global rows from
        `start` on, zero rows past n. One shard holds the n rows
        unpadded."""
        k = 1 if self.axis is None else self.mesh.shape[self.axis]
        if k == 1:
            return 0, n
        size = -(-n // (k * multiple)) * multiple
        return self.mesh.index(self.axis) * size, size

    def local(self, x: torch.Tensor, multiple: int = 0) -> torch.Tensor:
        """This rank's part of the global tensor x: with multiple = 0 dim 0
        must split evenly; with multiple >= 1 it is padded with zeros as
        `span` says."""
        if self.axis is None:
            return x
        n = x.shape[0]
        if not multiple:
            k = self.mesh.shape[self.axis]
            if n % k:
                raise ValueError(f"dim 0 of {n} does not split over {k} "
                                 f"{self.axis} shards; pad it first")
            multiple = 1
        r0, size = self.span(n, multiple)
        r0, r1 = min(r0, n), min(r0 + size, n)
        if r1 - r0 == size:
            return x[r0:r1]
        out = x.new_zeros((size,) + tuple(x.shape[1:]))
        out[:r1 - r0] = x[r0:r1]
        return out

    def gather(self, x: torch.Tensor, n: Optional[int] = None
               ) -> torch.Tensor:
        """The global tensor from every rank's part, cut to its first n
        rows (the padding `local` added)."""
        if self.axis is not None:
            x = all_gather(x.contiguous(), self.mesh, self.axis)
        return x[:n]


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh)


def batch_sharded(mesh: Mesh) -> Placement:
    """The leading (batch) dim split over the data axis."""
    return Placement(mesh, DATA_AXIS)


def row_sharded(mesh: Mesh) -> Placement:
    """The leading (vocab-row) dim split over the model axis."""
    return Placement(mesh, MODEL_AXIS)


# ---------------------------------------------------------------- bring-up --

def _backend(device: str | torch.device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device!r}")


def maybe_initialize_distributed(device: str | torch.device = "cuda"
                                 ) -> None:
    """Multi-host bring-up: call once a process before building meshes.
    With GOCTR_COORDINATOR (host:port of rank 0), GOCTR_NUM_PROCESSES and
    GOCTR_PROCESS_ID set, join the process group over
    tcp://<coordinator>: NCCL for "cuda" (rank r on card r mod count),
    gloo for "cpu". A no-op without GOCTR_COORDINATOR."""
    coordinator = os.environ.get("GOCTR_COORDINATOR")
    if not coordinator:
        return
    backend = _backend(device)
    n = int(os.environ.get("GOCTR_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("GOCTR_PROCESS_ID", "0"))
    if backend == "nccl":
        resolve_device("cuda")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, device, backend, inbox, timeout, results):
    try:
        args = inbox.get()
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def launch(fn: Callable, n: int, devices: Sequence[str | torch.device],
           backend: str, args: tuple = (), timeout: float = DIST_TIMEOUT_S
           ) -> list:
    """Run fn(*args) on n local ranks over `backend` ("gloo" or "nccl"),
    rank r on devices[r], and return each rank's (picklable) result in
    rank order. fn must be importable by name (a module-level function of
    an installed module): the ranks are spawned. A rank that raises or
    dies, or a run past `timeout` seconds, kills every rank and raises
    with each failed rank's traceback."""
    import multiprocessing as mp

    devices = [torch.device(x) for x in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl":
        _check_nccl_devices(devices)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # the arguments go through a queue: a start blocks until the child has
    # read what it is started with, which it does after importing fn's
    # module, so ranks started with large arguments would start in turn
    inbox = ctx.Queue()
    inbox.cancel_join_thread()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, n, port, str(devices[r]), backend, inbox, timeout, results))
        for r in range(n)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put(args)
    done: dict[int, Any] = {}
    failed: dict[int, str] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < n and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                failed.update({r: f"still running after {timeout:.0f} s"
                               for r in range(n) if r not in done})
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        failed[r] = (f"exited with code {p.exitcode} "
                                     "without a result")
                continue
            if ok:
                done[rank] = out
            else:
                failed[rank] = out
    finally:
        for p in procs:
            if p.is_alive() and failed:
                p.kill()
        for p in procs:
            p.join(timeout=30 if not failed else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError(f"{len(failed)} of {n} ranks failed:\n" + "\n".join(
            f"--- rank {r}:\n{msg}" for r, msg in sorted(failed.items())))
    return [done[r] for r in range(n)]
