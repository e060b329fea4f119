"""A family that the tests add to a copy of the benchmark as a new file
(families/bags.py), sharing nothing with sparse_din: rows of dense
features and a bag of ids, the bag's table rows summed and joined to the
dense features, one linear layer to a logit, the mean log-loss, plain SGD
on every leaf; one step a batch, the batches in draw order."""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from benchmark.families import Called, Inputs, Readings, norm
from benchmark.trace import WINDOW_SPAN


def draw(config: dict, law: dict, seed: int, device) -> Inputs:
    m, n = config["model"], law["rows"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 7 + 3)
    bags = torch.randint(0, m["vocab"], (n, law["bag"]), generator=gen,
                         device=device)
    dense = torch.randn((n, m["dense"]), generator=gen, device=device)
    noise = torch.randn(n, generator=gen, device=device)
    labels = (dense[:, 0] + noise > 0).float()
    first = bags[:law["batch"]]
    share = torch.unique(first).numel() / first.numel()
    return Inputs({"dense": dense.cpu().numpy(), "bags": bags.cpu().numpy(),
                   "labels": labels.cpu().numpy()}, n, 0, share)


def initial(config: dict, law: dict, seed: int, device) -> dict:
    m = config["model"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 7 + 1)
    return {"table": 0.1 * torch.randn((m["vocab"], m["dim"]), generator=gen,
                                       device=device),
            "w": 0.1 * torch.randn(m["dim"] + m["dense"], generator=gen,
                                   device=device),
            "b": torch.zeros(1, device=device)}


def control(config: dict) -> tuple[str, str]:
    return "bfloat16", "bfloat16"


def loss(p: dict, b: dict) -> torch.Tensor:
    pooled = F.embedding_bag(b["bags"], p["table"], mode="sum")
    z = torch.cat([pooled, b["dense"]], 1) @ p["w"] + p["b"]
    return F.binary_cross_entropy_with_logits(z, b["labels"])


def step(p: dict, b: dict, lr: float):
    """(loss, {leaf: gradient}, the leaves after one SGD step)."""
    step.launches += 1
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    value = loss(leaves, b)
    grads = dict(zip(leaves,
                     torch.autograd.grad(value, list(leaves.values()))))
    return (float(value.detach()), grads,
            {k: v.detach() - lr * grads[k] for k, v in leaves.items()})


step.launches = 0


def counted_kernels() -> dict:
    return {"step": step}


def launches() -> dict:
    return {k: f.launches for k, f in counted_kernels().items()}


class Program:
    def __init__(self, config: dict, law: dict, inputs: Inputs, device):
        self.batch, self.lr = law["batch"], config["sgd"]["lr"]
        self.dev = device

    def _batch(self, arrays: dict, start: int) -> dict:
        return {k: torch.from_numpy(v[start:start + self.batch]).to(self.dev)
                for k, v in arrays.items()}

    def first_steps(self, arrays: dict, weights: dict, seed: int,
                    calls: tuple):
        p, start, losses, grad = dict(weights), 0, [], {}
        for steps in calls:
            before, call = launches(), []
            for _ in range(steps):
                value, g, p = step(p, self._batch(arrays, start), self.lr)
                grad = grad or {k: norm(v) for k, v in g.items()}
                call.append(value)
                start += self.batch
            counted = {k: v - before[k] for k, v in launches().items()}
            losses.append(sum(call) / len(call))
        change = {k: norm(p[k] - weights[k]) for k in p}
        return Readings(losses, grad, change), p, 0, counted

    def window(self, arrays: dict, epochs: int, seed: int,
               state: dict) -> Called:
        rows = next(iter(arrays.values())).shape[0]
        before, p, losses, times = launches(), state, [], []
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            for _ in range(epochs):
                e0, epoch = time.perf_counter(), []
                for s in range(0, rows, self.batch):
                    value, _, p = step(p, self._batch(arrays, s), self.lr)
                    epoch.append(value)
                losses.append(sum(epoch) / len(epoch))
                times.append(time.perf_counter() - e0)
        return Called(losses, times, 0, time.perf_counter() - t0,
                      {k: v - before[k] for k, v in launches().items()})


def warm_batches(config: dict, law: dict, inputs: Inputs, seed: int,
                 calls: tuple, device) -> list:
    b = law["batch"]
    return [{k: torch.from_numpy(v[i * b:(i + 1) * b]).to(device)
             for k, v in inputs.arrays.items()} for i in range(sum(calls))]


def flops_per_example(config: dict, law: dict) -> float:
    m = config["model"]
    return 6.0 * (m["dim"] + m["dense"]) + 3.0 * law["bag"] * m["dim"]


def needed_bytes_per_example(config: dict, law: dict,
                             inputs: Inputs) -> float:
    m = config["model"]
    rows = 2.0 * inputs.unique_share * law["bag"] * 4.0 * m["dim"]
    return rows + 8.0 * law["bag"] + 4.0 * (m["dense"] + 1)


def kernel_bytes(config: dict, law: dict) -> dict:
    return {}
