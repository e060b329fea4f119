"""Minibatch solvers (port of goctr_tpu/optim/optimizers.py:28-70).

The JAX package builds each solver as an optax chain:

    add_decayed_weights(l2)  →  core  →  add_decayed_weights(weight_decay)
    →  scale(-lr) or scale_by_schedule(-schedule)

(l2 is classic L2, added to the gradient before the adaptive scaling;
weight_decay is decoupled, added after it). Here each link is a plain
function on tensors with optax's formulas in optax's order, and no
`torch.optim` is involved. A solver's state is a flat list of tensors
that maps one-to-one, in order, onto `jax.tree.leaves(solver.init(params))`
of the JAX solver for the same parameters, so an `opt_state.npz` written
by either package resumes in the other. Parameters, gradients and updates
are lists of tensors in JAX leaf order (for SparseCTR: att0, bias.*,
mlp.*, see SparseCTR.param_leaves).

Cores (optax names): sgd = trace(momentum) (identity when momentum is 0),
adam = scale_by_adam, adagrad = scale_by_rss(initial 0), rmsprop =
scale_by_rms, adadelta = scale_by_adadelta. Step counts are int32 scalar
tensors on the parameters' device, so an update never syncs the host.
lbfgs, a full-batch method, comes with the MLPClassifier slice.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

SOLVERS = ("sgd", "adam", "adagrad", "rmsprop", "adadelta", "lbfgs")
_I32_MAX = 2 ** 31 - 1

Tensors = list[torch.Tensor]


def _count(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=like.device)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax.safe_increment: +1, saturating at the int32 maximum."""
    return torch.where(count < _I32_MAX, count + 1, count)


def _moment(g: torch.Tensor, t: torch.Tensor, decay: float, order: int):
    """optax.tree.update_moment: (1 - decay) · g^order + decay · t."""
    return (1 - decay) * (g if order == 1 else g * g) + decay * t


def _bias_correction(t: torch.Tensor, decay: float, count: torch.Tensor):
    return t / (1 - decay ** count).to(t.dtype)


class _Link:
    """One link of the chain: `init` gives its state leaves, `update`
    maps (updates, its state, params) to (updates, its new state)."""

    def n_state(self, k: int) -> int:
        """State leaves for k parameter leaves."""
        return 0

    def init(self, params: Tensors) -> Tensors:
        return []

    def update(self, g: Tensors, state: Tensors, params: Tensors):
        raise NotImplementedError


class _AddDecayedWeights(_Link):
    def __init__(self, rate: float):
        self.rate = rate

    def update(self, g, state, params):
        return [u + self.rate * p for u, p in zip(g, params)], state


class _Identity(_Link):
    def update(self, g, state, params):
        return g, state


class _Trace(_Link):
    def __init__(self, decay: float, nesterov: bool):
        self.decay, self.nesterov = decay, nesterov

    def n_state(self, k):
        return k

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, g, state, params):
        tr = [u + self.decay * t for u, t in zip(g, state)]
        if self.nesterov:
            return [u + self.decay * t for u, t in zip(g, tr)], tr
        return tr, tr


class _ScaleByAdam(_Link):
    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def n_state(self, k):
        return 1 + 2 * k

    def init(self, params):
        return ([_count(params[0])] + [torch.zeros_like(p) for p in params]
                + [torch.zeros_like(p) for p in params])

    def update(self, g, state, params):
        k = len(g)
        count, mu, nu = state[0], state[1:1 + k], state[1 + k:]
        mu = [_moment(u, m, self.b1, 1) for u, m in zip(g, mu)]
        nu = [_moment(u, v, self.b2, 2) for u, v in zip(g, nu)]
        count = _increment(count)
        out = [_bias_correction(m, self.b1, count)
               / (torch.sqrt(_bias_correction(v, self.b2, count)) + self.eps)
               for m, v in zip(mu, nu)]
        return out, [count] + mu + nu


class _ScaleByRss(_Link):
    """optax.scale_by_rss(initial_accumulator_value=0)."""

    def __init__(self, eps: float):
        self.eps = eps

    def n_state(self, k):
        return k

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, g, state, params):
        sos = [u * u + t for u, t in zip(g, state)]
        out = [torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0) * u
               for s, u in zip(sos, g)]
        return out, sos


class _ScaleByRms(_Link):
    """optax.scale_by_rms(initial_scale=0, eps inside the sqrt, no bias
    correction)."""

    def __init__(self, decay: float, eps: float):
        self.decay, self.eps = decay, eps

    def n_state(self, k):
        return k

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, g, state, params):
        nu = [_moment(u, t, self.decay, 2) for u, t in zip(g, state)]
        return [torch.rsqrt(n + self.eps) * u for n, u in zip(nu, g)], nu


class _ScaleByAdadelta(_Link):
    def __init__(self, rho: float, eps: float):
        self.rho, self.eps = rho, eps

    def n_state(self, k):
        return 2 * k

    def init(self, params):
        return ([torch.zeros_like(p) for p in params]
                + [torch.zeros_like(p) for p in params])

    def update(self, g, state, params):
        k = len(g)
        e_g = [_moment(u, t, self.rho, 2) for u, t in zip(g, state[:k])]
        out = [torch.sqrt(x + self.eps) / torch.sqrt(e + self.eps) * u
               for u, e, x in zip(g, e_g, state[k:])]
        e_x = [_moment(u, t, self.rho, 2) for u, t in zip(out, state[k:])]
        return out, e_g + e_x


class _Scale(_Link):
    def __init__(self, step: float):
        self.step = step

    def update(self, g, state, params):
        return [self.step * u for u in g], state


class _ScaleBySchedule(_Link):
    def __init__(self, fn: Callable):
        self.fn = fn

    def n_state(self, k):
        return 1

    def init(self, params):
        return [_count(params[0])]

    def update(self, g, state, params):
        step = self.fn(state[0])
        if isinstance(step, torch.Tensor):
            out = [step.to(u.dtype) * u for u in g]
        else:
            out = [step * u for u in g]
        return out, [_increment(state[0])]


class Solver:
    """A chain of links; state is the concatenation of their leaves."""

    def __init__(self, links: Sequence[_Link]):
        self.links = list(links)

    def init(self, params: Sequence[torch.Tensor]) -> Tensors:
        params = [p.detach() for p in params]
        return [s for link in self.links for s in link.init(params)]

    def update(self, grads: Sequence[torch.Tensor], state: Sequence[
            torch.Tensor], params: Sequence[torch.Tensor]
               ) -> tuple[Tensors, Tensors]:
        """(updates to add to the params, new state)."""
        params = [p.detach() for p in params]
        if len(state) != sum(link.n_state(len(params)) for link in self.links):
            raise ValueError(f"solver state has {len(state)} leaves; this "
                             "solver's has a different number")
        g, rest, new_state = list(grads), list(state), []
        for link in self.links:
            n = link.n_state(len(params))
            g, s = link.update(g, rest[:n], params)
            new_state += s
            rest = rest[n:]
        return g, new_state


def make_solver(name: str = "adam",
                lr: Union[float, Callable] = 1e-3, *,
                l2: float = 0.0, weight_decay: float = 0.0,
                momentum: float = 0.9, nesterov: bool = False,
                beta1: float = 0.9, beta2: float = 0.999,
                epsilon: float = 1e-8, rho: float = 0.95) -> Solver:
    name = name.lower()
    core: Optional[_Link]
    if name == "sgd":
        core = _Trace(momentum, nesterov) if momentum else _Identity()
    elif name == "adam":
        core = _ScaleByAdam(beta1, beta2, epsilon)
    elif name == "adagrad":
        core = _ScaleByRss(epsilon)
    elif name == "rmsprop":
        core = _ScaleByRms(rho, epsilon)
    elif name == "adadelta":
        core = _ScaleByAdadelta(rho, epsilon)
    elif name == "lbfgs":
        raise NotImplementedError(
            "lbfgs is a full-batch method; it comes with the MLPClassifier "
            "slice of goctr_tpu_torch (ROADMAP A6)")
    else:
        raise ValueError(f"unknown solver {name!r}; one of {SOLVERS}")
    chain: list[_Link] = []
    if l2:
        chain.append(_AddDecayedWeights(l2))       # classic L2 (pre-scale)
    chain.append(core)
    if weight_decay:
        chain.append(_AddDecayedWeights(weight_decay))  # decoupled
    if callable(lr):
        chain.append(_ScaleBySchedule(lambda step: -lr(step)))
    else:
        chain.append(_Scale(-lr))
    return Solver(chain)
