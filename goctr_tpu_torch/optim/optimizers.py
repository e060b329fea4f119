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

Full-batch methods (port of goctr_tpu/optim/optimizers.py:73-201, the
reference's gonum lbfgs / bfgs / cg): `fullbatch_minimize` drives one of
FULLBATCH_SOLVERS over a whole training loss. lbfgs is optax 0.2.6's
`optax.lbfgs()` with its defaults (`LBFGS`: memory 10, the scaled initial
preconditioner, a zoom line search of at most 20 steps from a unit
guess), written on tensors; its state, too, is a flat list in JAX leaf
order. bfgs and cg work on the parameters flattened in `ravel_pytree`'s
order (dict keys sorted, lists in order), with an Armijo backtracking
search (c1 1e-4, at most 30 halvings). They branch on scalars on the
host, so each line-search trial syncs once.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

SOLVERS = ("sgd", "adam", "adagrad", "rmsprop", "adadelta", "lbfgs")
# full-batch second-order / line-search methods (the reference's gonum
# optimize.Method registry)
FULLBATCH_SOLVERS = ("lbfgs", "bfgs", "cg")
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
                epsilon: float = 1e-8, rho: float = 0.95
                ) -> Union[Solver, "LBFGS"]:
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
        # full-batch: driven by fullbatch_minimize, as in the JAX package
        return LBFGS()
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


# ----------------------------------------------------------- full batch --

Tree = Union[torch.Tensor, dict, list, tuple]


def tree_leaves(tree: Tree) -> Tensors:
    """The tensors of a nest of dicts, lists and tuples in JAX leaf order
    (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [x for t in tree for x in tree_leaves(t)]


def tree_unflatten(tree: Tree, leaves: Sequence[torch.Tensor]) -> Tree:
    """`tree`'s structure with `leaves` (in tree_leaves order) in place of
    its tensors."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return type(t)(build(x) for x in t)
    return build(tree)


def _vdot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]):
    """optax.tree.vdot: per-leaf dot products summed in leaf order."""
    return sum(torch.dot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b))


def _value_and_grad(fn: Callable, leaves: Sequence[torch.Tensor]):
    """(fn(leaves) detached, its gradient leaves); grad mode on whatever
    the caller set."""
    xs = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        v = fn(xs)
        gs = torch.autograd.grad(v, xs, allow_unused=True,
                                 materialize_grads=True)
    return v.detach(), list(gs)


def _host(x) -> torch.Tensor:
    """A float32 scalar on the host (one sync for a device scalar)."""
    return torch.as_tensor(x, dtype=torch.float32).detach().to("cpu")


def _nan_to_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.inf, x)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimiser of the cubic through (a, fa, fpa), (b, fb), (c, fc)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    e1, e2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * e1 + -(db ** 2) * e2) / denom
    B = (-(dc ** 3) * e1 + db ** 3 * e2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimiser of the quadratic through (a, fa, fpa), (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _ZoomLinesearch:
    """optax.scale_by_zoom_linesearch's search (optax 0.2.6,
    `_src/linesearch.py`) with `lbfgs()`'s settings: at most
    `max_steps` trials, a first guess of 1, tol 0, increase factor 2,
    slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, interval
    threshold 1e-5, no maximal step. Scalars live on the host as float32
    tensors, so the branches are the JAX version's `where`s taken in
    Python; vectors stay on the parameters' device."""

    SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
    INCREASE, THRESHOLD, TOL = 2.0, 1e-5, 0.0

    def __init__(self, max_steps: int):
        self.max_steps = max_steps

    def run(self, value_and_grad: Callable, params: Tensors,
            updates: Tensors, value, grad: Tensors):
        """(stepsize, value, grad, trials, decrease_error,
        curvature_error) at the step the search settles on."""
        self.vg, self.params, self.updates = value_and_grad, params, updates
        v0 = _host(value)
        s0 = _host(_vdot(updates, grad))
        zero = _host(0.0)
        self.value_init, self.slope_init = v0, s0
        self.count, self.stepsize = 0, zero
        self.value, self.grad, self.slope = v0, grad, s0
        self.decrease_error = self.curvature_error = _host(torch.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = zero, v0, s0
        self.high, self.value_high, self.slope_high = zero, v0, s0
        self.cubic_ref, self.value_cubic_ref = zero, v0
        self.safe_stepsize, self.safe_value, self.safe_grad = zero, v0, grad
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
            if self.failed:
                self._try_safe_step()
        return (self.stepsize, self.value, self.grad, self.count,
                self.decrease_error, self.curvature_error)

    def _on_line(self, t):
        step = [p + t * u for p, u in zip(self.params, self.updates)]
        v, g = self.vg(step)
        return _host(v), g, _host(_vdot(g, self.updates))

    def _errors(self, t, v, s):
        dec = v - self.value_init - self.SLOPE_RTOL * t * self.slope_init
        approx = s - (2 * self.SLOPE_RTOL - 1.0) * self.slope_init
        delta = (v - self.value_init
                 - self.APPROX_DEC_RTOL * torch.abs(self.value_init))
        dec = torch.minimum(torch.maximum(approx, delta), dec)
        dec = _nan_to_inf(torch.clamp(dec, min=0.0))
        curv = torch.abs(s) - self.CURV_RTOL * torch.abs(self.slope_init)
        curv = _nan_to_inf(torch.clamp(curv, min=0.0))
        return dec, curv, torch.maximum(dec, curv)

    def _settle(self, t, v, g, s, dec, curv):
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = t, v, g, s
        self.decrease_error, self.curvature_error = dec, curv

    def _search_interval(self):
        t = (_host(1.0) if self.count == 0
             else self.INCREASE * self.stepsize)
        v, g, s = self._on_line(t)
        dec, curv, err = self._errors(t, v, s)
        if dec <= self.TOL:
            self.safe_stepsize, self.safe_value, self.safe_grad = t, v, g
        high_new = bool(dec > 0.0) or (bool(v >= self.value)
                                       and self.count > 0)
        low_new = bool(s >= 0.0) and not high_new
        prev = (self.stepsize, self.value, self.slope)
        if low_new:
            (self.low, self.value_low, self.slope_low), \
                (self.high, self.value_high, self.slope_high) = (t, v, s), prev
        else:
            (self.low, self.value_low, self.slope_low), \
                (self.high, self.value_high, self.slope_high) = prev, (t, v, s)
        self.interval_found = high_new or low_new or bool(err <= self.TOL)
        self.done = bool(err <= self.TOL)
        self.failed = self.count + 1 >= self.max_steps and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self._settle(t, v, g, s, dec, curv)

    def _zoom_into_interval(self):
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high = self.high, self.value_high
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        too_small = bool(delta <= self.THRESHOLD)
        mc = _cubicmin(low, value_low, slope_low, high, value_high,
                       self.cubic_ref, self.value_cubic_ref)
        mq = _quadmin(low, value_low, slope_low, high, value_high)
        if (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta):
            t = mc
        elif (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta):
            t = mq
        else:
            t = (low + high) / 2.0
        v, g, s = self._on_line(t)
        dec, curv, err = self._errors(t, v, s)
        if (dec <= self.TOL) & (v < self.safe_value):
            self.safe_stepsize, self.safe_value, self.safe_grad = t, v, g
        self.done = bool(err <= self.TOL)
        high_to_t = bool((dec > 0.0) | (v >= value_low))
        high_to_low = bool(s * (high - low) >= 0.0) and not high_to_t
        old_low = (low, value_low, slope_low)
        old_high = (high, value_high, self.slope_high)
        new_high = (t, v, s) if high_to_t else old_high
        if high_to_low:
            new_high = old_low
        self.high, self.value_high, self.slope_high = new_high
        self.low, self.value_low, self.slope_low = (
            old_low if high_to_t else (t, v, s))
        self.cubic_ref, self.value_cubic_ref = (
            old_high[:2] if high_to_t or high_to_low else old_low[:2])
        failed = (self.count + 1 >= self.max_steps
                  or (too_small and bool(self.safe_stepsize > 0.0)))
        self.failed = failed and not self.done
        self._settle(t, v, g, s, dec, curv)

    def _try_safe_step(self):
        if bool(self.safe_stepsize > 0.0) or bool(
                torch.isinf(self.decrease_error)):
            self.stepsize, self.value, self.grad = (
                self.safe_stepsize, self.safe_value, self.safe_grad)


class LBFGS:
    """optax.lbfgs() of optax 0.2.6 with its defaults (`_src/alias.py`,
    `_src/transform.py` scale_by_lbfgs, `_src/linesearch.py`): the L-BFGS
    direction from the last `memory_size` differences of parameters and
    gradients, scaled by (Δu·Δw)/(Δu·Δu) (at the first step by
    min(1, 1/‖g‖)), negated, and a zoom line search for its step.

    State: a flat list in the order of `jax.tree.leaves` of the JAX
    solver's state for the same k parameter leaves: count, params[k],
    updates[k], diff_params_memory[k], diff_updates_memory[k] (each
    [memory_size, *shape]), weights_memory, then the line search's
    learning_rate, value, grad[k], num_linesearch_steps, decrease_error,
    curvature_error. `update` needs the loss at `params` (`value`) and a
    `value_fn(leaves)` for the line search's trials."""

    def __init__(self, memory_size: int = 10,
                 max_linesearch_steps: int = 20):
        self.m = memory_size
        self.search = _ZoomLinesearch(max_linesearch_steps)

    def n_state(self, k: int) -> int:
        return 7 + 5 * k

    def init(self, params: Sequence[torch.Tensor]) -> Tensors:
        params = [p.detach() for p in params]
        dev = params[0].device

        def scalar(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=dev)

        def zeros():
            return [torch.zeros_like(p) for p in params]

        def memory():
            return [p.new_zeros((self.m,) + p.shape) for p in params]
        return ([_count(params[0])] + zeros() + zeros() + memory()
                + memory() + [torch.zeros(self.m, device=dev)]
                + [scalar(1.0), scalar(torch.inf)] + zeros()
                + [scalar(0, torch.int32), scalar(torch.inf),
                   scalar(torch.inf)])

    @staticmethod
    def value_and_grad(value_fn: Callable, params: Tensors,
                       state: Tensors):
        """optax.value_and_grad_from_state: the line search's last value
        and gradient (those at `params`) when finite, else computed."""
        k = len(params)
        value, grad = state[3 + 4 * k], state[4 + 4 * k:4 + 5 * k]
        if bool(torch.isfinite(value)):
            return value, list(grad)
        return _value_and_grad(value_fn, params)

    def update(self, grads: Sequence[torch.Tensor], state: Sequence[
            torch.Tensor], params: Sequence[torch.Tensor], *, value,
               value_fn: Callable) -> tuple[Tensors, Tensors]:
        """(updates to add to the params, new state)."""
        params = [p.detach() for p in params]
        grads = list(grads)
        k, m = len(params), self.m
        if len(state) != self.n_state(k):
            raise ValueError(f"lbfgs state has {len(state)} leaves; "
                             f"{self.n_state(k)} expected")
        count = state[0]
        old_p, old_u = state[1:1 + k], state[1 + k:1 + 2 * k]
        mem_w = [x.clone() for x in state[1 + 2 * k:1 + 3 * k]]
        mem_u = [x.clone() for x in state[1 + 3 * k:1 + 4 * k]]
        rhos = state[1 + 4 * k].clone()
        c = int(count)
        idx, prev = c % m, (c - 1) % m
        if c > 0:
            dw = [p - q for p, q in zip(params, old_p)]
            du = [g - q for g, q in zip(grads, old_u)]
            curv = _vdot(du, dw)
            for mem, d in zip(mem_w + mem_u, dw + du):
                mem[prev] = d
            rhos[prev] = torch.where(curv == 0.0, 0.0, 1.0 / curv)
            den = sum(torch.sum(torch.square(d)) for d in du)
            scale = torch.where(den > 0.0, curv / den, 1.0)
        else:
            norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                  for g in grads))
            scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        direction = [-u for u in self._precondition(
            grads, mem_w, mem_u, rhos, scale, idx)]
        t, v, g, trials, dec, curv_err = self.search.run(
            lambda leaves: _value_and_grad(value_fn, leaves), params,
            direction, value, grads)
        dev = params[0].device
        new_state = ([_increment(count)] + params + grads + mem_w + mem_u
                     + [rhos, t.to(dev), v.to(dev)] + list(g)
                     + [torch.tensor(trials, dtype=torch.int32, device=dev),
                        dec.to(dev), curv_err.to(dev)])
        return [t.to(dev) * u for u in direction], new_state

    def _precondition(self, g, mem_w, mem_u, rhos, scale, idx):
        """Algorithm 7.4 of Nocedal & Wright: the two-loop recursion over
        the memory slots from `idx` on."""
        m = self.m
        order = [(idx + i) % m for i in range(m)]
        vec, alphas = list(g), [None] * m
        for j in reversed(range(m)):
            i = order[j]
            alpha = rhos[i] * _vdot([w[i] for w in mem_w], vec)
            vec = [v + (-alpha) * u[i] for v, u in zip(vec, mem_u)]
            alphas[j] = alpha
        vec = [scale * v for v in vec]
        for j in range(m):
            i = order[j]
            beta = rhos[i] * _vdot([u[i] for u in mem_u], vec)
            vec = [v + (alphas[j] - beta) * w[i] for v, w in zip(vec, mem_w)]
        return vec


def fullbatch_minimize(name: str, loss_fn: Callable, params: Tree,
                       max_iter: int = 200, tol: float = 1e-4):
    """Full-batch minimisation of `loss_fn(params)` (a scalar tensor) by
    one of FULLBATCH_SOLVERS, the counterpart of driving gonum's
    lbfgs / bfgs / cg over the whole training loss. `params` is a nest of
    dicts, lists and tuples of tensors.

    Returns (params, loss_curve: list[float], n_iter). Stops early when
    the loss moves by less than `tol` between iterations. lbfgs's curve
    holds the loss at each iteration's start, bfgs's and cg's at its end,
    as in the JAX package."""
    name = name.lower()
    if name == "lbfgs":
        return _minimize_lbfgs(loss_fn, params, max_iter, tol)
    if name == "bfgs":
        return _minimize_flat(loss_fn, params, max_iter, tol, _bfgs_step)
    if name == "cg":
        return _minimize_flat(loss_fn, params, max_iter, tol, _cg_step)
    raise ValueError(f"unknown full-batch solver {name!r}; "
                     f"one of {FULLBATCH_SOLVERS}")


def _minimize_lbfgs(loss_fn, params, max_iter, tol):
    leaves = [p.detach() for p in tree_leaves(params)]

    def value_fn(xs):
        return loss_fn(tree_unflatten(params, xs))

    solver = LBFGS()
    state = solver.init(leaves)
    curve, prev = [], float("inf")
    for _ in range(max_iter):
        value, grad = solver.value_and_grad(value_fn, leaves, state)
        updates, state = solver.update(grad, state, leaves, value=value,
                                       value_fn=value_fn)
        leaves = [p + u for p, u in zip(leaves, updates)]
        loss = float(value)
        curve.append(loss)
        if abs(prev - loss) < tol:
            break
        prev = loss
    return tree_unflatten(params, leaves), curve, len(curve)


def _armijo_step(flat_loss, x, f, g, d):
    """Backtracking Armijo search along d from a unit step (c1 1e-4, at
    most 30 halvings)."""
    slope = torch.dot(g, d)
    t = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(30):
        with torch.no_grad():
            if not bool(flat_loss(x + t * d) > f + 1e-4 * t * slope):
                break
        t = t * 0.5
    return t


def _bfgs_step(flat_loss, s):
    """One dense-BFGS iteration: the inverse Hessian's direction, an Armijo
    search, and the inverse-Hessian update. JAX forms (I − ρsyᵀ) H
    (I − ρysᵀ) + ρssᵀ with two n³ products; here the same update in its
    rank-two form, H − ρ(s(Hy)ᵀ + (Hy)sᵀ) + (ρ²yᵀHy + ρ)ssᵀ (H symmetric),
    in place in O(n²). A curvature sᵀy ≤ 1e-10 skips the update."""
    x, f, g, h = s["x"], s["f"], s["g"], s.get("h")
    if h is None:
        h = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    d = -(h @ g)
    # safeguard: steepest descent on a non-descent direction
    if not bool(torch.dot(d, g) < 0):
        d = -g
    t = _armijo_step(flat_loss, x, f, g, d)
    x_new = x + t * d
    f_new, (g_new,) = _value_and_grad(lambda xs: flat_loss(xs[0]), [x_new])
    sk, yk = x_new - x, g_new - g
    sy = torch.dot(sk, yk)
    if bool(sy > 1e-10):
        rho = 1.0 / sy
        hy = h @ yk
        c = rho * rho * torch.dot(yk, hy) + rho
        h.addr_(sk, c * sk - rho * hy)
        h.addr_(hy, sk, alpha=-rho)
    return dict(x=x_new, f=f_new, g=g_new, h=h)


def _cg_step(flat_loss, s):
    """One Polak–Ribière+ nonlinear-CG iteration with an Armijo search and
    a restart on a non-descent direction."""
    x, f, g, d = s["x"], s["f"], s["g"], s.get("d")
    if d is None:
        d = -g
    t = _armijo_step(flat_loss, x, f, g, d)
    x_new = x + t * d
    f_new, (g_new,) = _value_and_grad(lambda xs: flat_loss(xs[0]), [x_new])
    beta = torch.maximum(torch.zeros_like(f), torch.dot(
        g_new, g_new - g) / torch.clamp(torch.dot(g, g), min=1e-30))
    d_new = -g_new + beta * d
    if not bool(torch.dot(d_new, g_new) < 0):
        d_new = -g_new
    return dict(x=x_new, f=f_new, g=g_new, d=d_new)


def _minimize_flat(loss_fn, params, max_iter, tol, step):
    leaves = [p.detach() for p in tree_leaves(params)]
    shapes = [p.shape for p in leaves]
    sizes = [p.numel() for p in leaves]

    def unravel(x):
        return tree_unflatten(params, [
            v.reshape(sh) for v, sh in zip(torch.split(x, sizes), shapes)])

    def flat_loss(x):
        return loss_fn(unravel(x))

    x0 = torch.cat([p.reshape(-1) for p in leaves])
    f0, (g0,) = _value_and_grad(lambda xs: flat_loss(xs[0]), [x0])
    state = dict(x=x0, f=f0, g=g0)
    curve, prev = [], float("inf")
    for _ in range(max_iter):
        state = step(flat_loss, state)
        loss = float(state["f"])
        curve.append(loss)
        if abs(prev - loss) < tol:
            break
        prev = loss
    return unravel(state["x"]), curve, len(curve)
