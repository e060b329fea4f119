"""sklearn-style MLPClassifier on the card (port of
goctr_tpu/models/mlp_classifier.py; the reference's sklearn port).

Packed MLP with bias, activations identity / logistic / tanh / relu,
solvers sgd (momentum, Nesterov) / adam / lbfgs / bfgs / cg (the last
three full-batch, through optim.fullbatch_minimize), lr schedules
constant / invscaling / adaptive (÷5 on a plateau), L2 `alpha` scaled by
n_samples, optional decoupled `weight_decay`, optional per-batch max-abs
"batch_normalize" (the reference's column max-abs scaling), shuffle,
early stopping on the training loss, label binarisation for multiclass
and Glorot init.

Compute: the rows live on the device; an epoch is a Python loop over
minibatches (gather, forward, autograd, the port's optax-style solver
links, `p + lr·u` with lr negative), one host sync an epoch, as the JAX
package's scanned epoch does. Padded rows of the last batch carry weight
0 (`wmask`). Parameters are {"w": [...], "b": [...]}; the solvers see
them in JAX leaf order (every "b" before every "w").

Random streams: the Glorot init and each epoch's permutation come from
torch generators seeded with `random_state`; JAX's threefry streams
cannot be reproduced, so parity tests start from the JAX model's initial
parameters (`fit(..., init=...)`; `MLPClassifier(max_iter=0).fit` stores
exactly its initial parameters) and use shuffle=False.

Two reference faults. With early_stopping=True the JAX package splits off
`validation_fraction` of the rows and never uses them (the loop stops on
the training loss): the port does the same, for parity. JAX's `to_json`
drops `batch_normalize`; the port writes it and reads it when present.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.ops.activations import ACTIVATIONS
from goctr_tpu_torch.optim.optimizers import (
    FULLBATCH_SOLVERS, Solver, _AddDecayedWeights, _Identity,
    _ScaleByAdam, _Trace, fullbatch_minimize, tree_leaves, tree_unflatten,
)

Params = dict[str, list[torch.Tensor]]


def _glorot_bounds(fan_in: int, fan_out: int, activation: str) -> float:
    # sklearn _init_coef: factor 2 for logistic-like ("sigmoid"), 6 otherwise
    factor = 2.0 if activation == "logistic" else 6.0
    return float(np.sqrt(factor / (fan_in + fan_out)))


def _maxabs_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-batch max-abs column scaling (the reference's batchNormalize)."""
    m = torch.amax(torch.abs(x), dim=0, keepdim=True)
    return x / torch.clamp(m, min=1e-12)


class MLPClassifier:

    def __init__(self, hidden_layer_sizes: Sequence[int] = (100,),
                 activation: str = "relu", solver: str = "adam",
                 alpha: float = 1e-4, batch_size: int | str = "auto",
                 learning_rate: str = "constant",
                 learning_rate_init: float = 1e-3, power_t: float = 0.5,
                 max_iter: int = 200, shuffle: bool = True,
                 random_state: int = 0, tol: float = 1e-4,
                 momentum: float = 0.9, nesterovs_momentum: bool = True,
                 early_stopping: bool = False,
                 validation_fraction: float = 0.1, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 n_iter_no_change: int = 10, weight_decay: float = 0.0,
                 batch_normalize: bool = False, verbose: bool = False,
                 device: str | torch.device = "cuda"):
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.activation = activation
        self.solver = solver
        self.alpha = alpha
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.learning_rate_init = learning_rate_init
        self.power_t = power_t
        self.max_iter = max_iter
        self.shuffle = shuffle
        self.random_state = random_state
        self.tol = tol
        self.momentum = momentum
        self.nesterovs_momentum = nesterovs_momentum
        self.early_stopping = early_stopping
        self.validation_fraction = validation_fraction
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.n_iter_no_change = n_iter_no_change
        self.weight_decay = weight_decay
        self.batch_normalize = batch_normalize
        self.verbose = verbose
        self.device = device

        self.coefs_: list[np.ndarray] = []
        self.intercepts_: list[np.ndarray] = []
        self.classes_: np.ndarray = np.zeros(0)
        self.loss_curve_: list[float] = []
        self.n_iter_: int = 0
        self.out_activation_: str = "logistic"

    # ----------------------------------------------------------- forward ---
    def _forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        h = x
        n = len(params["w"])
        for i in range(n):
            h = h @ params["w"][i] + params["b"][i]
            if i < n - 1:
                h = act(h)
        return h   # logits

    def _loss(self, params: Params, x, y, wmask, n_total):
        logits = self._forward(params, x)
        if self._multiclass:
            ce = -torch.sum(y * torch.log_softmax(logits, dim=-1), dim=-1)
        else:
            z, yy = logits[:, 0], y[:, 0]
            ce = (torch.clamp(z, min=0) - z * yy
                  + torch.log1p(torch.exp(-torch.abs(z))))
        data = torch.sum(ce * wmask) / torch.clamp(torch.sum(wmask), min=1.0)
        # sklearn: + alpha/(2*n_samples) * sum ||W||^2 (coefs only)
        l2 = sum(torch.sum(w * w) for w in params["w"])
        return data + self.alpha * l2 / (2.0 * n_total)

    # --------------------------------------------------------------- fit ---
    def _targets(self, y: np.ndarray) -> np.ndarray:
        """Binarised labels; sets classes_ and the output activation."""
        self.classes_ = np.unique(y)
        if self.classes_.size < 2:
            raise ValueError("need at least 2 classes")
        self._multiclass = self.classes_.size > 2
        if self._multiclass:
            yb = np.zeros((y.size, self.classes_.size), np.float32)
            for i, c in enumerate(self.classes_):
                yb[y == c, i] = 1.0
            self.out_activation_ = "softmax"
        else:
            yb = (y == self.classes_[1]).astype(np.float32)[:, None]
            self.out_activation_ = "logistic"
        return yb

    def init_params(self, n_in: int, n_out: int) -> Params:
        """Glorot-uniform weights and biases for the layer widths, drawn
        from a CPU generator seeded with random_state (float32 numpy)."""
        dims = (n_in,) + self.hidden_layer_sizes + (n_out,)
        gen = torch.Generator().manual_seed(self.random_state)
        params = {"w": [], "b": []}
        for i in range(len(dims) - 1):
            bound = _glorot_bounds(dims[i], dims[i + 1], self.activation)
            for key, shape in (("w", (dims[i], dims[i + 1])),
                               ("b", (dims[i + 1],))):
                u = torch.rand(shape, generator=gen)
                params[key].append(((2 * u - 1) * bound).numpy())
        return params

    def fit(self, X: np.ndarray, y: np.ndarray, *,
            init: Optional[dict] = None) -> "MLPClassifier":
        """Train from `init` ({"w": [...], "b": [...]} float32 arrays, e.g.
        the JAX model's initial parameters) or, by default, from
        init_params."""
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y).ravel()
        yb = self._targets(y)
        # validation split (sklearn early_stopping); unused, as in JAX
        rng = np.random.default_rng(self.random_state)
        if self.early_stopping:
            n_val = max(1, int(X.shape[0] * self.validation_fraction))
            perm = rng.permutation(X.shape[0])
            X, yb = X[perm[n_val:]], yb[perm[n_val:]]
        return self._fit_from(init, X, yb)

    def _fit_from(self, init, X: np.ndarray, yb: np.ndarray):
        dev = resolve_device(self.device)
        init = init or self.init_params(X.shape[1], yb.shape[1])
        params = {k: [torch.tensor(np.asarray(a, np.float32), device=dev)
                      for a in init[k]] for k in ("w", "b")}
        if self.solver in FULLBATCH_SOLVERS:
            self._fit_fullbatch(params, X, yb, dev)
        else:
            self._fit_stochastic(params, X, yb, dev)
        return self

    def _store(self, params: Params):
        self.coefs_ = [w.detach().cpu().numpy() for w in params["w"]]
        self.intercepts_ = [b.detach().cpu().numpy() for b in params["b"]]

    def _fit_fullbatch(self, params, X, yb, dev):
        """Full-batch lbfgs / bfgs / cg over the whole training loss (the
        reference's fitLbfgs and its gonum method registry)."""
        n = X.shape[0]
        x = torch.from_numpy(X).to(dev)
        yt = torch.from_numpy(yb).to(dev)
        wmask = torch.ones(n, device=dev)
        if self.batch_normalize:
            x = _maxabs_scale(x)
        params, curve, n_iter = fullbatch_minimize(
            self.solver, lambda p: self._loss(p, x, yt, wmask, n), params,
            max_iter=self.max_iter, tol=self.tol)
        self.loss_curve_.extend(curve)
        self.n_iter_ = n_iter
        self._store(params)

    def _solver(self) -> Solver:
        if self.solver == "adam":
            core = _ScaleByAdam(self.beta_1, self.beta_2, self.epsilon)
        elif self.momentum:
            core = _Trace(self.momentum, self.nesterovs_momentum)
        else:
            core = _Identity()
        chain = [core]
        if self.weight_decay:
            chain.append(_AddDecayedWeights(self.weight_decay))
        return Solver(chain)

    def _fit_stochastic(self, params, X, yb, dev):
        n = X.shape[0]
        bs = min(200, n) if self.batch_size == "auto" else \
            min(int(self.batch_size), n)
        n_batches = -(-n // bs)
        n_pad = n_batches * bs
        x = torch.zeros((n_pad, X.shape[1]), device=dev)
        x[:n] = torch.from_numpy(X).to(dev)
        yt = torch.zeros((n_pad, yb.shape[1]), device=dev)
        yt[:n] = torch.from_numpy(yb).to(dev)
        wm = (torch.arange(n_pad, device=dev) < n).float()
        solver = self._solver()
        leaves = tree_leaves(params)
        state = solver.init(leaves)
        gen = torch.Generator(device=dev).manual_seed(self.random_state)

        def loss_of(ls, xb, yb_, wb):
            return self._loss(tree_unflatten(params, ls), xb, yb_, wb,
                              float(n))

        lr = self.learning_rate_init
        best, no_improve, t = np.inf, 0, 0
        for it in range(self.max_iter):
            if self.learning_rate == "invscaling":
                lr = self.learning_rate_init / (t + 1) ** self.power_t
            perm = (torch.randperm(n_pad, generator=gen, device=dev)
                    if self.shuffle else torch.arange(n_pad, device=dev))
            losses = []
            for idx in perm.reshape(n_batches, bs):
                xb = x[idx]
                if self.batch_normalize:
                    xb = _maxabs_scale(xb)
                ls = [p.detach().requires_grad_(True) for p in leaves]
                with torch.enable_grad():
                    loss = loss_of(ls, xb, yt[idx], wm[idx])
                    grads = torch.autograd.grad(loss, ls)
                updates, state = solver.update(grads, state, leaves)
                # updates are an ascent direction: lr enters negated
                leaves = [p + (-lr) * u for p, u in zip(leaves, updates)]
                losses.append(loss.detach())
            loss = float(torch.stack(losses).mean())
            self.loss_curve_.append(loss)
            self.n_iter_ = it + 1
            t += n_batches
            if loss < best - self.tol:
                best = loss
                no_improve = 0
            else:
                no_improve += 1
            if no_improve >= self.n_iter_no_change:
                if self.learning_rate == "adaptive" and lr > 1e-6:
                    lr /= 5.0
                    no_improve = 0
                else:
                    break
        self._store(tree_unflatten(params, leaves))

    # ----------------------------------------------------------- predict ---
    def _params(self, dev: torch.device) -> Params:
        return {"w": [torch.from_numpy(w).to(dev) for w in self.coefs_],
                "b": [torch.from_numpy(b).to(dev) for b in self.intercepts_]}

    def _logits(self, X: np.ndarray, scale: bool) -> torch.Tensor:
        dev = resolve_device(self.device)
        x = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(dev)
        if scale:
            x = _maxabs_scale(x)
        with torch.no_grad():
            return self._forward(self._params(dev), x)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        logits = self._logits(X, self.batch_normalize)
        if self.out_activation_ == "softmax":
            return torch.softmax(logits, dim=-1).cpu().numpy()
        p = torch.sigmoid(logits[:, 0]).cpu().numpy()
        return np.stack([1 - p, p], axis=1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        proba = self.predict_proba(X)
        return self.classes_[np.argmax(proba, axis=1)]

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y).ravel()))

    # ----------------------------------------------------------- persist ---
    def to_json(self) -> str:
        return json.dumps({
            "hidden_layer_sizes": list(self.hidden_layer_sizes),
            "activation": self.activation,
            "out_activation": self.out_activation_,
            "classes": self.classes_.tolist(),
            "coefs": [w.tolist() for w in self.coefs_],
            "intercepts": [b.tolist() for b in self.intercepts_],
            "batch_normalize": self.batch_normalize,
        })

    @classmethod
    def from_json(cls, blob: str, device: str | torch.device = "cuda"
                  ) -> "MLPClassifier":
        """A model written by either package's to_json; the JAX package's
        has no "batch_normalize" (off)."""
        d = json.loads(blob)
        m = cls(hidden_layer_sizes=tuple(d["hidden_layer_sizes"]),
                activation=d["activation"],
                batch_normalize=bool(d.get("batch_normalize", False)),
                device=device)
        m.out_activation_ = d["out_activation"]
        m.classes_ = np.asarray(d["classes"])
        m._multiclass = m.classes_.size > 2
        m.coefs_ = [np.asarray(w, np.float32) for w in d["coefs"]]
        m.intercepts_ = [np.asarray(b, np.float32) for b in d["intercepts"]]
        return m

    # sklearn-ish plumbing
    def get_params(self, deep: bool = True) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if not k.endswith("_") and not k.startswith("_")}

    def set_params(self, **kw) -> "MLPClassifier":
        for k, v in kw.items():
            setattr(self, k, v)
        return self
