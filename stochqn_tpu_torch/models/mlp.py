"""MLP classifier trained with the quasi-Newton optimizers.

Counterpart of :mod:`stochqn_tpu.models.mlp`: the non-convex model family
for adaQN (BASELINE config 4: "adaQN with empirical Fisher + max_incr guard
on a non-convex MLP classifier").  A deliberately simple dense network, its
parameters a list of ``{"w", "b"}`` dicts as in the JAX package (so
``convert.mlp_params_{from,to}_numpy`` carry them across), trained through
:class:`stochqn_tpu_torch.optim_adapter.PytreeTrainer` so every optimizer
feature (Fisher pairs, RMSProp H0, function-value guard) applies unchanged.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from stochqn_tpu_torch.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu_torch.core.protocol import resolve_device
from stochqn_tpu_torch.fused import batchify
from stochqn_tpu_torch.optim_adapter import PytreeTrainer


def init_mlp_params(generator: torch.Generator, sizes: Sequence[int],
                    dtype=torch.float32):
    """He-initialized dense stack, ``sizes = [in, hidden..., out]``, drawn
    from ``generator`` on its device."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(fan_in, fan_out, generator=generator, dtype=dtype,
                        device=generator.device) * math.sqrt(2.0 / fan_in)
        b = torch.zeros(fan_out, dtype=dtype, device=generator.device)
        params.append({"w": w, "b": b})
    return params


def mlp_logits(params, X):
    h = X
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    out = params[-1]
    return h @ out["w"] + out["b"]


def mlp_loss(params, batch, reg_param=0.0):
    """Mean softmax cross-entropy (+ l2 on weights)."""
    X, Y = batch
    logp = torch.log_softmax(mlp_logits(params, X), dim=-1)
    loss = -torch.mean(torch.sum(Y * logp, dim=-1))
    if reg_param > 0:
        sq = sum(torch.sum(layer["w"] * layer["w"]) for layer in params)
        loss = loss + 0.5 * reg_param * sq
    return loss


class MLPClassifier:
    """Scikit-learn-style MLP trained with oLBFGS / SQN / adaQN.

    Args:
      hidden: hidden layer sizes.
      optimizer: "adaQN" (default, the non-convex specialist) | "SQN" |
        "oLBFGS".
      reg_param: l2 strength on the weight matrices.
      step_size: constant step size (adaQN default convention).
      batch_size / nepochs: training schedule.
      random_state: seeds the ``torch.Generator`` (on ``device``) that
        draws the initial weights and, with ``shuffle``, each epoch's row
        permutation.
      dtype / device: ``torch.float32`` on the card by default (no CUDA
        device: the constructor raises; pass ``device="cpu"``).
      optimizer_kwargs: forwarded to the optimizer config.
    """

    def __init__(self, hidden=(64,), optimizer="adaQN", reg_param=1e-5,
                 step_size=0.1, batch_size=128, nepochs=10, random_state=1,
                 dtype=torch.float32, shuffle=True, device=None,
                 **optimizer_kwargs):
        if optimizer not in ("oLBFGS", "SQN", "adaQN"):
            raise ValueError("optimizer must be oLBFGS | SQN | adaQN")
        self.hidden = tuple(hidden)
        self.optimizer_name = optimizer
        self.reg_param = float(reg_param)
        self.step_size = float(step_size)
        self.batch_size = int(batch_size)
        self.nepochs = int(nepochs)
        self.random_state = int(random_state)
        self.dtype = dtype
        self.shuffle = bool(shuffle)
        self.device = resolve_device(device, "MLPClassifier")
        self.optimizer_kwargs = optimizer_kwargs
        self.n_classes_ = None
        self._trainer = None
        self._state = None

    def _make_cfg(self):
        kw = self.optimizer_kwargs
        if self.optimizer_name == "adaQN":
            return AdaQNConfig.create(**{"rmsprop_weight": 0.9, **kw})
        if self.optimizer_name == "SQN":
            return SQNConfig.create(**kw)
        return OLBFGSConfig.create(**kw)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def fit(self, X, y):
        """``y`` may be integer labels or one-hot rows."""
        X = self._tensor(X)
        y = np.asarray(y)
        if y.ndim == 1:
            self.n_classes_ = int(y.max()) + 1
            Y = np.eye(self.n_classes_)[y.astype(int)]
        else:
            self.n_classes_ = y.shape[1]
            Y = y
        Y = self._tensor(Y)

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.random_state)
        sizes = [X.shape[1], *self.hidden, self.n_classes_]
        params0 = init_mlp_params(gen, sizes, self.dtype)

        def loss_fn(params, batch):
            return mlp_loss(params, batch, self.reg_param)

        self._trainer = PytreeTrainer(self.optimizer_name, self._make_cfg(),
                                      loss_fn, params0)
        self._state = self._trainer.init(params0)

        bs = min(self.batch_size, X.shape[0])
        data = batchify((X, Y), bs)
        self._state, _ = self._trainer.run_epochs(
            self._state, data, self.nepochs, self.step_size,
            shuffle=gen if self.shuffle else None)
        return self

    @property
    def params_(self):
        return self._trainer.params(self._state)

    def predict_proba(self, X):
        logits = mlp_logits(self.params_, self._tensor(X))
        return torch.softmax(logits, dim=-1).cpu().numpy()

    def predict(self, X):
        return np.argmax(self.predict_proba(X), axis=1)

    def score(self, X, y):
        y = np.asarray(y)
        if y.ndim > 1:
            y = y.argmax(axis=1)
        return float((self.predict(X) == y).mean())
