"""Stochastic logistic regression fit with the quasi-Newton optimizers.

Counterpart of :mod:`stochqn_tpu.models.logistic`: a scikit-learn-style
model equivalent to the reference's ``StochasticLogisticRegression``
(``stochqn/_logistic.py:36-247``), with the loss / gradient /
Hessian-vector functions of :mod:`stochqn_tpu_torch.models.losses` (dense)
and :mod:`stochqn_tpu_torch.models.sparse` (CSR input, as padded COO).

Conventions kept:

* binary vs. multinomial detected from ``y.ndim``
  (``stochqn/_logistic.py:164-177``); multinomial expects one-hot labels;
* sample weights normalized to sum to one (``stochqn/_logistic.py:159``);
* initial weights ``~ Normal(0, 1)`` with ``np.random.seed(random_state)``
  (``stochqn/_logistic.py:178-179``);
* ``partial_fit`` holds the step size constant unless asked otherwise
  (``stochqn/_logistic.py:239-245``).

The model computes on ``device`` (the card by default; no CUDA device:
the constructor raises; pass ``device="cpu"`` for the CPU) in ``dtype``
(a ``torch.dtype``, float32 by default).  ``engine="protocol"`` drives the
guided request loop, whose callables take and return numpy arrays and
compute on the device; ``engine="fused"`` runs the epochs on
:class:`stochqn_tpu_torch.fused.FusedTrainer`, shuffling each epoch with
a ``torch.Generator`` seeded with ``random_state`` on the device (the JAX
package's ``jax.random`` stream cannot be reproduced in torch).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.sparse import issparse

from stochqn_tpu_torch.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu_torch.core.protocol import resolve_device
from stochqn_tpu_torch.free import _numpy, _resolve_dtype
from stochqn_tpu_torch.fused import FusedTrainer, batchify, shuffle_batched
from stochqn_tpu_torch.guided import SQN, _numpy_dtype, adaQN, oLBFGS
from stochqn_tpu_torch.parallel.mesh import (MeshComm, gather_state,
                                             mesh_shape, shard_batches)
from stochqn_tpu_torch.models import losses
from stochqn_tpu_torch.models import sparse as sparse_losses
from stochqn_tpu_torch.utils.metrics import LossHistory, span
from stochqn_tpu_torch.utils.schedules import step_size_const, step_size_sqrt


def _densify(X):
    return np.asarray(X.todense()) if issparse(X) else np.asarray(X)


def _padded(X, dtype: torch.dtype, max_nnz=None, device=None):
    """Host CSR -> padded-COO tensors on ``device`` (see models/sparse.py):
    ``int64`` indices and ``dtype`` values.

    Memoized on the matrix object: one protocol boundary presents the same
    stored big batch to the gradient, function-value, and Hessian-vector
    evaluators back to back, and the conversion is a host-side Python loop
    over rows.

    ``max_nnz`` pins the padded width ``k``; ``fit`` derives it from the
    full matrix so every batch has the same ``[B, k]`` shape.  A pinned
    width never truncates: a batch denser than ``max_nnz`` (e.g.
    partial_fit data after an earlier fit) falls back to its own width, as
    csr_to_padded would otherwise drop features.
    """
    if max_nnz is not None:
        Xr = X.tocsr() if hasattr(X, "tocsr") else X
        indptr = getattr(Xr, "indptr", None)
        if indptr is not None and len(indptr) > 1:
            if int(np.diff(indptr).max()) > max_nnz:
                max_nnz = None          # exactness over shape stability
    device = torch.device("cpu") if device is None else torch.device(device)
    key = (dtype, max_nnz, device)
    cached = getattr(X, "_stochqn_padded", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    idx, val = sparse_losses.csr_to_padded(X, max_nnz=max_nnz,
                                           dtype=_numpy_dtype(dtype))
    out = (torch.from_numpy(idx.astype(np.int64)).to(device),
           torch.from_numpy(val).to(device=device, dtype=dtype))
    try:
        X._stochqn_padded = (key, out)
    except AttributeError:  # immutable container; just skip the memo
        pass
    return out


class StochasticLogisticRegression:
    """Logistic regression (binary or multinomial) trained with oLBFGS, SQN,
    or adaQN.

    Parameters mirror the reference (``stochqn/_logistic.py:40-56``):
    ``reg_param`` is l2 strength on an *average* log-loss (sample weights
    are normalized), ``optimizer`` is one of ``"oLBFGS" | "SQN" |
    "adaQN"``, and extra ``optimizer_kwargs`` flow to the underlying guided
    optimizer (protocol engine) or optimizer config (fused engine).
    ``dtype`` (a ``torch.dtype``) is the compute dtype, float32 by
    default; ``device`` where the model computes.

    ``mesh`` (fused engine only): a ``(data, param)`` ``DeviceMesh``
    (:func:`stochqn_tpu_torch.parallel.make_mesh`), one process per rank,
    each calling ``fit`` with the full data: every rank shuffles the whole
    epoch with the same generator, takes its rows of each batch, and the
    state shards its parameter axis.  The loss is a weighted sum over the
    rows plus the penalty, summed over the data ranks: each rank's
    functions carry ``reg_param / n_data`` of the penalty, so that it
    counts once.  ``coef_``, prediction and the fitted state are the
    gathered whole.
    """

    def __init__(self, reg_param=1e-3, fit_intercept=True, random_state=1,
                 optimizer="SQN", step_size=1e-1, valset_frac=0.1,
                 verbose=False, dtype=torch.float32, engine="protocol",
                 mesh=None, device=None, **optimizer_kwargs):
        if optimizer not in ("oLBFGS", "SQN", "adaQN"):
            raise ValueError("'optimizer' must be one of 'oLBFGS', 'SQN', "
                             "'adaQN'")
        if engine not in ("protocol", "fused"):
            raise ValueError("'engine' must be 'protocol' or 'fused'")
        if mesh is not None:
            if engine != "fused":
                raise ValueError("'mesh' requires engine='fused'")
            mesh_shape(mesh)            # a (data, param) DeviceMesh
        self.mesh = mesh
        if step_size <= 0:
            raise ValueError("'step_size' must be positive")
        if reg_param < 0:
            raise ValueError("'reg_param' must be non-negative")
        self.engine = engine
        self.device = resolve_device(device, "StochasticLogisticRegression")
        self.dtype = _resolve_dtype(False, optimizer_kwargs.pop("dtype",
                                                                dtype))
        optimizer_kwargs["step_size"] = float(step_size)
        optimizer_kwargs["valset_frac"] = valset_frac
        optimizer_kwargs["verbose"] = verbose

        self.optimizer_name = optimizer
        self.optimizer = None
        self.optimizer_kwargs = optimizer_kwargs
        self.reg_param = float(reg_param)
        self.fit_intercept = bool(fit_intercept)
        self.random_state = random_state
        self.nclasses: Optional[int] = None
        self._is_mult: Optional[bool] = None
        self.is_fitted = False
        self._x_fused: Optional[np.ndarray] = None
        # padded-COO width pinned by fit() from the full matrix; None =
        # derive per batch (partial_fit streaming, where no full matrix
        # exists)
        self._pad_k: Optional[int] = None

    # ------------------------------------------------------------------ #
    @property
    def x_(self):
        """Flat parameter vector, regardless of training engine."""
        if self._x_fused is not None:
            return self._x_fused
        return None if self.optimizer is None else self.optimizer.x

    @property
    def coef_(self):
        if not self.is_fitted:
            return None
        x = self.x_
        if self._is_mult:
            w = x.reshape(self.nclasses, -1)
            return w[:, :-1] if self.fit_intercept else w
        return x[:-1] if self.fit_intercept else x

    @property
    def intercept_(self):
        if not self.is_fitted:
            return None
        x = self.x_
        if self._is_mult:
            if self.fit_intercept:
                return x.reshape(self.nclasses, -1)[:, -1]
            return np.zeros(self.nclasses)
        return x[-1] if self.fit_intercept else 0.0

    # ------------------------------------------------------------------ #
    def _check_inputs(self, X, y, sample_weight):
        if sample_weight is None:
            sample_weight = np.ones(X.shape[0])
        else:
            sample_weight = np.asarray(sample_weight, np.float64).reshape(-1)
        if sample_weight.shape[0] != X.shape[0] or X.shape[0] != y.shape[0]:
            raise ValueError("X, y, sample_weight must have matching rows")
        if issparse(y):
            y = np.asarray(y.todense())
        # Average (rather than summed) log-loss, like the reference
        # (stochqn/_logistic.py:159).
        sample_weight = sample_weight / sample_weight.sum()
        return X, y, sample_weight

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _features(self, X, max_nnz=None):
        """``X`` on the device: ``(idx, val)`` padded COO for a sparse
        matrix, ``(X,)`` dense otherwise."""
        if issparse(X):
            return _padded(X, self.dtype, max_nnz, self.device)
        return (self._tensor(_densify(X)),)

    def _cores(self, sparse: bool, n_features: int):
        """``(loss, grad, hessvec)`` over ``(x, *features, y, w, reg)``
        (``hessvec`` takes ``v`` after ``x``), dense or sparse, binary or
        multinomial."""
        if self._is_mult:
            if sparse:
                sl = sparse_losses
                return (
                    lambda x, i, v, Y, w, r: sl.sparse_multinomial_logistic_loss(
                        x, i, v, Y, n_features, w, r),
                    lambda x, i, v, Y, w, r: sl.sparse_multinomial_logistic_grad(
                        x, i, v, Y, n_features, w, r),
                    lambda x, hv, i, v, Y, w, r:
                        sl.sparse_multinomial_logistic_hessvec(
                            x, hv, i, v, Y, n_features, w, r))
            return (losses.multinomial_logistic_loss,
                    losses.multinomial_logistic_grad,
                    losses.multinomial_logistic_hessvec)
        if sparse:
            sl = sparse_losses
            return (
                lambda x, i, v, y, w, r: sl.sparse_binary_logistic_loss(
                    x, i, v, y, n_features, w, r),
                lambda x, i, v, y, w, r: sl.sparse_binary_logistic_grad(
                    x, i, v, y, n_features, w, r),
                lambda x, hv, i, v, y, w, r: sl.sparse_binary_logistic_hessvec(
                    x, hv, i, v, y, n_features, w, r))
        return (losses.binary_logistic_loss, losses.binary_logistic_grad,
                losses.binary_logistic_hessvec)

    def _build_funs(self):
        """Loss/grad/hessvec closures for the protocol engine: numpy in,
        numpy out, computed on the device.

        CSR inputs route through the padded-COO sparse forms
        (models/sparse.py) instead of densifying, as the reference keeps
        sparse matrices sparse through its whole driver
        (``stochqn/_optimizers.py:81-112``, ``_logistic.py:36-247``)."""
        reg = self.reg_param

        def prepared(x, X, y, sample_weight):
            feats = self._features(X, self._pad_k)
            loss, grad, hv = self._cores(issparse(X), X.shape[1])
            w = None if sample_weight is None else self._tensor(sample_weight)
            return (self._tensor(x), feats, self._tensor(y), w,
                    (loss, grad, hv))

        def obj_fun(x, X, y, sample_weight=None, reg_param=reg):
            x, feats, y, w, (loss, _, _) = prepared(x, X, y, sample_weight)
            return float(loss(x, *feats, y, w, reg_param))

        def grad_fun(x, X, y, sample_weight=None, reg_param=reg):
            x, feats, y, w, (_, grad, _) = prepared(x, X, y, sample_weight)
            return _numpy(grad(x, *feats, y, w, reg_param))

        def hess_vec_fun(x, v, X, y, sample_weight=None, reg_param=reg):
            x, feats, y, w, (_, _, hv) = prepared(x, X, y, sample_weight)
            return _numpy(hv(x, self._tensor(v), *feats, y, w,
                                reg_param))

        return obj_fun, grad_fun, hess_vec_fun

    def _pred_fun(self):
        def pred(x, X):
            x = self._tensor(x)
            feats = self._features(X)
            if self._is_mult:
                k = self.nclasses
                if issparse(X):
                    p = sparse_losses.sparse_multinomial_logistic_predict_proba(
                        x, *feats, X.shape[1], k)
                else:
                    p = losses.multinomial_logistic_predict_proba(
                        x, *feats, k)
            elif issparse(X):
                p = sparse_losses.sparse_binary_logistic_predict_proba(
                    x, *feats, X.shape[1])
            else:
                p = losses.binary_logistic_predict_proba(x, *feats)
            return _numpy(p)
        return pred

    def _initial_weights(self, X, y):
        self._is_mult = (y.ndim == 2)
        self.nclasses = y.shape[1] if self._is_mult else 2
        n_out = y.shape[1] if self._is_mult else 1
        if self._x_fused is not None:
            # warm start from the fused-trained weights (protocol and
            # fused engine alike), so partial_fit continues the same model
            return np.asarray(self._x_fused)
        np.random.seed(self.random_state)
        return np.random.normal(size=(X.shape[1] + self.fit_intercept) * n_out)

    def _initialize_optimizer(self, X, y):
        if self.optimizer is not None:
            return
        w0 = self._initial_weights(X, y)
        self._x_fused = None
        obj_fun, grad_fun, hess_vec_fun = self._build_funs()
        common = dict(x0=w0, grad_fun=grad_fun, obj_fun=obj_fun,
                      pred_fun=self._pred_fun(),
                      random_state=self.random_state, dtype=self.dtype,
                      device=self.device)
        kwargs = dict(self.optimizer_kwargs)
        if self.optimizer_name == "oLBFGS":
            self.optimizer = oLBFGS(**common, **kwargs)
        elif self.optimizer_name == "SQN":
            self.optimizer = SQN(**common, hess_vec_fun=hess_vec_fun,
                                 **kwargs)
        else:
            self.optimizer = adaQN(**common, **kwargs)

    # ------------------------------------------------------------------ #
    def fit(self, X, y, sample_weight=None):
        """Fit in stochastic batches over multiple epochs (the protocol or
        the fused engine, as ``engine`` says)."""
        if self.engine == "fused":
            with span("stochqn.fit"):
                return self._fit_fused(X, y, sample_weight)
        X, y, sample_weight = self._checked(X, y, sample_weight)
        self._initialize_optimizer(X, y)
        self.optimizer.fit(X, y, sample_weight,
                           {"reg_param": self.reg_param})
        self.is_fitted = True
        return self

    def _checked(self, X, y, sample_weight):
        """The inputs checked, and a sparse ``X``'s padded width pinned."""
        X, y, sample_weight = self._check_inputs(X, y, sample_weight)
        if issparse(X):
            # pin the padded width from the full matrix: every batch then
            # has the same [B, k] shape
            Xr = X.tocsr()
            knz = int(np.diff(Xr.indptr).max()) if Xr.shape[0] else 1
            self._pad_k = max(8, -(-knz // 8) * 8)
        return X, y, sample_weight

    def _fit_fused(self, X, y, sample_weight):
        """The fused fit, in the spans ``stochqn.fit.prepare`` (everything
        before the first epoch: the inputs checked, ``X``, ``y`` and the
        weights on the device, the trainer, its state and the batches),
        ``stochqn.fit.epochs`` and ``stochqn.fit.finish`` (the
        coefficients back on the host)."""
        with span("stochqn.fit.prepare"):
            X, y, sample_weight = self._checked(X, y, sample_weight)
            kw = dict(self.optimizer_kwargs)
            step_size = kw.pop("step_size")
            valset_frac = kw.pop("valset_frac", None)
            verbose = kw.pop("verbose", False)
            nepochs = kw.pop("nepochs", 25)
            batches_per_epoch = kw.pop("batches_per_epoch", 25)
            decr_step_size = kw.pop("decr_step_size", "auto")
            tol = kw.pop("tol", 1e-1)
            shuffle = kw.pop("shuffle_data", True)
            kw.pop("random_state", None)
            if decr_step_size == "auto":
                decr = step_size_sqrt
            elif decr_step_size is None:
                decr = step_size_const
            else:
                decr = decr_step_size

            w0 = self._initial_weights(X, y)
            dtype, device = self.dtype, self.device
            # CSR input trains through the padded-COO sparse forms:
            # features become (indices, values) leaves and no dense
            # [n, n_features] matrix ever exists on the device.
            feats = self._features(X)
            loss_core, grad_core, hess_core = self._cores(issparse(X),
                                                          X.shape[1])
            if self._is_mult:
                Yd = self._tensor(y)
            else:
                Yd = self._tensor(2.0 * (np.asarray(y) > 0) - 1.0)
            Wd = self._tensor(sample_weight)
            reg = self.reg_param
            # on a mesh the ranks' results are summed: each carries its
            # share of the penalty
            reg_rank = reg if self.mesh is None else reg / MeshComm(
                self.mesh).n_data

            has_val = valset_frac is not None
            if has_val:
                n_rows = Yd.shape[0]
                n_val = max(1, int(n_rows * valset_frac))
                perm = np.random.default_rng(
                    self.random_state).permutation(n_rows)
                val_idx = torch.as_tensor(perm[:n_val], device=device)
                tr_idx = torch.as_tensor(perm[n_val:], device=device)

                def rows(t, idx):
                    return t.index_select(0, idx)
                feats_val = tuple(rows(f, val_idx) for f in feats)
                Y_val, W_val = rows(Yd, val_idx), rows(Wd, val_idx)
                feats = tuple(rows(f, tr_idx) for f in feats)
                Yd, Wd = rows(Yd, tr_idx), rows(Wd, tr_idx)

            def grad_fn(x, batch):
                *fb, Yb, wb = batch
                return grad_core(x, *fb, Yb, wb, reg_rank)

            def obj_fn(x, batch):
                *fb, Yb, wb = batch
                return loss_core(x, *fb, Yb, wb, reg_rank)

            def hess_vec_fn(x, v, batch):
                # Closed-form Hessian-vector product: the same function the
                # protocol engine gets via _build_funs (and the reference via
                # its hess_vec_fun callback, src/stochqn.c:1105).
                *fb, Yb, wb = batch
                return hess_core(x, v, *fb, Yb, wb, reg_rank)

            cfg_cls = {"oLBFGS": OLBFGSConfig, "SQN": SQNConfig,
                       "adaQN": AdaQNConfig}[self.optimizer_name]
            trainer = FusedTrainer(self.optimizer_name, cfg_cls.create(**kw),
                                   grad_fn, obj_fn=obj_fn,
                                   hess_vec_fn=hess_vec_fn, mesh=self.mesh)
            state = trainer.init(torch.as_tensor(w0, dtype=dtype,
                                                 device=device))

            batch_size = max(1, Yd.shape[0] // int(batches_per_epoch))
            data = batchify((*feats, Yd, Wd), batch_size)
            upd_freq = getattr(trainer.cfg, "upd_freq", 1)
            history = LossHistory(tol)
            gen = torch.Generator(device=device)
            gen.manual_seed(1 if self.random_state is None
                            else int(self.random_state))
            niter = 0                        # a fresh state; counted here
            num_batches = Yd.shape[0] // batch_size
            epoch_fn = (trainer.epoch if trainer.eager_only
                        else trainer.jit_epoch())
        with span("stochqn.fit.epochs"):
            for epoch in range(int(nepochs)):
                d = shuffle_batched(data, gen) if shuffle else data
                if self.mesh is not None:       # this rank's rows
                    d = shard_batches(d, self.mesh)
                state, _ = epoch_fn(state, d, decr(step_size, epoch),
                                    aligned=niter % upd_freq == 0)
                niter += num_batches
                if has_val:
                    x = state.x if self.mesh is None else MeshComm(
                        self.mesh).gather_param([state.x], "gather x")[0]
                    lv = float(loss_core(x, *feats_val, Y_val, W_val, reg))
                    if verbose:
                        print(f"{self.optimizer_name} - epoch {epoch + 1:2d}, "
                              f"val f(x): {lv:.6f}")
                    if history.update(lv):
                        break
        with span("stochqn.fit.finish"):
            if self.mesh is not None:
                state = gather_state(state, self.mesh)
            self._x_fused = _numpy(state.x).astype(np.float64)
        self._fused_state = state
        self.is_fitted = True
        return self

    def partial_fit(self, X, y, sample_weight=None, classes=None,
                    decr_step_size=False):
        """Update the model with one user-provided batch."""
        del classes
        X, y, sample_weight = self._check_inputs(X, y, sample_weight)
        self._initialize_optimizer(X, y)
        if decr_step_size:
            self.optimizer.partial_fit(X, y, sample_weight,
                                       {"reg_param": self.reg_param})
        else:
            saved = self.optimizer.decr_step_size
            self.optimizer.decr_step_size = step_size_const
            try:
                self.optimizer.partial_fit(X, y, sample_weight,
                                           {"reg_param": self.reg_param})
            finally:
                self.optimizer.decr_step_size = saved
        self.is_fitted = True
        return self

    def predict(self, X):
        """Predicted class index per row."""
        proba = self._predict_proba_raw(X)
        if self._is_mult:
            return np.argmax(proba, axis=1)
        return (proba >= 0.5).astype(np.uint8)

    def _predict_proba_raw(self, X):
        if self.engine == "fused" or self.optimizer is None:
            return self._pred_fun()(np.asarray(self.x_), X)
        return self.optimizer.predict(X)

    def predict_proba(self, X):
        """Class scores per row (reference semantics: per-class sigmoid for
        multinomial, ``stochqn/_logistic.py:14-20``)."""
        proba = self._predict_proba_raw(X)
        if self._is_mult:
            return proba
        proba = proba.reshape(-1, 1)
        return np.concatenate([1.0 - proba, proba], axis=1)
