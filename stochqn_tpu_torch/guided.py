"""Guided ("scikit-learn-like") optimizer API.

Counterpart of :mod:`stochqn_tpu.guided`, the reference's driver layer
(``stochqn/_optimizers.py:31-785``): classes ``oLBFGS`` / ``SQN`` /
``adaQN`` own the epoch/batch loop, dispatch the free-mode request
protocol against user-supplied gradient / objective / Hessian-vector
callables, and provide ``fit`` / ``partial_fit`` / ``predict``.

Semantics kept from the reference:

* epoch shuffling via ``np.random.seed(random_state + epoch)`` +
  ``argsort(random(n))``, cumulative over epochs
  (``stochqn/_optimizers.py:251-256``);
* validation split / early stopping on ``tol``
  (``stochqn/_optimizers.py:237-244,271-281``); the split is a private
  copy of scikit-learn's ``train_test_split`` row choice
  (:func:`_train_test_split`), so no scikit-learn is needed;
* big-batch assembly: in ``fit`` a contiguous slice covering the last
  ``upd_freq`` batches (``stochqn/_optimizers.py:55-79``); in
  ``partial_fit`` the vstack of every batch stored since the last
  big-batch request (``stochqn/_optimizers.py:81-112``);
* step-size schedules ``step0 / sqrt(k + 1)`` ("auto") or constant, keyed
  on the epoch in ``fit`` and on the iteration number in ``partial_fit``
  (``stochqn/_optimizers.py:24-28,365-368``).

The protocol engine hands the callables numpy arrays (or scipy sparse
matrices) and takes back numpy arrays or tensors.  ``fit(engine="fused")``
runs the epochs on :class:`stochqn_tpu_torch.fused.FusedTrainer` and hands
the callables tensors on the optimizer's device instead (floating-point
data in the optimizer's dtype): callables written with operators and
methods that numpy arrays and tensors share (``@``, ``.T``, ``.mean()``,
``.sum()``) serve both engines.  The optimizer's state lives on
``device``: the card by default (no CUDA device: the constructor raises;
pass ``device="cpu"`` for the CPU).
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch
from scipy.sparse import issparse, vstack as sp_vstack

from stochqn_tpu_torch.core.enums import INFO_NAMES, Info
from stochqn_tpu_torch.free import SQN_free, adaQN_free, oLBFGS_free
from stochqn_tpu_torch.fused import FusedTrainer, batchify
from stochqn_tpu_torch.utils.schedules import step_size_const, step_size_sqrt


def _resolve_schedule(decr_step_size):
    if decr_step_size == "auto":
        return step_size_sqrt
    if decr_step_size is None:
        return step_size_const
    if not callable(decr_step_size):
        raise ValueError(
            "'decr_step_size' must be 'auto', None, or a callable "
            "f(initial_step_size, k) -> float")
    return decr_step_size


def _slice_rows(arr, start, stop):
    if arr is None:
        return None
    return arr[start:stop]


def _epoch_shuffle_order(random_state, epoch, n_rows):
    """The reference's per-epoch shuffle order (fresh seed + argsort of
    uniforms, ``stochqn/_optimizers.py:251-256``): the one definition
    both engines share, and the JAX package's too."""
    np.random.seed(random_state + epoch)
    return np.argsort(np.random.random(size=n_rows))


def _take_rows(arr, order):
    if arr is None:
        return None
    return arr[order]


def _train_test_split(arrays, test_size, random_state):
    """scikit-learn's ``train_test_split(*arrays, test_size=frac,
    random_state=seed)`` row choice for a fraction: ``n_test = ceil(frac *
    n)`` rows taken first from ``RandomState(seed).permutation(n)``, the
    rest for training.  Returns ``[a_train, a_test, b_train, b_test, ...]``
    as scikit-learn does."""
    n = arrays[0].shape[0]
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    out = []
    for a in arrays:
        out += [a[train], a[test]]
    return out


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _data_dtype(arr: np.ndarray, dtype: torch.dtype) -> torch.dtype:
    """Floating-point data takes the optimizer's dtype; labels and other
    integer or boolean data keep theirs."""
    if arr.dtype.kind == "f":
        return dtype
    return torch.from_numpy(arr[:0]).dtype


def _to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    t = _data_dtype(arr, dtype)
    if arr.dtype.kind == "f":
        arr = arr.astype(_numpy_dtype(t), copy=False)
    return torch.as_tensor(arr, device=device)


class _GuidedBase:
    """Shared driver loop for the three guided optimizers."""

    optimizer_name = None

    def _setup_common(self, x0, grad_fun, obj_fun, pred_fun, hess_vec_fun,
                      batches_per_epoch, step_size, decr_step_size,
                      shuffle_data, random_state, nepochs, valset_frac, tol,
                      callback_epoch, callback_iter, kwargs_cb, verbose):
        if not isinstance(batches_per_epoch, (int, np.integer)) or batches_per_epoch <= 0:
            raise ValueError("'batches_per_epoch' must be a positive integer")
        if step_size <= 0:
            raise ValueError("'step_size' must be positive")
        if nepochs <= 0:
            raise ValueError("'nepochs' must be a positive integer")
        if not callable(grad_fun):
            raise ValueError("'grad_fun' must be callable")
        for name, fn in (("obj_fun", obj_fun), ("pred_fun", pred_fun),
                         ("hess_vec_fun", hess_vec_fun),
                         ("callback_epoch", callback_epoch),
                         ("callback_iter", callback_iter)):
            if fn is not None and not callable(fn):
                raise ValueError(f"'{name}' must be callable or None")
        if valset_frac is not None:
            if not (0.0 < valset_frac < 1.0):
                raise ValueError("'valset_frac' must be in (0, 1) or None")
            if obj_fun is None:
                raise ValueError(
                    "Must provide 'obj_fun' when using a validation fraction")

        self.x = np.asarray(x0, dtype=_numpy_dtype(self.optimizer.dtype)
                            ).reshape(-1).copy()
        self.n = self.x.shape[0]
        self.step_size = float(step_size)
        self.grad_fun = grad_fun
        self.obj_fun = obj_fun
        self.pred_fun = pred_fun
        self.hess_vec_fun = hess_vec_fun
        self.batches_per_epoch = int(batches_per_epoch)
        self.decr_step_size = _resolve_schedule(decr_step_size)
        self.shuffle_data = bool(shuffle_data)
        self.random_state = 1 if random_state is None else int(random_state)
        self.nepochs = int(nepochs)
        self.valset_frac = valset_frac
        self.tol = float(tol)
        self.callback_epoch = callback_epoch
        self.callback_iter = callback_iter
        self.kwargs_cb = dict(kwargs_cb) if kwargs_cb else {}
        self.verbose = bool(verbose)
        self.epoch = 0
        self.batch_size = None
        self._reset_saved_batch()
        # Prime the protocol: first call always yields a calc_grad request.
        self.req = self.optimizer.run_optimizer(self.x, self.step_size)

    # ------------------------------------------------------------------ #
    @property
    def niter(self) -> int:
        return self.optimizer.niter

    def get_x(self) -> np.ndarray:
        """Copy of the current iterate."""
        return self.x.copy()

    def predict(self, X, additional_kwargs={}):
        if self.pred_fun is None:
            raise ValueError("Must supply 'pred_fun' in order to call predict.")
        return self.pred_fun(self.x, X, **(additional_kwargs or {}))

    # -- stored-batch container (partial_fit big batches) ---------------- #
    def _reset_saved_batch(self):
        self._stored_X, self._stored_y, self._stored_w = [], [], []
        self._last_big = None

    def _save_batch(self, X, y, w):
        self._stored_X.append(X)
        self._stored_y.append(y)
        self._stored_w.append(w)

    @staticmethod
    def _stack(parts):
        n_sparse = sum(issparse(p) for p in parts)
        if 0 < n_sparse < len(parts):
            warnings.warn("Mixing sparse and dense batches; forcing dense.")
            parts = [np.asarray(p.todense()) if issparse(p) else np.asarray(p)
                     for p in parts]
            return np.concatenate(parts, axis=0)
        if n_sparse:
            return sp_vstack(parts)
        return np.concatenate([np.asarray(p) for p in parts], axis=0)

    def _pop_stored_batch(self):
        if not self._stored_X:
            # One protocol boundary can issue TWO big-batch requests back
            # to back (adaQN with use_grad_diff + max_incr: the function-
            # value guard then the gradient-difference y); the second is
            # served from the batch the first one assembled.  The
            # reference crashes here (its container is reset by the first
            # request); reference bugs are deliberately not reproduced.
            if self._last_big is not None:
                return self._last_big
            raise ValueError("No stored batches available for a big-batch "
                             "request; this should not happen.")
        X = self._stack(self._stored_X)
        y = self._stack(self._stored_y)
        if all(w is None for w in self._stored_w):
            w = None
        else:
            if any(w is None for w in self._stored_w):
                warnings.warn("Some stored batches lack sample weights; "
                              "missing weights are set to 1.")
            filled = [np.ones(Xb.shape[0]) if wb is None else wb
                      for Xb, wb in zip(self._stored_X, self._stored_w)]
            w = self._stack(filled)
        self._reset_saved_batch()
        self._last_big = (X, y, w)
        return X, y, w

    def _long_batch_from_epoch(self, X, y, w, batch):
        """Contiguous slice covering the last ``upd_freq`` batches
        (``stochqn/_optimizers.py:55-79``)."""
        upd_freq = self.optimizer.bfgs_upd_freq
        diff = (batch + 1) % upd_freq
        want = upd_freq - diff
        if (batch + 1) >= want:
            st = (batch + 1 - want) * self.batch_size
            end = min(X.shape[0], (batch + 1) * self.batch_size)
        else:
            st = 0
            end = min(X.shape[0], want * self.batch_size)
        X_long = _slice_rows(X, st, end)
        y_long = _slice_rows(y, st, end)
        w_long = _slice_rows(w, st, end)
        if diff > 0:
            self._save_batch(X_long, y_long, w_long)
            X_long, y_long, w_long = self._pop_stored_batch()
        return X_long, y_long, w_long

    # -- request dispatch ------------------------------------------------- #
    def _fit_batch(self, X_batch, y_batch, w_batch, additional_kwargs,
                   is_user_batch=False, X_full=None, y_full=None, w_full=None,
                   X_val=None, y_val=None, w_val=None, batch=None):
        kw = additional_kwargs or {}
        while True:
            task = self.req["task"]
            on = self.req["requested_on"]
            if task in ("calc_grad", "calc_grad_same_batch"):
                self.optimizer.update_gradient(
                    self.grad_fun(on, X_batch, y_batch,
                                  sample_weight=w_batch, **kw))
            elif task == "calc_fun_val_batch" and X_val is not None:
                self.optimizer.update_function(
                    self.obj_fun(on, X_val, y_val, sample_weight=w_val, **kw))
            else:
                if is_user_batch:
                    X_long, y_long, w_long = self._pop_stored_batch()
                else:
                    X_long, y_long, w_long = self._long_batch_from_epoch(
                        X_full, y_full, w_full, batch)
                if task == "calc_grad_big_batch":
                    self.optimizer.update_gradient(
                        self.grad_fun(on, X_long, y_long,
                                      sample_weight=w_long, **kw))
                elif task == "calc_hess_vec":
                    self.optimizer.update_hess_vec(
                        self.hess_vec_fun(on[0], on[1], X_long, y_long,
                                          sample_weight=w_long, **kw))
                elif task == "calc_fun_val_batch":
                    self.optimizer.update_function(
                        self.obj_fun(on, X_long, y_long,
                                     sample_weight=w_long, **kw))
                else:
                    raise ValueError(f"Unexpected task {task!r}")

            if is_user_batch:
                step = self.decr_step_size(self.step_size, self.niter)
            else:
                step = self.decr_step_size(self.step_size, self.epoch)

            self.req = self.optimizer.run_optimizer(self.x, step)

            if self.verbose and (self.req["info"]["iteration_info"]
                                 != "no_problems_encountered"):
                where = (f"at iteration {self.niter}" if is_user_batch else
                         f"at iteration {self.niter}, epoch {self.epoch + 1}")
                print(f"{self.optimizer_name} - {where}: "
                      f"{self.req['info']['iteration_info']}")

            if self.req["task"] == "calc_grad":
                if self.callback_iter is not None:
                    self.callback_iter(self.x, **self.kwargs_cb)
                break

    # -- public drivers ---------------------------------------------------- #
    @staticmethod
    def _ensure_csr(X):
        """Sparse inputs must be CSR for row slicing/shuffling
        (reference: ``_check_sp_type``, ``stochqn/_optimizers.py:48-53``)."""
        if issparse(X) and X.format != "csr":
            warnings.warn("Sparse inputs are cast to CSR for row access.")
            return X.tocsr()
        return X

    def fit(self, X, y, sample_weight=None, additional_kwargs={}, valset=None,
            engine="protocol", mesh=None):
        """Fit over ``nepochs`` epochs of ``batches_per_epoch`` batches,
        optionally early-stopping on a validation objective.

        ``engine="protocol"`` (default) runs the reference-exact
        request/response loop: one host round trip per gradient, any
        callables, sparse inputs, per-iteration callbacks.

        ``engine="fused"`` runs the epochs on
        :class:`stochqn_tpu_torch.fused.FusedTrainer` when the callables
        run on tensors (probed on the ``meta`` device), falling back to the
        protocol loop, with a warning, otherwise.  Epoch shuffling, step
        schedules, validation early stopping and the final optimizer state
        are those of the protocol path; big-batch gradients and
        Hessian-vector products are evaluated on the same rows in a merged
        order, so trajectories match the protocol to float tolerance, not
        bitwise.  For SQN without ``use_grad_diff`` the Hessian-vector
        product is the user's ``hess_vec_fun`` when it passes the probe,
        and ``torch.func.jvp`` of ``grad_fun`` otherwise (with a warning
        naming why).  With no ``callback_epoch`` and no validation set the
        whole fit is one call of the engine, with nothing read on the host
        between epochs; ``verbose`` problem reports are then printed after
        the fit, the same lines, deferred.  The free-mode object's state
        is consumed by the fused engine and replaced by the fit's final
        one (:meth:`~stochqn_tpu_torch.free.SQN_free.adopt_state`), so
        ``partial_fit`` continues from there.

        ``mesh`` (a sharded fit) is not ported yet (ROADMAP A.15).
        """
        if engine not in ("protocol", "fused"):
            raise ValueError("'engine' must be 'protocol' or 'fused'")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (a sharded fused fit) is not ported yet (ROADMAP "
                "A.15, multi-GPU)")
        # introspection: how the LAST fit dispatched (refined in
        # _fit_fused; stays "protocol" on protocol runs AND on fused
        # runs that fall back before reaching _fit_fused)
        self._fused_single_dispatch = False
        self._fused_dispatch_mode = "protocol"
        X, y = self._ensure_csr(X), self._ensure_csr(y)
        if X.shape[0] <= 0 or X.shape[0] != y.shape[0]:
            raise ValueError("X and y must have matching, nonzero rows")
        if sample_weight is not None and sample_weight.shape[0] != X.shape[0]:
            raise ValueError("sample_weight must match X rows")

        if valset is not None:
            if self.obj_fun is None:
                raise ValueError("Must provide 'obj_fun' to use a validation "
                                 "set.")
            X_val, y_val, w_val = valset
            if self.valset_frac is not None:
                warnings.warn("'valset_frac' is ignored when passing an "
                              "explicit validation set.")
        elif self.valset_frac is not None:
            if sample_weight is None:
                X, X_val, y, y_val = _train_test_split(
                    (X, y), self.valset_frac, self.random_state)
                w_val = None
            else:
                X, X_val, y, y_val, sample_weight, w_val = _train_test_split(
                    (X, y, sample_weight), self.valset_frac,
                    self.random_state)
        else:
            X_val, y_val, w_val = None, None, None

        if engine == "fused":
            reason = self._fused_unsupported_reason(X, y, sample_weight)
            if reason is None:
                return self._fit_fused(X, y, sample_weight,
                                       additional_kwargs, X_val, y_val,
                                       w_val)
            warnings.warn(f"engine='fused' unavailable ({reason}); "
                          "falling back to the protocol loop.")

        obj_last_epoch = np.inf
        self.batch_size = int(np.ceil(X.shape[0] / self.batches_per_epoch))
        for self.epoch in range(self.nepochs):
            if self.shuffle_data:
                order = _epoch_shuffle_order(self.random_state, self.epoch,
                                             X.shape[0])
                X, y = _take_rows(X, order), _take_rows(y, order)
                sample_weight = _take_rows(sample_weight, order)

            for batch in range(self.batches_per_epoch):
                st = batch * self.batch_size
                end = min(X.shape[0], (batch + 1) * self.batch_size)
                self._fit_batch(
                    _slice_rows(X, st, end), _slice_rows(y, st, end),
                    _slice_rows(sample_weight, st, end), additional_kwargs,
                    is_user_batch=False, X_full=X, y_full=y,
                    w_full=sample_weight, X_val=X_val, y_val=y_val,
                    w_val=w_val, batch=batch)

            if self.callback_epoch is not None:
                self.callback_epoch(self.x, **self.kwargs_cb)

            if X_val is not None and self.obj_fun is not None:
                obj = float(self.obj_fun(self.x, X_val, y_val,
                                         sample_weight=w_val,
                                         **(additional_kwargs or {})))
                if self.verbose:
                    print(f"{self.optimizer_name} - epoch: {self.epoch + 1:2d},"
                          f" f(x): {obj:12.4f}")
                if (obj_last_epoch - obj) < self.tol and obj <= obj_last_epoch:
                    if self.verbose:
                        print(f"{self.optimizer_name} - terminated "
                              "(decrease below tolerance).")
                    break
                obj_last_epoch = obj
        return self

    # -- fused engine ------------------------------------------------------ #
    def _fused_unsupported_reason(self, X, y, sample_weight):
        """None when ``engine='fused'`` can run; else a human-readable
        reason for the protocol fallback."""
        if self.optimizer.backend != "torch":
            return f"the optimizer uses the {self.optimizer.backend} backend"
        if issparse(X) or issparse(y):
            return ("sparse inputs — use the protocol loop or the sparse "
                    "fused path in models.logistic")
        if self.callback_iter is not None:
            return "callback_iter needs per-iteration host control"
        if self.req["task"] != "calc_grad":
            return ("the optimizer is mid-iteration (last request was "
                    f"{self.req['task']!r}); finish it through "
                    "partial_fit first")
        if X.shape[0] % self.batches_per_epoch != 0:
            return (f"{X.shape[0]} rows are not divisible by "
                    f"batches_per_epoch={self.batches_per_epoch} (the "
                    "fused epoch needs equal batch shapes; the protocol "
                    "loop handles the ragged tail)")
        return self._check_traceable(X, y, sample_weight)

    def _wrap_torch_funs(self, additional_kwargs):
        """The guided callables (``fn(x, X, y, sample_weight=..., **kw)``)
        as fused-engine ``fn(x, batch)`` functions on tensors; ``batch``
        is ``(X, y)`` or ``(X, y, w)``.  Returns ``(grad_fn, obj_fn,
        hess_vec_fn)``; the last is ``None`` when the user supplied no
        ``hess_vec_fun``."""
        kw = dict(additional_kwargs or {})

        def unpack(batch):
            if len(batch) == 3:
                return batch
            Xb, yb = batch
            return Xb, yb, None

        def grad_fn(xv, batch):
            Xb, yb, wb = unpack(batch)
            g = self.grad_fun(xv, Xb, yb, sample_weight=wb, **kw)
            return torch.as_tensor(g, dtype=xv.dtype,
                                   device=xv.device).reshape(-1)

        obj_fn = None
        if self.obj_fun is not None:
            def obj_fn(xv, batch):
                Xb, yb, wb = unpack(batch)
                return torch.as_tensor(
                    self.obj_fun(xv, Xb, yb, sample_weight=wb, **kw),
                    dtype=xv.dtype, device=xv.device)

        hess_vec_fn = None
        if self.hess_vec_fun is not None:
            def hess_vec_fn(xv, v, batch):
                Xb, yb, wb = unpack(batch)
                hv = self.hess_vec_fun(xv, v, Xb, yb, sample_weight=wb,
                                       **kw)
                return torch.as_tensor(hv, dtype=xv.dtype,
                                       device=xv.device).reshape(-1)
        return grad_fn, obj_fn, hess_vec_fn

    def _fused_needs_obj(self) -> bool:
        """Does the fused engine call ``obj_fun`` (adaQN's function-value
        guard)?  Validation early stopping stays on the host either way."""
        return (self.optimizer_name == "adaQN"
                and self.optimizer.max_incr > 0)

    def _probe(self, X, y, sample_weight):
        """Tensors on the ``meta`` device shaped like one batch of
        ``(X, y[, w])`` and like ``x``: they run shapes without data, the
        way the JAX package's ``jax.eval_shape`` does."""
        bs = X.shape[0] // self.batches_per_epoch
        dtype = self.optimizer.dtype

        def spec(a):
            arr = np.asarray(a)
            return torch.empty((bs,) + arr.shape[1:],
                               dtype=_data_dtype(arr, dtype), device="meta")
        batch = (spec(X), spec(y))
        if sample_weight is not None:
            batch += (spec(sample_weight),)
        return torch.empty(self.n, dtype=dtype, device="meta"), batch

    def _check_traceable(self, X, y, sample_weight):
        """A reason string when the callables do not run on tensors."""
        grad_fn, obj_fn, _ = self._wrap_torch_funs({})
        x_spec, batch = self._probe(X, y, sample_weight)
        try:
            out = grad_fn(x_spec, batch)
            if out.shape != (self.n,):
                return (f"grad_fun returned shape {tuple(out.shape)}, "
                        f"expected ({self.n},)")
            if self._fused_needs_obj():
                obj_fn(x_spec, batch)
        except Exception as exc:   # noqa: BLE001 — any probe failure
            return f"callables are not traceable on tensors: {exc}"
        return None

    def _traced_hess_vec(self, hess_vec_fn, X, y, w):
        """The user's ``hess_vec_fun`` when it passes the probe, else None
        (the engine then takes ``torch.func.jvp`` of ``grad_fn``), with a
        warning naming why.  The protocol loop never probes it, so a
        numpy-only callable must keep working there."""
        x_spec, batch = self._probe(X, y, w)
        try:
            out = hess_vec_fn(x_spec, x_spec, batch)
        except Exception as exc:   # noqa: BLE001 — any probe failure
            reason = f"it is not traceable on tensors: {exc}"
        else:
            if out.shape == (self.n,):
                return hess_vec_fn
            reason = (f"it returned shape {tuple(out.shape)}, expected "
                      f"({self.n},)")
        warnings.warn(f"engine='fused' takes torch.func.jvp of grad_fun in "
                      f"place of hess_vec_fun: {reason}")
        return None

    def _fit_fused(self, X, y, w, additional_kwargs, X_val, y_val, w_val):
        """The epochs on :class:`FusedTrainer`.  Same epoch shuffle order
        (``np.random.seed(random_state + epoch)`` + argsort), step schedule,
        early stopping and callbacks as the protocol path; see ``fit`` for
        the float-order deltas.  ``orders`` and the step sizes are built on
        the host once and copied to the state's device once."""
        dtype, device = self.optimizer.dtype, self.optimizer.device
        grad_fn, obj_fn, hess_vec_fn = self._wrap_torch_funs(
            additional_kwargs)
        if hess_vec_fn is not None:
            hess_vec_fn = self._traced_hess_vec(hess_vec_fn, X, y, w)

        def on_device(*arrays):
            return tuple(_to_device(a, dtype, device) for a in arrays
                         if a is not None)
        val_data = None
        if X_val is not None and self._fused_needs_obj():
            # adaQN's guard evaluates on the validation set when one
            # exists (protocol: the valset branch of _fit_batch)
            val_data = on_device(X_val, y_val, w_val)
        trainer = FusedTrainer(
            self.optimizer_name, self.optimizer._cfg, grad_fn,
            obj_fn=obj_fn if self._fused_needs_obj() else None,
            val_data=val_data, hess_vec_fn=hess_vec_fn)

        state = self.optimizer.state
        B = self.batches_per_epoch
        self.batch_size = X.shape[0] // B
        L = getattr(self.optimizer, "bfgs_upd_freq", 1)
        niter = self.optimizer.niter      # the host copy: no device read
        kw = additional_kwargs or {}
        obj_last_epoch = np.inf
        last_info = Info.NO_PROBLEMS_ENCOUNTERED
        parts = on_device(X, y, w)

        # Without a per-epoch callback or valset early stop the whole fit
        # is one call of the engine, which reads nothing on the host
        # between epochs: the per-epoch shuffle and step decay are
        # deterministic in the epoch index, so the composed row orders and
        # step sizes are precomputed and each epoch gathers its rows on
        # the device (epochs_scheduled).
        single_dispatch = (self.callback_epoch is None
                           and X_val is None
                           and self.nepochs > 1)
        self._fused_single_dispatch = single_dispatch
        self._fused_dispatch_mode = "loop"      # refined below
        if single_dispatch:
            # aligned=True only when EVERY epoch starts on an update-period
            # boundary; otherwise the generic (misaligned) layout is used;
            # trajectories are identical either way.
            aligned = (niter % L == 0) and (B % L == 0)
            if self.shuffle_data:
                # Cumulative composed permutations, the protocol loop's
                # reshuffle-the-already-shuffled-arrays semantics: cur maps
                # epoch-order position -> absolute row.
                self._fused_dispatch_mode = "scheduled"
                n_rows = X.shape[0]
                cur = np.arange(n_rows)
                orders = np.empty((self.nepochs, n_rows), np.int64)
                steps = np.empty((self.nepochs,), np.float64)
                for e in range(self.nepochs):
                    cur = cur[_epoch_shuffle_order(self.random_state, e,
                                                   n_rows)]
                    orders[e] = cur
                    steps[e] = self.decr_step_size(self.step_size, e)
                state, infos = trainer.epochs_scheduled(
                    state, parts,
                    torch.as_tensor(steps, dtype=dtype, device=device),
                    torch.as_tensor(orders, device=device),
                    batch_size=self.batch_size, aligned=aligned)
            else:
                # Fixed batches; the step schedule (if any) is one
                # [nepochs] tensor: no per-epoch gathers.
                const = self.decr_step_size is step_size_const
                self._fused_dispatch_mode = "invariant" if const else "decay"
                if const:
                    steps = self.step_size
                else:
                    steps = torch.as_tensor(
                        [self.decr_step_size(self.step_size, e)
                         for e in range(self.nepochs)], dtype=dtype,
                        device=device)
                state, infos = trainer.epochs(
                    state, batchify(parts, self.batch_size), steps,
                    nepochs=self.nepochs, aligned=aligned)
            infos_np = infos.cpu().numpy()           # [nepochs, B]
            last_info = Info(int(infos_np[-1, -1]))
            if self.verbose:
                for epoch in range(self.nepochs):
                    self._print_infos(infos_np[epoch], niter + epoch * B,
                                      epoch)
            self.epoch = self.nepochs - 1
            return self._finish_fused(state, last_info)

        # Shuffling is cumulative like the protocol loop's (each epoch
        # reshuffles the already-shuffled rows), so the two engines see
        # the same row orders; each epoch is one gather on the device.
        cur = np.arange(X.shape[0])
        for self.epoch in range(self.nepochs):
            data = parts
            if self.shuffle_data:
                cur = cur[_epoch_shuffle_order(self.random_state, self.epoch,
                                               X.shape[0])]
                order = torch.as_tensor(cur, device=device)
                data = tuple(p.index_select(0, order) for p in parts)
            eta = self.decr_step_size(self.step_size, self.epoch)
            state, infos = trainer.epoch(state,
                                         batchify(data, self.batch_size),
                                         eta, aligned=niter % L == 0)
            infos_np = infos.cpu().numpy()
            last_info = Info(int(infos_np[-1]))
            if self.verbose:
                self._print_infos(infos_np, niter, self.epoch)
            niter += B

            x_np = state.x.cpu().numpy()
            if self.callback_epoch is not None:
                self.callback_epoch(x_np, **self.kwargs_cb)

            if X_val is not None and self.obj_fun is not None:
                obj = float(self.obj_fun(x_np, X_val, y_val,
                                         sample_weight=w_val, **kw))
                if self.verbose:
                    print(f"{self.optimizer_name} - epoch: "
                          f"{self.epoch + 1:2d}, f(x): {obj:12.4f}")
                if (obj_last_epoch - obj) < self.tol and obj <= obj_last_epoch:
                    if self.verbose:
                        print(f"{self.optimizer_name} - terminated "
                              "(decrease below tolerance).")
                    break
                obj_last_epoch = obj

        return self._finish_fused(state, last_info)

    def _print_infos(self, row, base, epoch):
        """The protocol loop's verbose lines for one fused epoch's codes."""
        for i in np.flatnonzero(row != int(Info.NO_PROBLEMS_ENCOUNTERED)):
            print(f"{self.optimizer_name} - at iteration {base + int(i) + 1},"
                  f" epoch {epoch + 1}: {INFO_NAMES[Info(int(row[i]))]}")

    def _finish_fused(self, state, last_info):
        """Hand the live state back to the free-mode protocol object: the
        fused steps end exactly at an iteration boundary (section 1,
        awaiting calc_grad), so partial_fit / run_optimizer continue
        seamlessly."""
        self.optimizer.adopt_state(state)
        self.x = state.x.cpu().numpy().astype(self.x.dtype).reshape(-1)
        self.req = {
            "task": "calc_grad",
            "requested_on": self.x.copy(),
            "info": {
                "x_changed_in_run": True,
                "iteration_number": self.optimizer.niter,
                "iteration_info": INFO_NAMES[last_info],
            },
        }
        return self

    def partial_fit(self, X, y, sample_weight=None, additional_kwargs={}):
        """Update with a single user-provided batch.

        For SQN (and adaQN with ``use_grad_diff`` or ``max_incr``) the batch
        is retained in a stored-batch container that serves future big-batch
        / Hessian-vector requests (``stochqn/_optimizers.py:288-337``)."""
        X, y = self._ensure_csr(X), self._ensure_csr(y)
        if self._saves_batches():
            self._save_batch(X, y, sample_weight)
        self._fit_batch(X, y, sample_weight, additional_kwargs,
                        is_user_batch=True)
        return self

    def _saves_batches(self) -> bool:
        return False

    def __repr__(self):
        return (f"{type(self).__name__}(n={self.n}, "
                f"batches_per_epoch={self.batches_per_epoch}, "
                f"step_size={self.step_size}, iteration {self.niter})")


class oLBFGS(_GuidedBase):
    """Guided oLBFGS (reference: ``stochqn/_optimizers.py:416-522``)."""

    optimizer_name = "oLBFGS"

    def __init__(self, x0, grad_fun, obj_fun=None, pred_fun=None,
                 batches_per_epoch=25, step_size=1e-3, decr_step_size="auto",
                 shuffle_data=True, random_state=1, nepochs=25,
                 valset_frac=None, tol=1e-1, callback_epoch=None,
                 callback_iter=None, kwargs_cb={}, verbose=True, mem_size=10,
                 hess_init=None, min_curvature=1e-4, y_reg=None,
                 check_nan=True, nthreads=-1, use_float=False, dtype=None,
                 device=None, backend="torch", pairs_bf16=False,
                 pairs_interleaved=False):
        self.optimizer = oLBFGS_free(
            mem_size=mem_size, hess_init=hess_init,
            min_curvature=min_curvature, y_reg=y_reg, check_nan=check_nan,
            nthreads=nthreads, use_float=use_float, dtype=dtype,
            device=device, backend=backend, pairs_bf16=pairs_bf16,
            pairs_interleaved=pairs_interleaved)
        self._setup_common(x0, grad_fun, obj_fun, pred_fun, None,
                           batches_per_epoch, step_size, decr_step_size,
                           shuffle_data, random_state, nepochs, valset_frac,
                           tol, callback_epoch, callback_iter, kwargs_cb,
                           verbose)


class SQN(_GuidedBase):
    """Guided SQN (reference: ``stochqn/_optimizers.py:524-650``)."""

    optimizer_name = "SQN"

    def __init__(self, x0, grad_fun, obj_fun=None, hess_vec_fun=None,
                 pred_fun=None, batches_per_epoch=25, step_size=1e-3,
                 decr_step_size="auto", shuffle_data=True, random_state=1,
                 nepochs=25, valset_frac=None, tol=1e-1, callback_epoch=None,
                 callback_iter=None, kwargs_cb={}, verbose=True, mem_size=10,
                 bfgs_upd_freq=20, min_curvature=1e-4, y_reg=None,
                 use_grad_diff=False, check_nan=True, nthreads=-1,
                 use_float=False, dtype=None, device=None, backend="torch",
                 pairs_bf16=False, pairs_interleaved=False):
        if not use_grad_diff and hess_vec_fun is None:
            raise ValueError("Without 'use_grad_diff', must provide "
                             "'hess_vec_fun'.")
        if hess_vec_fun is not None and use_grad_diff:
            warnings.warn("'hess_vec_fun' is ignored with "
                          "'use_grad_diff=True'.")
        self.optimizer = SQN_free(
            mem_size=mem_size, bfgs_upd_freq=bfgs_upd_freq,
            min_curvature=min_curvature, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            nthreads=nthreads, use_float=use_float, dtype=dtype,
            device=device, backend=backend, pairs_bf16=pairs_bf16,
            pairs_interleaved=pairs_interleaved)
        self._setup_common(x0, grad_fun, obj_fun, pred_fun, hess_vec_fun,
                           batches_per_epoch, step_size, decr_step_size,
                           shuffle_data, random_state, nepochs, valset_frac,
                           tol, callback_epoch, callback_iter, kwargs_cb,
                           verbose)

    def _saves_batches(self) -> bool:
        return True


class adaQN(_GuidedBase):
    """Guided adaQN (reference: ``stochqn/_optimizers.py:652-785``)."""

    optimizer_name = "adaQN"

    def __init__(self, x0, grad_fun, obj_fun=None, pred_fun=None,
                 batches_per_epoch=25, step_size=1e-1, decr_step_size=None,
                 shuffle_data=True, random_state=1, nepochs=25,
                 valset_frac=None, tol=1e-1, callback_epoch=None,
                 callback_iter=None, kwargs_cb={}, verbose=True, mem_size=10,
                 fisher_size=100, bfgs_upd_freq=20, max_incr=1.01,
                 min_curvature=1e-4, y_reg=None, scal_reg=1e-4,
                 rmsprop_weight=None, use_grad_diff=False, check_nan=True,
                 nthreads=-1, use_float=False, dtype=None,
                 h0_exact_reference=True, device=None, backend="torch"):
        if max_incr is not None and obj_fun is None:
            raise ValueError("Must provide 'obj_fun' when passing 'max_incr'.")
        if use_grad_diff and fisher_size is not None:
            warnings.warn("'fisher_size' ignored with 'use_grad_diff=True'.")
        self.optimizer = adaQN_free(
            mem_size=mem_size, fisher_size=fisher_size,
            bfgs_upd_freq=bfgs_upd_freq, max_incr=max_incr,
            min_curvature=min_curvature, scal_reg=scal_reg,
            rmsprop_weight=rmsprop_weight, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            nthreads=nthreads, use_float=use_float, dtype=dtype,
            h0_exact_reference=h0_exact_reference, device=device,
            backend=backend)
        self._setup_common(x0, grad_fun, obj_fun, pred_fun, None,
                           batches_per_epoch, step_size, decr_step_size,
                           shuffle_data, random_state, nepochs, valset_frac,
                           tol, callback_epoch, callback_iter, kwargs_cb,
                           verbose)

    def _saves_batches(self) -> bool:
        return (self.optimizer.use_grad_diff
                or self.optimizer.max_incr > 0)
