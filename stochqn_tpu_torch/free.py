"""Free-mode optimizer API: the reference's request/response protocol.

Counterpart of :mod:`stochqn_tpu.free`, drop-in equivalents of the
reference's classes (``stochqn/_optimizers.py:929-1364``): the user owns
the evaluation loop, the optimizer answers every call with a request dict

    {"task": str,
     "requested_on": array | (array, array),
     "info": {"x_changed_in_run": bool,
              "iteration_number": int,
              "iteration_info": str}}

identical in schema and task ordering to the reference
(``stochqn/_optimizers.py:1004-1016``).

Each call runs one ``advance`` transition
(``stochqn_tpu_torch.core.{olbfgs,sqn,adaqn}``) on a state that lives on
``device``: the card by default (no CUDA device: the constructor raises;
pass ``device="cpu"`` for the CPU).  ``requested_on`` comes back as numpy
arrays, as in the JAX package; ``update_gradient``, ``update_hess_vec`` and
``update_function`` take numpy arrays or torch tensors.  A numpy array is
copied, so the caller may refill it before the next ``run_optimizer``; a
tensor that already has the optimizer's dtype and device is used where it
is.

Host reads per ``run_optimizer`` call: ``advance`` reads the state's
section and iteration number (one read), the wrapper reads the result
codes (one read) and copies ``x`` to the host (for the in-place write-back
and for a ``calc_grad`` request); a request at another point (the averages
of a boundary) copies that too, and adaQN's section 5 reads the guard's
verdict.  For loops that never wait for the host use
:mod:`stochqn_tpu_torch.fused`.

``use_float=False`` selects float64, like the reference; ``use_float=True``
float32, the dtype the hand-written kernels take (float64 runs the same
math in plain torch).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from stochqn_tpu_torch.core import adaqn, olbfgs, sqn
from stochqn_tpu_torch.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu_torch.core.enums import INFO_NAMES, TASK_NAMES, Info, Task
from stochqn_tpu_torch.core.protocol import host_ints, resolve_device


def _resolve_dtype(use_float: bool, dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32 if use_float else torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class _StochQNFree:
    """Shared machinery of the free-mode wrappers.

    ``device`` takes the place of the JAX package's ``backend``: where the
    state lives and ``advance`` runs.  ``backend="native"`` (the C++ core
    through ctypes) is not ported (ROADMAP A.16).
    """

    _cfg = None          # set by subclass __init__
    _init_fn = None      # staticmethod init(x0, cfg)
    _advance_fn = None   # staticmethod advance(cfg, state, *inputs)

    def __init__(self, device=None, backend: str = "torch"):
        if backend == "native":
            raise NotImplementedError(
                "backend='native' (the C++ core) is not reachable from "
                "this package yet (ROADMAP A.16)")
        if backend != "torch":
            raise ValueError("backend must be 'torch' or 'native'")
        self.backend = backend
        self.device = resolve_device(device)
        self.state = None
        self._n = None
        self._niter = 0
        self._gradient = None

    # -- evaluation inputs -------------------------------------------------
    def _vector(self, value, what: str) -> torch.Tensor:
        """``value`` as a flat tensor of the optimizer's dtype on its
        device, with the reference's length check
        (``stochqn/_optimizers.py:917-927``).  Anything but a tensor is
        copied: ``torch.as_tensor`` would share a numpy array's memory on
        the CPU."""
        convert = (torch.as_tensor if isinstance(value, torch.Tensor)
                   else torch.tensor)
        arr = convert(value, dtype=self.dtype,
                      device=self.device).reshape(-1)
        if self._n is not None and arr.shape[0] != self._n:
            raise ValueError(
                f"{what} has {arr.shape[0]} elements, expected {self._n}")
        return arr

    def update_gradient(self, gradient) -> None:
        """Pass the requested gradient to the optimizer (any of the
        ``calc_grad*`` tasks)."""
        self._gradient = self._vector(gradient, "gradient")

    # -- protocol ----------------------------------------------------------
    def _initialize(self, x) -> None:
        x = torch.as_tensor(x, dtype=self.dtype,
                            device=self.device).reshape(-1)
        self._n = x.shape[0]
        self.state = self._init_fn(x, self._cfg)
        self._zero_inputs()

    def _zero_inputs(self) -> None:
        """Fresh evaluation buffers for an ``n``-sized state."""
        self._gradient = torch.zeros(self._n, dtype=self.dtype,
                                     device=self.device)

    def adopt_state(self, state) -> None:
        """Continue the protocol from ``state``: a fused fit's, or one
        loaded with :func:`stochqn_tpu_torch.utils.checkpoint.load_state`.
        The next :meth:`run_optimizer` resumes at its ``section``; ``niter``
        is read once, here.  The state must have this optimizer's kind,
        dtype and device."""
        if state.x.dtype != self.dtype:
            raise ValueError(f"the state is {state.x.dtype}, this optimizer "
                             f"{self.dtype}")
        self.state = state
        self._n = state.x.shape[0]
        self._niter = int(state.niter)
        self._zero_inputs()

    def _extra_inputs(self) -> Tuple:
        return ()

    def run_optimizer(self, x, step_size) -> dict:
        """Advance the optimizer until its next external request.

        ``x`` is consumed on the first call; afterwards the internal state
        is authoritative and, when ``x`` is a numpy array, the new iterate
        is written back into it in place (matching the reference's in-place
        mutation contract, ``stochqn/_optimizers.py:997-999``).
        """
        if self.state is None:
            self._initialize(x)
        self.state, res = self._advance_fn(
            self._cfg, self.state, self._gradient, *self._extra_inputs(),
            step_size)
        st = self.state
        task_i, info_i, changed, niter, section = host_ints(
            res.task, res.info, res.x_changed.to(torch.int32),
            st.niter.to(torch.int32), st.section.to(torch.int32))
        task = Task(task_i)
        self._niter = niter

        x_host = None
        if isinstance(x, np.ndarray) and x.size == self._n:
            x_host = st.x.cpu().numpy()
            # copy into x's own memory (reshape(-1) could be a copy for
            # non-contiguous views)
            np.copyto(x, x_host.astype(x.dtype, copy=False).reshape(x.shape))
        requested_on = self._requested_on(task, section)
        if requested_on is None:
            requested_on = x_host if x_host is not None else _numpy(st.x)
        return {
            "task": TASK_NAMES[task],
            "requested_on": requested_on,
            "info": {
                "x_changed_in_run": bool(changed),
                "iteration_number": niter,
                "iteration_info": INFO_NAMES[Info(info_i)],
            },
        }

    # -- helpers -----------------------------------------------------------
    @property
    def n(self) -> Optional[int]:
        return self._n

    @property
    def niter(self) -> int:
        return self._niter

    def _requested_on(self, task: Task, section: int):
        """The point(s) of a request that is not at ``x``, as numpy; None
        for a request at ``x``."""
        raise NotImplementedError

    def __repr__(self):
        """Human-readable summary (the analogue of the reference's
        ``print.*_free`` S3 methods, ``R/optimizers_free.R:688-735``)."""
        name = type(self).__name__
        cfg = ", ".join(f"{f}={getattr(self._cfg, f)!r}"
                        for f in self._cfg.__dataclass_fields__)
        status = ("not yet initialized" if self._n is None else
                  f"n={self._n}, iteration {self.niter}")
        return f"{name}({cfg}) [{status}, device={self.device}]"


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class oLBFGS_free(_StochQNFree):
    """oLBFGS in free mode.  Request order (reference docstring,
    ``stochqn/_optimizers.py:938-943``)::

        ==== loop ====
        * calc_grad
        * calc_grad_same_batch   (may be skipped after a rejected direction)
        ==============
    """

    _init_fn = staticmethod(olbfgs.init)
    _advance_fn = staticmethod(olbfgs.advance)

    def __init__(self, mem_size=10, hess_init=None, min_curvature=1e-4,
                 y_reg=None, check_nan=True, nthreads=-1, use_float=False,
                 dtype=None, device=None, backend="torch", pairs_bf16=False,
                 pairs_interleaved=False):
        super().__init__(device, backend)
        del nthreads
        self.dtype = _resolve_dtype(use_float, dtype)
        self._cfg = OLBFGSConfig.create(
            mem_size=mem_size, hess_init=hess_init,
            min_curvature=min_curvature, y_reg=y_reg, check_nan=check_nan,
            pairs_bf16=pairs_bf16, pairs_interleaved=pairs_interleaved)

    def _requested_on(self, task: Task, section: int):
        return None          # every request is at x


class SQN_free(_StochQNFree):
    """SQN in free mode.  Request order (reference docstring,
    ``stochqn/_optimizers.py:1057-1066``)::

        ==== loop ====
        * calc_grad  (x upd_freq)
        * calc_grad_big_batch  (use_grad_diff)  |  calc_hess_vec
        ==============
    """

    _init_fn = staticmethod(sqn.init)
    _advance_fn = staticmethod(sqn.advance)

    def __init__(self, mem_size=10, bfgs_upd_freq=20, min_curvature=1e-4,
                 y_reg=None, use_grad_diff=False, check_nan=True, nthreads=-1,
                 use_float=False, dtype=None, device=None, backend="torch",
                 pairs_bf16=False, pairs_interleaved=False):
        super().__init__(device, backend)
        del nthreads  # parallelism is the device's job here
        self.dtype = _resolve_dtype(use_float, dtype)
        self._cfg = SQNConfig.create(
            mem_size=mem_size, bfgs_upd_freq=bfgs_upd_freq,
            min_curvature=min_curvature, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            pairs_bf16=pairs_bf16, pairs_interleaved=pairs_interleaved)
        self._hess_vec = None

    @property
    def bfgs_upd_freq(self) -> int:
        return self._cfg.upd_freq

    @property
    def use_grad_diff(self) -> bool:
        return self._cfg.use_grad_diff

    def _zero_inputs(self) -> None:
        super()._zero_inputs()
        self._hess_vec = torch.zeros(self._n, dtype=self.dtype,
                                     device=self.device)

    def update_hess_vec(self, hess_vec) -> None:
        """Pass the requested Hessian-vector product (task
        ``calc_hess_vec``)."""
        self._hess_vec = self._vector(hess_vec, "hess_vec")

    def _extra_inputs(self) -> Tuple:
        return (self._hess_vec,)

    def _requested_on(self, task: Task, section: int):
        st = self.state
        if task == Task.CALC_HESS_VEC:
            return (_numpy(st.x_sum), _numpy(st.mem.s_pending))
        if task == Task.CALC_GRAD_BIG_BATCH:
            return _numpy(st.x_avg_prev if section == 2 else st.x_sum)
        return None


class adaQN_free(_StochQNFree):
    """adaQN in free mode.  Request order (reference docstring,
    ``stochqn/_optimizers.py:1201-1210``)::

        ==== loop ====
        * calc_grad  (x upd_freq)
        if max_incr:        * calc_fun_val_batch
        if use_grad_diff:   * calc_grad_big_batch  (skipped on func_increased)
        ==============
    """

    _init_fn = staticmethod(adaqn.init)
    _advance_fn = staticmethod(adaqn.advance)

    def __init__(self, mem_size=10, fisher_size=100, bfgs_upd_freq=20,
                 max_incr=1.01, min_curvature=1e-4, scal_reg=1e-4,
                 rmsprop_weight=None, y_reg=None, use_grad_diff=False,
                 check_nan=True, nthreads=-1, use_float=False, dtype=None,
                 h0_exact_reference=True, device=None, backend="torch"):
        super().__init__(device, backend)
        del nthreads
        self.dtype = _resolve_dtype(use_float, dtype)
        self._cfg = AdaQNConfig.create(
            mem_size=mem_size, fisher_size=fisher_size,
            bfgs_upd_freq=bfgs_upd_freq, max_incr=max_incr,
            min_curvature=min_curvature, scal_reg=scal_reg,
            rmsprop_weight=rmsprop_weight, y_reg=y_reg,
            use_grad_diff=use_grad_diff, check_nan=check_nan,
            h0_exact_reference=h0_exact_reference)
        self._f = 0.0

    @property
    def bfgs_upd_freq(self) -> int:
        return self._cfg.upd_freq

    @property
    def max_incr(self) -> float:
        return self._cfg.max_incr

    @property
    def use_grad_diff(self) -> bool:
        return self._cfg.use_grad_diff

    def update_function(self, fun) -> None:
        """Pass the requested function value (task ``calc_fun_val_batch``):
        a number, or a one-element array or tensor."""
        self._f = fun

    def _extra_inputs(self) -> Tuple:
        return (self._f,)

    def _requested_on(self, task: Task, section: int):
        st = self.state
        if task in (Task.CALC_GRAD_BIG_BATCH, Task.CALC_FUN_VAL_BATCH):
            return _numpy(st.x_avg_prev if section in (2, 3) else st.x_sum)
        return None
