"""Optimizer state: dataclasses of tensors.

Counterpart of :mod:`stochqn_tpu.core.state` (block-layout
:class:`BFGSMemory` and :class:`SQNState`).  Field names, shapes and
meanings are the same; the differences are PyTorch idiom:

* integer scalars and the permutation (``head``, ``count``, ``perm``,
  ``niter``, ``section``) are ``int64`` tensors, because torch indexes
  with ``int64`` (the JAX package uses ``int32``;
  :mod:`stochqn_tpu_torch.convert` casts between the two);
* every tensor lives on the device the state was created on, and nothing
  moves it;
* the ring rows ``s``/``y`` are updated in place by
  :func:`stochqn_tpu_torch.ops.pairs.commit_pair`, so a memory passed to a
  commit is consumed (see there).

Every field owns its own buffer (the rule behind the JAX package's
``_own``): :meth:`SQNState.create` copies ``x0`` and allocates one
buffer per field, so an in-place update never reaches a caller's tensor
or another field.

There are no ``s_bak`` / ``y_bak`` backup buffers, as in the JAX package:
a rejected pair is never committed.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BFGSMemory:
    """Ring buffer of (s, y) correction pairs, chronological via head/count.

    Block layout: ``W = [s; y]`` is ``[2m, n]``.  ``head`` is the next
    write slot, ``count`` the number of live pairs; the earliest live pair
    sits at ``(head - count) mod m``.  ``s_pending`` holds the candidate
    ``s`` until its ``y`` arrives and the curvature test decides.

    ``gram`` caches ``W W^T`` (storage order), maintained incrementally on
    every commit.  The rest is the commit-time small-math cache of the
    two-loop (chronological order): ``perm``, ``rho``, the inverted
    backward/forward triangular systems, chronological ``Y Y^T``, the
    forward coupling ``rl_c`` and the default ``gamma``.  ``c0``/``cg``
    collapse the whole gamma-scaled two-loop into
    ``d = gamma*g + W^T ((c0 + gamma*cg) @ (W g))``; they are zeros unless
    the commit ran with ``direction_cache=True``.
    """

    s: torch.Tensor          # [m, n] storage dtype
    y: torch.Tensor          # [m, n] storage dtype
    gram: torch.Tensor       # [2m, 2m] cached W W^T
    s_pending: torch.Tensor  # [n]
    head: torch.Tensor       # int64 scalar: next slot to write
    count: torch.Tensor      # int64 scalar: number of live pairs
    perm: torch.Tensor       # [m] int64: chrono -> storage row
    rho: torch.Tensor        # [m] 1/(s.y), masked to 0 when invalid
    bwd_inv: torch.Tensor    # [m, m] (I + diag(rho) triu(SY,1))^{-1}
    fwd_inv: torch.Tensor    # [m, m] (I + diag(rho) tril(YS,-1))^{-1}
    yy_c: torch.Tensor       # [m, m] chronological Y Y^T
    rl_c: torch.Tensor       # [m, m] diag(rho) tril(YS,-1)
    gamma: torch.Tensor      # scalar: default H0 = (s.y)/(y.y) of latest pair
    c0: torch.Tensor         # [2m, 2m]
    cg: torch.Tensor         # [2m, 2m]

    @classmethod
    def create(cls, mem_size: int, n: int, dtype=torch.float32,
               storage_dtype=None, device=None) -> "BFGSMemory":
        gram_t = torch.promote_types(dtype, torch.float32)
        m = mem_size
        st_t = dtype if storage_dtype is None else storage_dtype

        def zeros(*shape, dt=gram_t):
            return torch.zeros(shape, dtype=dt, device=device)

        def scalar_i64():
            return torch.zeros((), dtype=torch.int64, device=device)

        return cls(
            s=zeros(m, n, dt=st_t),
            y=zeros(m, n, dt=st_t),
            gram=zeros(2 * m, 2 * m),
            s_pending=zeros(n, dt=dtype),
            head=scalar_i64(),
            count=scalar_i64(),
            perm=torch.arange(m, dtype=torch.int64, device=device),
            rho=zeros(m),
            bwd_inv=torch.eye(m, dtype=gram_t, device=device),
            fwd_inv=torch.eye(m, dtype=gram_t, device=device),
            yy_c=zeros(m, m),
            rl_c=zeros(m, m),
            gamma=torch.ones((), dtype=gram_t, device=device),
            c0=zeros(2 * m, 2 * m),
            cg=zeros(2 * m, 2 * m),
        )

    @property
    def mem_size(self) -> int:
        return self.s.shape[0]

    def replace(self, **changes) -> "BFGSMemory":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class SQNState:
    """Full SQN optimizer state (``workspace_SQN``,
    ``include/stochqn.h:122-133``).

    ``x_sum`` doubles as ``x_avg`` after division, as in the reference
    (``src/stochqn.c:134``) and the JAX package.
    """

    x: torch.Tensor
    mem: BFGSMemory
    grad_prev: torch.Tensor   # [n] big-batch gradient at previous average
    x_sum: torch.Tensor       # [n] sum (or, post-division, average) of iterates
    x_avg_prev: torch.Tensor  # [n]
    niter: torch.Tensor       # int64 scalar
    section: torch.Tensor     # int64 scalar (0..4)

    @classmethod
    def create(cls, x0: torch.Tensor, mem_size: int) -> "SQNState":
        x0 = x0.detach().clone()          # owned: never the caller's buffer
        n = x0.shape[0]
        dev = x0.device

        def zeros_n():
            return torch.zeros(n, dtype=x0.dtype, device=dev)

        return cls(
            x=x0,
            mem=BFGSMemory.create(mem_size, n, x0.dtype, device=dev),
            grad_prev=zeros_n(),
            x_sum=zeros_n(),
            x_avg_prev=zeros_n(),
            niter=torch.zeros((), dtype=torch.int64, device=dev),
            section=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def replace(self, **changes) -> "SQNState":
        return dataclasses.replace(self, **changes)
