"""Optimizer state: dataclasses of tensors.

Counterpart of :mod:`stochqn_tpu.core.state` (:class:`BFGSMemory`,
:class:`BFGSMemoryInterleaved`, :class:`OLBFGSState`, :class:`SQNState`,
:class:`FisherMemory` and :class:`AdaQNState`).  Field names, shapes and
meanings are the same; the differences are PyTorch idiom:

* integer scalars and the permutation (``head``, ``count``, ``perm``,
  ``niter``, ``section``) are ``int64`` tensors, because torch indexes
  with ``int64`` (the JAX package uses ``int32``;
  :mod:`stochqn_tpu_torch.convert` casts between the two);
* every tensor lives on the device the state was created on, and nothing
  moves it;
* the ring rows ``s``/``y`` (and an interleaved memory's ``sy`` in ring
  mode) are updated in place by
  :func:`stochqn_tpu_torch.ops.pairs.commit_pair`, so a memory passed to a
  commit is consumed (see there); so is the Fisher ring row written by
  :meth:`FisherMemory.append` in ring mode.

Every field owns its own buffer (the rule behind the JAX package's
``_own``): :meth:`SQNState.create` copies ``x0`` and allocates one
buffer per field, so an in-place update never reaches a caller's tensor
or another field.

There are no ``s_bak`` / ``y_bak`` backup buffers, as in the JAX package:
a rejected pair is never committed.

``pairs_bf16`` / ``fisher_bf16`` store the pair rows (``s``/``y`` or
``sy``) or the Fisher rows in bfloat16; every other field, and all the
math, stays in the iterate's dtype.  A row is rounded to nearest even
when it is written, as ``jnp.astype`` rounds it.
"""
from __future__ import annotations

import dataclasses

import torch


def _empty_cache(m: int, n: int, dtype, device) -> dict:
    """Every field of an empty pair memory but the pair rows: one buffer
    per field."""
    gram_t = torch.promote_types(dtype, torch.float32)

    def zeros(*shape):
        return torch.zeros(shape, dtype=gram_t, device=device)

    def scalar_i64():
        return torch.zeros((), dtype=torch.int64, device=device)

    return dict(
        gram=zeros(2 * m, 2 * m),
        s_pending=torch.zeros(n, dtype=dtype, device=device),
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
        st_t = dtype if storage_dtype is None else storage_dtype
        return cls(s=torch.zeros((mem_size, n), dtype=st_t, device=device),
                   y=torch.zeros((mem_size, n), dtype=st_t, device=device),
                   **_empty_cache(mem_size, n, dtype, device))

    @property
    def mem_size(self) -> int:
        return self.s.shape[0]

    def flush(self) -> "BFGSMemory":
        """Logically empty the memory (data stays, indices reset):
        ``flush_bfgs_mem``, ``src/stochqn.c:554-558``."""
        return self.replace(head=torch.zeros_like(self.head),
                            count=torch.zeros_like(self.count))

    def replace(self, **changes) -> "BFGSMemory":
        return dataclasses.replace(self, **changes)


# Above this pair-buffer size an interleaved memory commits in ring mode
# (one [2, n] row pair written in place) instead of rebuilding the buffer
# newest pair first: the rebuild holds the old and the new buffer at once.
# The JAX package's value, kept so that a converted state commits the same
# way; see PERF.md for the two modes' commit times on the card.
SHIFT_MAX_BYTES = 4 * 1024 ** 3


@dataclasses.dataclass
class BFGSMemoryInterleaved:
    """:class:`BFGSMemory` with the pair rows interleaved in one buffer:
    ``sy[2i] = s_i``, ``sy[2i + 1] = y_i``, so that ``sy`` is ``W`` in
    interleaved row order and the direction reads one ``[2m, n]`` buffer.

    ``shift`` (fixed at :meth:`create` by :data:`SHIFT_MAX_BYTES`, or
    forced) selects the commit: shift mode rebuilds the buffer as
    ``[new pair; sy[:-2]]`` (newest pair at rows 0-1, ``head`` always 0,
    chronology positional); ring mode writes the pair's two rows at
    ``2 * head`` in place, as the block layout does.

    ``gram``, ``c0`` and ``cg`` are in interleaved row order; the
    chronological cache (``perm``, ``rho``, the inverses, ``yy_c``,
    ``rl_c``, ``gamma``) is the block layout's.  ``s`` / ``y`` are strided
    views of ``sy``, for reading only.  Not for adaQN (a diagonal H0 reads
    the ``y`` rows apart on every step).
    """

    sy: torch.Tensor         # [2m, n]: rows [s_0, y_0, s_1, y_1, ...]
    gram: torch.Tensor       # [2m, 2m] cached W W^T, interleaved order
    s_pending: torch.Tensor  # [n]
    head: torch.Tensor       # int64 scalar
    count: torch.Tensor      # int64 scalar
    perm: torch.Tensor       # chronological cache, as in BFGSMemory
    rho: torch.Tensor
    bwd_inv: torch.Tensor
    fwd_inv: torch.Tensor
    yy_c: torch.Tensor
    rl_c: torch.Tensor
    gamma: torch.Tensor
    c0: torch.Tensor         # [2m, 2m], interleaved order
    cg: torch.Tensor         # [2m, 2m], interleaved order
    shift: bool = True       # commit mode, see the class docstring

    @classmethod
    def create(cls, mem_size: int, n: int, dtype=torch.float32,
               storage_dtype=None, shift=None, device=None
               ) -> "BFGSMemoryInterleaved":
        sy = torch.zeros((2 * mem_size, n), device=device,
                         dtype=dtype if storage_dtype is None
                         else storage_dtype)
        if shift is None:
            shift = sy.numel() * sy.element_size() <= SHIFT_MAX_BYTES
        return cls(sy=sy, shift=bool(shift),
                   **_empty_cache(mem_size, n, dtype, device))

    @property
    def mem_size(self) -> int:
        return self.sy.shape[0] // 2

    @property
    def s(self) -> torch.Tensor:
        """Storage-order ``s`` rows (a strided view of ``sy``)."""
        return self.sy[0::2]

    @property
    def y(self) -> torch.Tensor:
        return self.sy[1::2]

    def flush(self) -> "BFGSMemoryInterleaved":
        return self.replace(head=torch.zeros_like(self.head),
                            count=torch.zeros_like(self.count))

    def replace(self, **changes) -> "BFGSMemoryInterleaved":
        return dataclasses.replace(self, **changes)


def _storage(bf16: bool):
    """A memory's storage dtype: bfloat16, or (None) the iterate's."""
    return torch.bfloat16 if bf16 else None


def make_bfgs_memory(mem_size: int, n: int, dtype=torch.float32,
                     storage_dtype=None, interleaved: bool = False,
                     device=None):
    cls = BFGSMemoryInterleaved if interleaved else BFGSMemory
    return cls.create(mem_size, n, dtype, storage_dtype, device=device)


@dataclasses.dataclass
class OLBFGSState:
    """Full oLBFGS optimizer state (``workspace_oLBFGS``,
    ``include/stochqn.h:109-120``)."""

    x: torch.Tensor          # [n] current iterate
    mem: BFGSMemory          # or BFGSMemoryInterleaved
    grad_prev: torch.Tensor  # [n]
    niter: torch.Tensor      # int64 scalar
    section: torch.Tensor    # int64 scalar: resume point (0, 1, 2)

    @classmethod
    def create(cls, x0: torch.Tensor, mem_size: int,
               pairs_bf16: bool = False,
               pairs_interleaved: bool = False) -> "OLBFGSState":
        x0 = x0.detach().clone()          # owned: never the caller's buffer
        n = x0.shape[0]
        dev = x0.device
        return cls(
            x=x0,
            mem=make_bfgs_memory(mem_size, n, x0.dtype,
                                 _storage(pairs_bf16),
                                 interleaved=pairs_interleaved, device=dev),
            grad_prev=torch.zeros(n, dtype=x0.dtype, device=dev),
            niter=torch.zeros((), dtype=torch.int64, device=dev),
            section=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def replace(self, **changes) -> "OLBFGSState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class SQNState:
    """Full SQN optimizer state (``workspace_SQN``,
    ``include/stochqn.h:122-133``).

    ``x_sum`` doubles as ``x_avg`` after division, as in the reference
    (``src/stochqn.c:134``) and the JAX package.
    """

    x: torch.Tensor
    mem: BFGSMemory           # or BFGSMemoryInterleaved
    grad_prev: torch.Tensor   # [n] big-batch gradient at previous average
    x_sum: torch.Tensor       # [n] sum (or, post-division, average) of iterates
    x_avg_prev: torch.Tensor  # [n]
    niter: torch.Tensor       # int64 scalar
    section: torch.Tensor     # int64 scalar (0..4)

    @classmethod
    def create(cls, x0: torch.Tensor, mem_size: int,
               pairs_bf16: bool = False,
               pairs_interleaved: bool = False) -> "SQNState":
        x0 = x0.detach().clone()          # owned: never the caller's buffer
        n = x0.shape[0]
        dev = x0.device

        def zeros_n():
            return torch.zeros(n, dtype=x0.dtype, device=dev)

        return cls(
            x=x0,
            mem=make_bfgs_memory(mem_size, n, x0.dtype,
                                 _storage(pairs_bf16),
                                 interleaved=pairs_interleaved, device=dev),
            grad_prev=zeros_n(),
            x_sum=zeros_n(),
            x_avg_prev=zeros_n(),
            niter=torch.zeros((), dtype=torch.int64, device=dev),
            section=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def replace(self, **changes) -> "SQNState":
        return dataclasses.replace(self, **changes)


# Above this Fisher-buffer size the per-step append writes one ring row in
# place; at or below it the append rewrites the buffer newest row first
# (the JAX package's gate, kept so that a converted state matches row for
# row; its break-even was measured on the TPU and is not re-measured here).
FISHER_SHIFT_MAX_BYTES = 8 * 1024 ** 2


@dataclasses.dataclass
class FisherMemory:
    """Ring buffer of recent minibatch gradients for adaQN's empirical
    Fisher (``fisher_mem``, ``include/stochqn.h:101-107``).

    Rows are only consumed through ``F^T (F s) / count``
    (:func:`stochqn_tpu_torch.ops.pairs.fisher_y`), so their order does
    not matter, only occupancy.  ``shift`` (fixed at :meth:`create` by
    :data:`FISHER_SHIFT_MAX_BYTES`) selects the append: a small buffer is
    rebuilt as ``[g; f[:-1]]`` (newest row first), a large one has the
    row at ``head`` overwritten in place.  Both keep the valid rows at
    ``[0, count)`` while filling, as in the JAX package.
    """

    f: torch.Tensor       # [fisher_size, n]
    head: torch.Tensor    # int64 scalar: next ring slot
    count: torch.Tensor   # int64 scalar: number of valid rows
    shift: bool = False   # append mode, see the class docstring

    @classmethod
    def create(cls, fisher_size: int, n: int, dtype=torch.float32,
               storage_dtype=None, shift=None, device=None
               ) -> "FisherMemory":
        f = torch.zeros((fisher_size, n),
                        dtype=dtype if storage_dtype is None
                        else storage_dtype, device=device)
        if shift is None:
            shift = f.numel() * f.element_size() <= FISHER_SHIFT_MAX_BYTES
        return cls(f=f,
                   head=torch.zeros((), dtype=torch.int64, device=device),
                   count=torch.zeros((), dtype=torch.int64, device=device),
                   shift=bool(shift))

    def flush(self) -> "FisherMemory":
        return self.replace(head=torch.zeros_like(self.head),
                            count=torch.zeros_like(self.count))

    def append(self, grad: torch.Tensor) -> "FisherMemory":
        """``add_to_fisher_mem`` (``src/stochqn.c:581-587``).

        Ring mode writes ``self.f`` in place (``index_copy_`` at ``head``:
        a 0-d CUDA index would be read on the host), so ``self`` is
        consumed; shift mode builds a new buffer."""
        size = self.f.shape[0]
        row = grad.to(self.f.dtype)[None]
        if self.shift:
            f = torch.cat([row, self.f[:-1]], dim=0)
        else:
            f = self.f.index_copy_(0, self.head.reshape(1), row)
        return self.replace(
            f=f,
            head=torch.remainder(self.head + 1, size),  # also kept in shift
            count=torch.clamp(self.count + 1, max=size))

    def append_block(self, grads: torch.Tensor) -> "FisherMemory":
        """Append ``grads [k, n]`` in order: the same memory as ``k``
        successive :meth:`append` calls, in one write (one rebuild in
        shift mode).  Only the last ``fisher_size`` rows can survive, so
        only those are written.  Ring mode writes ``self.f`` in place, as
        :meth:`append` does, so ``self`` is consumed.  The fused engine
        appends one row per step and does not call it."""
        size = self.f.shape[0]
        k = grads.shape[0]
        keep = min(k, size)
        rows = grads[k - keep:].to(self.f.dtype)
        if self.shift:
            f = torch.cat([rows.flip(0), self.f[:size - keep]], dim=0)
        else:
            slots = torch.remainder(
                self.head + (k - keep)
                + torch.arange(keep, dtype=torch.int64, device=rows.device),
                size)
            f = self.f.index_copy_(0, slots, rows)
        return self.replace(
            f=f,
            head=torch.remainder(self.head + k, size),
            count=torch.clamp(self.count + k, max=size))

    def replace(self, **changes) -> "FisherMemory":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class AdaQNState:
    """Full adaQN optimizer state (``workspace_adaQN``,
    ``include/stochqn.h:135-151``)."""

    x: torch.Tensor
    mem: BFGSMemory
    fisher: FisherMemory      # one row when use_grad_diff (never appended)
    grad_prev: torch.Tensor   # [n] (used only when use_grad_diff)
    x_sum: torch.Tensor
    x_avg_prev: torch.Tensor
    grad_sum_sq: torch.Tensor  # [n] AdaGrad / RMSProp accumulator
    f_prev: torch.Tensor       # scalar: accepted function value
    niter: torch.Tensor        # int64 scalar
    section: torch.Tensor      # int64 scalar (0..5)

    @classmethod
    def create(cls, x0: torch.Tensor, mem_size: int, fisher_size: int,
               pairs_bf16: bool = False,
               fisher_bf16: bool = False) -> "AdaQNState":
        x0 = x0.detach().clone()          # owned: never the caller's buffer
        n = x0.shape[0]
        dev = x0.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=x0.dtype, device=dev)

        return cls(
            x=x0,
            mem=BFGSMemory.create(mem_size, n, x0.dtype,
                                  _storage(pairs_bf16), device=dev),
            fisher=FisherMemory.create(max(fisher_size, 1), n, x0.dtype,
                                       _storage(fisher_bf16), device=dev),
            grad_prev=zeros(n),
            x_sum=zeros(n),
            x_avg_prev=zeros(n),
            grad_sum_sq=zeros(n),
            f_prev=zeros(),
            niter=torch.zeros((), dtype=torch.int64, device=dev),
            section=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def replace(self, **changes) -> "AdaQNState":
        return dataclasses.replace(self, **changes)
