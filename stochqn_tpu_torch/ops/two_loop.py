"""L-BFGS two-loop recursion: the collapsed cached form.

Counterpart of :mod:`stochqn_tpu.ops.two_loop`.  With the commit-time cache
of :func:`stochqn_tpu_torch.ops.pairs.commit_pair` (``direction_cache=True``)
the whole gamma-scaled two-loop is

    d = gamma*g + W^T ((c0 + gamma*cg) @ (W g)),   W = [s; y]  ([2m, n])

which :func:`two_loop_cached` computes with the hand-written direction
kernel (:mod:`stochqn_tpu_torch.ops.kernels.two_loop_kernel`) whenever the
tensors are on CUDA.  The ``gamma`` / ``count == 0`` selects around the
kernel are plain torch and stay on the device.

Only the collapsed block-layout branch is ported; the others raise
``NotImplementedError`` naming the ROADMAP slice that brings them.
"""
from __future__ import annotations

from typing import Optional

import torch

from stochqn_tpu_torch.ops.kernels.two_loop_kernel import direction_streamed


def _mem_mm(a: torch.Tensor, b: torch.Tensor,
            acc_t: torch.dtype) -> torch.Tensor:
    """Streaming matmul against the pair memory, storage-aware.

    float32 storage: a plain float32 matmul (full float32 unless the
    caller enabled TF32, which the JAX package's ``Precision.HIGHEST``
    rules out).  bfloat16 storage: upcast inside, accumulate in ``acc_t``
    — the JAX package's bfloat16 branch.
    """
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return torch.matmul(a.to(acc_t), b.to(acc_t))
    return torch.matmul(a, b).to(acc_t)


def _chrono_perm(mem_size: int, head: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """Storage row of the c-th oldest pair, for c = 0..mem_size-1.

    ``torch.remainder`` (not ``fmod``): ``head - count`` may be negative,
    and the row must land in ``[0, mem_size)`` like ``jnp.mod``.
    """
    start = torch.remainder(head - count, mem_size)
    return torch.remainder(
        start + torch.arange(mem_size, dtype=torch.int64, device=head.device),
        mem_size)


def two_loop_cached(grad: torch.Tensor, mem, *, h0: float = 0.0,
                    diag: Optional[torch.Tensor] = None,
                    collapsed: bool = False) -> torch.Tensor:
    """Approximate ``H^{-1} grad`` from the commit-time cache in ``mem``.

    Ported branch: ``collapsed=True`` with a scalar H0 (``diag=None``) on
    the block layout — the fused SQN engine's per-step direction.  ``h0 >
    0`` overrides the cached ``gamma``; with no stored pairs the result is
    ``grad`` itself (``src/stochqn.c:808-812``), which also masks the
    stale collapsed cache after a flush.
    """
    if diag is not None:
        raise NotImplementedError(
            "the diagonal-H0 (adaQN) two-loop is not ported yet "
            "(ROADMAP A.12, slice 4)")
    if hasattr(mem, "sy"):
        raise NotImplementedError(
            "the interleaved pair layout is not ported yet "
            "(ROADMAP A.11, slice 3)")
    if not collapsed:
        raise NotImplementedError(
            "only two_loop_cached(collapsed=True) is ported; the "
            "uncollapsed cached two-loop comes with oLBFGS "
            "(ROADMAP A.11, slice 3)")
    dtype = grad.dtype
    acc_t = mem.bwd_inv.dtype
    has_pairs = mem.count > 0
    gamma = (torch.full((), h0, dtype=acc_t, device=grad.device) if h0 > 0
             else mem.gamma)
    gamma = torch.where(has_pairs, gamma, torch.ones_like(gamma))
    c = mem.c0 + gamma * mem.cg
    g_acc = grad.to(acc_t)
    d = direction_streamed(mem.s, mem.y, g_acc, c, gamma)
    return torch.where(has_pairs, d, g_acc).to(dtype)
