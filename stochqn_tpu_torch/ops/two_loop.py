"""L-BFGS two-loop recursion from the commit-time cache (block layout).

Counterpart of :mod:`stochqn_tpu.ops.two_loop`.  Two branches of
:func:`two_loop_cached` are ported:

* SQN's collapsed scalar-H0 form: with the cache of
  :func:`stochqn_tpu_torch.ops.pairs.commit_pair` (``direction_cache=True``)
  the whole gamma-scaled two-loop is

      d = gamma*g + W^T ((c0 + gamma*cg) @ (W g)),   W = [s; y]  ([2m, n])

  computed by the hand-written direction kernel whenever the tensors are
  on CUDA;
* adaQN's diagonal-H0 form, with the ``matvec`` or ``gram`` coupling in
  plain torch, or (``use_pallas=True``) with ``W g``, ``(Y*D) g`` and
  ``(Y*D) Y^T`` from the hand-written projection kernel.

The kernels are in :mod:`stochqn_tpu_torch.ops.kernels.two_loop_kernel`;
the selects around them are plain torch and stay on the device.  The
scalar-H0 uncollapsed branch and the interleaved layout raise
``NotImplementedError`` naming the ROADMAP slice that brings them.
"""
from __future__ import annotations

from typing import Optional

import torch

from stochqn_tpu_torch.ops.kernels.two_loop_kernel import (direction_streamed,
                                                          project_adaqn)


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


def _to_storage_order(v: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``zeros.at[perm].set(v)``: chronological values to storage rows."""
    return torch.zeros_like(v).index_copy_(0, perm, v)


def two_loop_cached(grad: torch.Tensor, mem, *, h0: float = 0.0,
                    diag: Optional[torch.Tensor] = None,
                    use_pallas: Optional[bool] = None,
                    collapsed: bool = False,
                    coupling: str = "matvec") -> torch.Tensor:
    """Approximate ``H^{-1} grad`` from the commit-time cache in ``mem``.

    Scalar H0 (``diag=None``), ``collapsed=True``: the fused SQN engine's
    per-step direction.  ``h0 > 0`` overrides the cached ``gamma``; with
    no stored pairs the result is ``grad`` itself
    (``src/stochqn.c:808-812``), which also masks the stale collapsed cache
    after a flush.

    Diagonal H0 (``diag [n]``, adaQN; ``collapsed`` is ignored, as in the
    JAX package): project ``W g``, three m-sized solves, expand.  The
    coupling term ``YD g - YD Y^T alpha`` is

    * ``coupling="matvec"``: ``Y @ (D (g - Y^T alpha))``, two matvecs;
    * ``coupling="gram"``: ``(Y*D) g - ((Y*D) Y^T) alpha``;
    * ``use_pallas=True`` with float32 ``grad`` and float32 pair storage
      (decided before any launch): ``W g``, ``(Y*D) g`` and ``(Y*D) Y^T``
      come from :func:`project_adaqn` (the CUDA kernel for CUDA tensors,
      its plain version for CPU ones), whatever ``coupling`` says.

    With no stored pairs the result is ``diag * grad``.
    """
    if coupling not in ("matvec", "gram"):
        raise ValueError(f"coupling must be 'matvec' or 'gram', "
                         f"got {coupling!r}")
    if hasattr(mem, "sy"):
        if diag is not None:
            raise ValueError(
                "pairs_interleaved does not support a diagonal H0 (adaQN)")
        raise NotImplementedError(
            "the interleaved pair layout is not ported yet "
            "(ROADMAP A.11, slice 3)")
    dtype = grad.dtype
    acc_t = mem.bwd_inv.dtype
    has_pairs = mem.count > 0
    g_acc = grad.to(acc_t)

    if diag is None:
        if not collapsed:
            raise NotImplementedError(
                "the scalar-H0 uncollapsed cached two-loop is not ported "
                "yet; it comes with oLBFGS (ROADMAP A.11, slice 3)")
        gamma = (torch.full((), h0, dtype=acc_t, device=grad.device)
                 if h0 > 0 else mem.gamma)
        gamma = torch.where(has_pairs, gamma, torch.ones_like(gamma))
        c = mem.c0 + gamma * mem.cg
        d = direction_streamed(mem.s, mem.y, g_acc, c, gamma)
        return torch.where(has_pairs, d, g_acc).to(dtype)

    s_mem, y_mem = mem.s, mem.y
    m = s_mem.shape[0]
    perm = mem.perm
    diag_acc = diag.to(acc_t)
    ydg_st = ydy_st = None
    if (use_pallas and dtype == torch.float32
            and s_mem.dtype == torch.float32):
        wg, ydg_st, ydy_st = project_adaqn(s_mem, y_mem, diag, grad)
    else:
        wg = _mem_mm(torch.cat([s_mem, y_mem], dim=0), grad, acc_t)
        if coupling == "gram":
            yd = y_mem.to(acc_t) * diag_acc[None, :]
            ydg_st = _mem_mm(yd, grad, acc_t)
            ydy_st = _mem_mm(yd, y_mem.T, acc_t)
    wg = wg.to(acc_t)
    alpha = mem.bwd_inv @ (mem.rho * wg[:m][perm])

    # u2 = D (g - Y^T alpha): the direction's diagonal term, and in the
    # matvec coupling also YD g - YD Y^T alpha = Y @ u2 (no [m, n] Y*D and
    # no [m, m] weighted Gram).
    st_alpha_y = _mem_mm(_to_storage_order(alpha, perm), y_mem, acc_t)
    u2 = diag_acc * (g_acc - st_alpha_y)
    if ydg_st is None:
        y_r0 = _mem_mm(y_mem, u2, acc_t)[perm]
    else:
        ydg = ydg_st.to(acc_t)[perm]
        ydy = ydy_st.to(acc_t)[perm][:, perm]
        y_r0 = ydg - ydy @ alpha

    rhs = mem.rho * y_r0 + mem.rl_c @ alpha
    beta = mem.fwd_inv @ rhs
    st_coeff_s = _mem_mm(_to_storage_order(alpha - beta, perm), s_mem,
                         acc_t)
    d = u2 + st_coeff_s
    return torch.where(has_pairs, d, diag_acc * g_acc).to(dtype)
