"""Correction-pair validity checks and ring-buffer commits (block layout).

Counterpart of :mod:`stochqn_tpu.ops.pairs`: ``take_step``'s NaN/magnitude
guard (``src/stochqn.c:825-835``), ``check_min_curvature``
(``src/stochqn.c:883-900``) and the commit with its incremental Gram and
small-math cache.  Everything stays on the device: accept/reject is a
tensor, selected with ``torch.where``, never read on the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from stochqn_tpu_torch.core.state import BFGSMemory
from stochqn_tpu_torch.ops.two_loop import _chrono_perm, _mem_mm


def _gram_cols(buf: torch.Tensor, row_s: torch.Tensor, row_y: torch.Tensor,
               acc_t: torch.dtype) -> torch.Tensor:
    """``buf @ [row_s; row_y]^T`` as two matvecs stacked into ``[2m, 2]``."""
    return torch.stack([_mem_mm(buf, row_s, acc_t),
                        _mem_mm(buf, row_y, acc_t)], dim=1)


def direction_is_bad(direction: torch.Tensor) -> torch.Tensor:
    """Reference guard: non-finite direction, or ``||d||_2 > 1e3 * n``
    (``src/stochqn.c:827-829``), as one reduction: a NaN/Inf entry makes
    the norm NaN/Inf, and both fail ``norm <= threshold``."""
    n = direction.shape[0]
    acc_t = torch.promote_types(direction.dtype, torch.float32)
    norm = torch.linalg.vector_norm(direction.to(acc_t))
    return torch.logical_not(norm <= 1e3 * n)


def conditional_flush(mem: BFGSMemory, pred: torch.Tensor) -> BFGSMemory:
    """Flush the ring iff ``pred``, touching only the scalar indices
    (``src/stochqn.c:554-558``)."""
    zero = torch.zeros_like(mem.head)
    return mem.replace(head=torch.where(pred, zero, mem.head),
                       count=torch.where(pred, zero, mem.count))


def commit_pair(mem: BFGSMemory, y_cand: torch.Tensor, min_curvature: float,
                y_reg: float, enabled: Optional[torch.Tensor] = None,
                direction_cache: bool = False
                ) -> Tuple[BFGSMemory, torch.Tensor]:
    """Try to commit ``(mem.s_pending, y_cand [+ y_reg * s])`` into the ring.

    Accept iff ``s.y / s.s > min_curvature`` (always when
    ``min_curvature <= 0``); a 0/0 ratio is NaN and rejects.  ``enabled``
    (bool tensor) vetoes the commit.  Returns ``(new_mem, accepted)``.

    In place: the row at ``head`` of ``mem.s`` / ``mem.y`` is rewritten
    with ``index_copy_`` — with the candidate on accept, with its own
    contents on reject (the JAX package's copy-free reject,
    ``pairs.py:94-96``).  ``new_mem`` shares those buffers, so ``mem`` is
    consumed: read only ``new_mem`` afterwards.
    """
    s = mem.s_pending
    if y_reg > 0:
        y_cand = y_cand + y_reg * s

    if min_curvature > 0:
        acc_t = torch.promote_types(s.dtype, torch.float32)
        s_acc, y_acc = s.to(acc_t), y_cand.to(acc_t)
        curv = torch.dot(s_acc, y_acc) / torch.dot(s_acc, s_acc)
        accepted = curv > min_curvature
    else:
        accepted = torch.ones((), dtype=torch.bool, device=s.device)
    if enabled is not None:
        accepted = accepted & enabled

    size = mem.mem_size
    gram_t = mem.gram.dtype
    st_t = mem.s.dtype
    head = mem.head.reshape(1)
    row_s = torch.where(accepted, s.to(st_t), mem.s.index_select(0, head)[0])
    row_y = torch.where(accepted, y_cand.to(st_t),
                        mem.y.index_select(0, head)[0])
    mem.s.index_copy_(0, head, row_s[None])
    mem.y.index_copy_(0, head, row_y[None])

    # Incremental Gram: the row and column of W W^T touched by the written
    # pair (on reject, the same entries recomputed).  Columns first, then
    # rows, as in the JAX package.
    p = _gram_cols(torch.cat([mem.s, mem.y], dim=0), row_s, row_y,
                   gram_t).to(gram_t)                           # [2m, 2]
    idx = torch.cat([head, head + size])
    gram = mem.gram.clone()
    gram.index_copy_(1, idx, p)
    gram.index_copy_(0, idx, p.T.contiguous())

    new_head = torch.where(accepted, torch.remainder(mem.head + 1, size),
                           mem.head)
    new_count = torch.where(accepted, torch.clamp(mem.count + 1, max=size),
                            mem.count)
    cache = _small_cache(gram, new_head, new_count, size,
                         direction_cache=direction_cache)
    return mem.replace(gram=gram, head=new_head, count=new_count,
                       **cache), accepted


def _small_cache(gram: torch.Tensor, head: torch.Tensor, count: torch.Tensor,
                 mem_size: int, direction_cache: bool = False) -> dict:
    """Commit-time precomputation of the gradient-independent two-loop
    math (block order): chronological permutation, rho, the inverted
    backward/forward triangular systems, chronological ``Y Y^T``, the
    forward coupling, default gamma and, with ``direction_cache``, the
    collapsed ``c0``/``cg``.
    """
    m = mem_size
    acc_t = gram.dtype
    dev = gram.device
    cidx = torch.arange(m, dtype=torch.int64, device=dev)
    perm = _chrono_perm(m, head, count)
    valid = cidx < count
    validf = valid.to(acc_t)

    sy = gram[:m, m:][perm][:, perm]
    yy = gram[m:, m:][perm][:, perm]
    sy_diag = torch.diagonal(sy)
    rho = validf / torch.where(valid, sy_diag, torch.ones_like(sy_diag))

    eye = torch.eye(m, dtype=acc_t, device=dev)
    ru = torch.triu(rho[:, None] * sy, diagonal=1)
    rl = torch.tril(rho[:, None] * sy.T, diagonal=-1)
    # (I + N)^{-1} for strictly-triangular (nilpotent) N via the log-depth
    # Neumann factorization (I - N)(I + N^2)(I + N^4)..., exact once the
    # exponents cover m; both systems ride one batched [2, m, m] chain.
    n_stack = torch.stack([ru, rl])
    inv = eye - n_stack
    sq, k = n_stack, 2
    while k < m:
        sq = torch.matmul(sq, sq)
        inv = torch.matmul(inv, eye + sq)
        k *= 2
    bwd_inv, fwd_inv = inv[0], inv[1]

    has_pairs = count > 0
    # index_select, not [last]: indexing with a 0-d CUDA tensor reads it
    # on the host (a sync per commit)
    last = torch.clamp(count - 1, min=0).reshape(1)
    yy_last = torch.diagonal(yy).index_select(0, last)[0]
    gamma = torch.where(
        has_pairs,
        sy_diag.index_select(0, last)[0] / torch.where(
            has_pairs, yy_last, torch.ones_like(yy_last)),
        torch.ones((), dtype=acc_t, device=dev))

    yy_m = yy * validf[:, None] * validf[None, :]
    out = dict(perm=perm, rho=rho, bwd_inv=bwd_inv, fwd_inv=fwd_inv,
               yy_c=yy_m, rl_c=rl, gamma=gamma)

    if not direction_cache:
        out["c0"] = torch.zeros((2 * m, 2 * m), dtype=acc_t, device=dev)
        out["cg"] = torch.zeros((2 * m, 2 * m), dtype=acc_t, device=dev)
        return out

    # Collapse the gamma-scaled two-loop into u = C @ (W g) with
    # C = c0 + gamma * cg (the derivation is in the JAX package,
    # ops/pairs.py:300-309).
    p_mat = torch.nn.functional.one_hot(perm, m).to(acc_t)  # (P x)_i = x[perm_i]
    drho_p = rho[:, None] * p_mat
    a1 = bwd_inv @ drho_p
    finv_rl_a1 = fwd_inv @ (rl @ a1)
    c0_ss = p_mat.T @ (a1 - finv_rl_a1)
    cg_ss = p_mat.T @ (fwd_inv @ (rho[:, None] * (yy_m @ a1)))
    cg_sy = -(p_mat.T @ (fwd_inv @ drho_p))
    cg_ys = -(p_mat.T @ a1)

    zero_m = torch.zeros((m, m), dtype=acc_t, device=dev)
    out["c0"] = torch.cat([torch.cat([c0_ss, zero_m], dim=1),
                           torch.cat([zero_m, zero_m], dim=1)], dim=0)
    out["cg"] = torch.cat([torch.cat([cg_ss, cg_sy], dim=1),
                           torch.cat([cg_ys, zero_m], dim=1)], dim=0)
    return out
