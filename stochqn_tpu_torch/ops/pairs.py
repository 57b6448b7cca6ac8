"""Correction-pair validity checks and pair-memory commits.

Counterpart of :mod:`stochqn_tpu.ops.pairs`: ``take_step``'s NaN/magnitude
guard (``src/stochqn.c:825-835``), ``check_min_curvature``
(``src/stochqn.c:883-900``), the commit with its incremental Gram and
small-math cache, and adaQN's empirical-Fisher ``y``.  Everything stays on
the device: accept/reject is a tensor, selected with ``torch.where``,
never read on the host.

Two row orders of ``W`` are in play, chosen by the memory's class: block
order ``[s_0 .. s_{m-1}, y_0 .. y_{m-1}]`` (:class:`BFGSMemory`) and
interleaved order ``[s_0, y_0, s_1, y_1, ...]``
(:class:`BFGSMemoryInterleaved`).  ``gram``, ``c0`` and ``cg`` follow the
memory's order; strided slices convert between the two.

``comm`` (a :class:`stochqn_tpu_torch.parallel.mesh.MeshComm`, or None):
on a sharded param axis the vectors and rows are this rank's column
slices, and each function sums its n-contractions in one all-reduce
(:func:`_commit_sharded` for the commit); with no mesh, or one rank on the
param axis, nothing here changes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from stochqn_tpu_torch.core.protocol import cast_scalar
from stochqn_tpu_torch.core.state import (BFGSMemory, BFGSMemoryInterleaved,
                                          FisherMemory)
from stochqn_tpu_torch.ops.two_loop import (_chrono_perm, _mem_mm, _psum,
                                            _sharded)


# The most bytes of a pair buffer upcast at once by :func:`_gram_cols`: a
# larger bfloat16 buffer is taken in chunks of columns, so that no float32
# copy of all of it is made (at n = 5e8 and m = 10 that copy is 43 GB).
UPCAST_CHUNK_BYTES = 1 << 30


def _gram_cols(buf: torch.Tensor, row_s: torch.Tensor, row_y: torch.Tensor,
               acc_t: torch.dtype) -> torch.Tensor:
    """``buf @ [row_s; row_y]^T`` as two matvecs stacked into ``[2m, 2]``;
    a buffer whose upcast takes more than :data:`UPCAST_CHUNK_BYTES` is
    upcast and multiplied a chunk of columns at a time, the chunks'
    products summed in ``acc_t``."""
    rows, n = buf.shape
    width = torch.finfo(acc_t).bits // 8
    step = max(1, UPCAST_CHUNK_BYTES // (rows * width))
    if buf.dtype == acc_t or n <= step:
        return torch.stack([_mem_mm(buf, row_s, acc_t),
                            _mem_mm(buf, row_y, acc_t)], dim=1)
    out = None
    for c in range(0, n, step):
        part = buf[:, c:c + step].to(acc_t)
        cols = torch.stack([part @ row_s[c:c + step].to(acc_t),
                            part @ row_y[c:c + step].to(acc_t)], dim=1)
        out = cols if out is None else out + cols
    return out


def direction_is_bad(direction: torch.Tensor, comm=None) -> torch.Tensor:
    """Reference guard: non-finite direction, or ``||d||_2 > 1e3 * n``
    (``src/stochqn.c:827-829``), as one reduction: a NaN/Inf entry makes
    the norm NaN/Inf, and both fail ``norm <= threshold``.  On a sharded
    param axis the squares are summed over the ranks and ``n`` is the
    global parameter count, not the slice's."""
    n = direction.shape[0]
    acc_t = torch.promote_types(direction.dtype, torch.float32)
    if _sharded(comm):
        d = direction.to(acc_t)
        (sq,) = _psum(comm, torch.dot(d, d).reshape(1), label="guard")
        return torch.logical_not(torch.sqrt(sq[0]) <= 1e3 * n * comm.n_param)
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
                direction_cache: bool = False, comm=None
                ) -> Tuple[BFGSMemory, torch.Tensor]:
    """Try to commit ``(mem.s_pending, y_cand [+ y_reg * s])`` into the
    memory (either layout).

    Accept iff ``s.y / s.s > min_curvature`` (always when
    ``min_curvature <= 0``); a 0/0 ratio is NaN and rejects.  ``enabled``
    (bool tensor) vetoes the commit.  Returns ``(new_mem, accepted)``.

    Block layout and interleaved ring mode write in place: the pair's rows
    at ``head`` are rewritten with ``index_copy_``, with the candidate on
    accept and with their own contents on reject (the JAX package's
    copy-free reject, ``pairs.py:94-96``).  ``new_mem`` shares those
    buffers, so ``mem`` is consumed: read only ``new_mem`` afterwards.
    Interleaved shift mode builds a new buffer ``[new pair; sy[:-2]]``,
    selected on the device by ``accepted``, and leaves ``head`` at 0.

    On a sharded param axis (``comm``) the commit is
    :func:`_commit_sharded`: the same accept test and the same memory,
    with every n-contraction in one all-reduce.
    """
    s = mem.s_pending
    if y_reg > 0:
        y_cand = y_cand + cast_scalar(y_reg, y_cand.dtype) * s
    if _sharded(comm):
        return _commit_sharded(mem, s, y_cand, min_curvature, enabled,
                               direction_cache, comm)

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
    interleaved = isinstance(mem, BFGSMemoryInterleaved)
    shift = interleaved and mem.shift
    if shift:
        st_t = mem.sy.dtype
        slab = torch.stack([s.to(st_t), y_cand.to(st_t)])
        new_sy = torch.where(accepted, torch.cat([slab, mem.sy[:-2]]), mem.sy)
        # the Gram moves down-right with the rows; the new pair's row and
        # column come from one pass over the new buffer
        p = _gram_cols(new_sy, slab[0], slab[1], gram_t).to(gram_t)  # [2m, 2]
        g_shift = torch.zeros_like(mem.gram)
        g_shift[2:, 2:] = mem.gram[:-2, :-2]
        g_shift[:, 0:2] = p
        g_shift[0:2, :] = p.T
        gram = torch.where(accepted, g_shift, mem.gram)
        buffers = dict(sy=new_sy)
        new_head = mem.head
    else:
        if interleaved:            # ring mode: rows 2 head, 2 head + 1
            idx = 2 * mem.head + torch.arange(2, device=mem.head.device)
            cur_s, cur_y = mem.sy.index_select(0, idx)
        else:
            head = mem.head.reshape(1)
            idx = torch.cat([head, head + size])
            cur_s = mem.s.index_select(0, head)[0]
            cur_y = mem.y.index_select(0, head)[0]
        row_s = torch.where(accepted, s.to(cur_s.dtype), cur_s)
        row_y = torch.where(accepted, y_cand.to(cur_y.dtype), cur_y)
        if interleaved:
            w = mem.sy.index_copy_(0, idx, torch.stack([row_s, row_y]))
        else:
            mem.s.index_copy_(0, head, row_s[None])
            mem.y.index_copy_(0, head, row_y[None])
            w = torch.cat([mem.s, mem.y], dim=0)
        buffers = {}
        # Incremental Gram: the rows and columns of W W^T touched by the
        # written pair (on reject, the same entries recomputed).  Columns
        # first, then rows, as in the JAX package.
        p = _gram_cols(w, row_s, row_y, gram_t).to(gram_t)         # [2m, 2]
        gram = mem.gram.clone()
        gram.index_copy_(1, idx, p)
        gram.index_copy_(0, idx, p.T.contiguous())
        new_head = torch.where(accepted, torch.remainder(mem.head + 1, size),
                               mem.head)

    new_count = torch.where(accepted, torch.clamp(mem.count + 1, max=size),
                            mem.count)
    cache = _small_cache(gram, new_head, new_count, size,
                         direction_cache=direction_cache,
                         interleaved=interleaved, shift=shift)
    return mem.replace(gram=gram, head=new_head, count=new_count,
                       **buffers, **cache), accepted


def _commit_sharded(mem, s: torch.Tensor, y_cand: torch.Tensor,
                    min_curvature: float, enabled, direction_cache: bool,
                    comm) -> Tuple[BFGSMemory, torch.Tensor]:
    """:func:`commit_pair` on a sharded param axis, with one all-reduce.

    Unsharded, the accept test (``s.y``, ``s.s``) comes first and the Gram
    pass runs over the rows as written after it: two dependent sums.
    Here every n-contraction is taken before the test, on this rank's
    columns: the test's two dots, the current rows against the candidate
    (``W [s; y]^T``, ``[2m, 2]``) and the candidate's own block (``s.s``,
    ``s.y``, ``y.y`` of the rows as stored).  On accept the Gram's new
    rows and columns are the current rows' products with the entries of
    the written slots replaced by the candidate's block; on reject the
    Gram is kept (the unsharded commit recomputes the same entries).
    """
    size = mem.mem_size
    gram_t = mem.gram.dtype
    interleaved = isinstance(mem, BFGSMemoryInterleaved)
    shift = interleaved and mem.shift
    w = mem.sy if interleaved else torch.cat([mem.s, mem.y], dim=0)
    st_t = w.dtype
    row_s, row_y = s.to(st_t), y_cand.to(st_t)        # the rows as stored
    rs, ry = row_s.to(gram_t), row_y.to(gram_t)
    s_acc, y_acc = s.to(gram_t), y_cand.to(gram_t)
    local = torch.stack([torch.dot(s_acc, y_acc), torch.dot(s_acc, s_acc),
                         torch.dot(rs, rs), torch.dot(rs, ry),
                         torch.dot(ry, ry)])
    cols, local = _psum(comm, _gram_cols(w, row_s, row_y, gram_t)
                        .to(gram_t), local, label="commit")
    sy_, ss_, b_ss, b_sy, b_yy = local.unbind(0)
    if min_curvature > 0:
        accepted = sy_ / ss_ > min_curvature
    else:
        accepted = torch.ones((), dtype=torch.bool, device=s.device)
    if enabled is not None:
        accepted = accepted & enabled
    block = torch.stack([torch.stack([b_ss, b_sy]),
                         torch.stack([b_sy, b_yy])])        # [2, 2]

    if shift:
        new_sy = torch.where(accepted, torch.cat([torch.stack([row_s, row_y]),
                                                  mem.sy[:-2]]), mem.sy)
        p = torch.cat([block, cols[:-2]])                   # [2m, 2]
        g_new = torch.zeros_like(mem.gram)
        g_new[2:, 2:] = mem.gram[:-2, :-2]
        g_new[:, 0:2] = p
        g_new[0:2, :] = p.T
        buffers = dict(sy=new_sy)
        new_head = mem.head
    else:
        if interleaved:            # ring mode: rows 2 head, 2 head + 1
            idx = 2 * mem.head + torch.arange(2, device=mem.head.device)
            cur_s, cur_y = mem.sy.index_select(0, idx)
        else:
            head = mem.head.reshape(1)
            idx = torch.cat([head, head + size])
            cur_s = mem.s.index_select(0, head)[0]
            cur_y = mem.y.index_select(0, head)[0]
        new_rows = torch.stack([torch.where(accepted, row_s, cur_s),
                                torch.where(accepted, row_y, cur_y)])
        if interleaved:
            mem.sy.index_copy_(0, idx, new_rows)
        else:
            mem.s.index_copy_(0, head, new_rows[:1])
            mem.y.index_copy_(0, head, new_rows[1:])
        p = cols.index_copy(0, idx, block)                  # [2m, 2]
        g_new = mem.gram.clone()
        g_new.index_copy_(1, idx, p)
        g_new.index_copy_(0, idx, p.T.contiguous())
        buffers = {}
        new_head = torch.where(accepted, torch.remainder(mem.head + 1, size),
                               mem.head)
    gram = torch.where(accepted, g_new, mem.gram)
    new_count = torch.where(accepted, torch.clamp(mem.count + 1, max=size),
                            mem.count)
    cache = _small_cache(gram, new_head, new_count, size,
                         direction_cache=direction_cache,
                         interleaved=interleaved, shift=shift)
    return mem.replace(gram=gram, head=new_head, count=new_count,
                       **buffers, **cache), accepted


def _small_cache(gram: torch.Tensor, head: torch.Tensor, count: torch.Tensor,
                 mem_size: int, direction_cache: bool = False,
                 interleaved: bool = False, shift: bool = False) -> dict:
    """Commit-time precomputation of the gradient-independent two-loop
    math: chronological permutation, rho, the inverted backward/forward
    triangular systems, chronological ``Y Y^T``, the forward coupling,
    default gamma and, with ``direction_cache``, the collapsed
    ``c0``/``cg``.  ``gram`` and the returned ``c0``/``cg`` are in
    interleaved row order where ``interleaved``; the chronological outputs
    are the same in both layouts.  ``shift``: the newest pair is storage
    slot 0.
    """
    m = mem_size
    acc_t = gram.dtype
    dev = gram.device
    cidx = torch.arange(m, dtype=torch.int64, device=dev)
    if shift:
        # the c-th oldest of `count` live pairs sits at slot count-1-c
        # (invalid c land on in-range slots, masked through rho)
        perm = torch.remainder(count - 1 - cidx, m)
    else:
        perm = _chrono_perm(m, head, count)
    valid = cidx < count
    validf = valid.to(acc_t)

    if interleaved:
        sy = gram[0::2, 1::2][perm][:, perm]
        yy = gram[1::2, 1::2][perm][:, perm]
    else:
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

    zero_2m = torch.zeros((2 * m, 2 * m), dtype=acc_t, device=dev)
    if not direction_cache:
        out["c0"], out["cg"] = zero_2m, zero_2m.clone()
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

    # the s rows of W are [0, m) in block order, the even rows interleaved
    s_rows = slice(0, 2 * m, 2) if interleaved else slice(0, m)
    y_rows = slice(1, 2 * m, 2) if interleaved else slice(m, 2 * m)
    c0, cg = zero_2m, zero_2m.clone()
    c0[s_rows, s_rows] = c0_ss
    cg[s_rows, s_rows] = cg_ss
    cg[s_rows, y_rows] = cg_sy
    cg[y_rows, s_rows] = cg_ys
    out["c0"], out["cg"] = c0, cg
    return out


def fisher_y(fisher: FisherMemory, s: torch.Tensor,
             comm=None) -> torch.Tensor:
    """Empirical-Fisher y vector: ``y = F^T (F s) / count``
    (``update_y_fisher``, ``src/stochqn.c:936-952``).  Rows at or past
    ``count`` are masked out, so stale rows after a flush do not count.
    On a sharded param axis ``F s`` is summed over the ranks (one
    all-reduce) and ``y`` is this rank's slice."""
    acc_t = torch.promote_types(s.dtype, torch.float32)
    (fs,) = _psum(comm, _mem_mm(fisher.f, s, acc_t), label="fisher_y")
    k = torch.arange(fisher.f.shape[0], device=fs.device)
    fs = torch.where(k < fisher.count, fs, torch.zeros_like(fs))
    y = _mem_mm(fs, fisher.f, acc_t)                              # [n]
    denom = torch.clamp(fisher.count, min=1).to(acc_t)
    return (y / denom).to(s.dtype)
