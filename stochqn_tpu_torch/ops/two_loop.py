"""L-BFGS two-loop recursion: the commit-time cached form the optimizers
run, and the uncached oracles it is audited against.

Counterpart of :mod:`stochqn_tpu.ops.two_loop`.  :func:`two_loop_cached`
has three branches, each for either pair layout (block ``W = [s; y]`` or
interleaved ``W = sy``, both ``[2m, n]``; adaQN's is block only):

* SQN's collapsed scalar-H0 form: with the cache of
  :func:`stochqn_tpu_torch.ops.pairs.commit_pair` (``direction_cache=True``)
  the whole gamma-scaled two-loop is

      d = gamma*g + W^T ((c0 + gamma*cg) @ (W g))

  computed by a hand-written direction kernel for a float32 or bfloat16
  gradient (``direction``, one read of ``W``, where the gradient and the
  pairs are float32 and fit the card's shared memory; else
  ``direction_streamed``), and by the same three products in plain torch
  for float64.  An interleaved
  memory hands the kernels its two halves ``sy[:m]`` and ``sy[m:]``
  (views, no copy) with ``c0``/``cg`` in the same row order;
* oLBFGS's uncollapsed scalar-H0 form, in plain torch: project ``W g``,
  three m-sized products, expand;
* adaQN's diagonal-H0 form, with the ``matvec`` or ``gram`` coupling in
  plain torch, or (``use_pallas=True``) with ``W g``, ``(Y*D) g`` and
  ``(Y*D) Y^T`` from the hand-written projection kernel.

:func:`two_loop` is the compact two-loop straight from the pair rows, with
no cache (``use_pallas=True``: ``W g`` and ``W W^T`` from the hand-written
``project`` kernel), and :func:`two_loop_sequential` the operation-faithful
loop of the reference C code.

The kernels are in :mod:`stochqn_tpu_torch.ops.kernels.two_loop_kernel`;
the selects around them are plain torch and stay on the device.

``comm`` (a :class:`stochqn_tpu_torch.parallel.mesh.MeshComm`, or None)
is the mesh of a sharded run.  Where its param axis has more than one
rank, ``grad`` and the pair rows are this rank's slices of their last
axis, and every n-contraction (``W g``, a Gram) is a local partial sum
that one all-reduce completes; the expansions stay local.  The collapsed
direction then takes the split route (:func:`collapsed_route`): the
local ``W g``, one all-reduce of ``2m`` scalars, the small math and the
local ``gamma g + W^T u``, in plain torch, since the one-pass direction
kernels cannot sum across ranks between their projection and their
expansion.  With no mesh, or one rank on the param axis, nothing here
changes.
"""
from __future__ import annotations

from typing import Optional

import torch

from stochqn_tpu_torch.ops.kernels.two_loop_kernel import (direction,
                                                          direction_fits,
                                                          direction_streamed,
                                                          project,
                                                          project_adaqn)


# Collapsed directions that took the split route (sharded param axis): the
# route's counter, beside the kernels' launch counters.
SPLIT_ROUTE = 0


def _psum(comm, *parts, label="two_loop"):
    """The parts summed over the mesh's param axis in one all-reduce
    (identity with no mesh)."""
    return parts if comm is None else comm.sum_param(parts, label)


def _sharded(comm) -> bool:
    return comm is not None and comm.n_param > 1


def _mem_mm(a: torch.Tensor, b: torch.Tensor,
            acc_t: torch.dtype) -> torch.Tensor:
    """Streaming matmul against the pair memory, storage-aware.

    Operands of one dtype: a plain matmul in it (full float32 unless the
    caller enabled TF32, which the JAX package's ``Precision.HIGHEST``
    rules out).  bfloat16 storage, or operands of two dtypes (a float64
    gradient against float32 pairs): both upcast to ``acc_t`` first, as
    ``jnp.matmul(..., preferred_element_type=acc_t)`` promotes.
    """
    if a.dtype != b.dtype or a.dtype == torch.bfloat16:
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
                    coupling: str = "matvec", comm=None) -> torch.Tensor:
    """Approximate ``H^{-1} grad`` from the commit-time cache in ``mem``.

    Scalar H0 (``diag=None``), ``collapsed=True``: SQN's per-step
    direction.  ``h0 > 0`` overrides the cached ``gamma``; with no stored
    pairs the result is ``grad`` itself (``src/stochqn.c:808-812``), which
    also masks the stale collapsed cache after a flush.  The route is
    decided by dtype and shape before any launch: a float32 ``grad``
    takes :func:`direction` (float32 pairs within the card's cap) or
    :func:`direction_streamed` (bfloat16 pairs, or over the cap), and a
    bfloat16 ``grad`` (a bfloat16 iterate's) :func:`direction_streamed`
    on its float32 upcast; on CUDA they launch their kernels or raise and
    on the CPU run their plain versions.  float64 takes the same three
    products in plain torch on either device.  The direction comes back
    in ``grad``'s dtype.

    Scalar H0, ``collapsed=False``: oLBFGS's per-step direction (its
    commits build no ``c0``/``cg``), ``W g`` as two products over ``s`` and
    ``y`` in block layout (no ``[2m, n]`` copy) or one over ``sy``, three
    m-sized products, and one expansion per layout: ``gamma (g - Y^T
    alpha) + S^T (alpha - beta)`` in block layout, ``gamma g + W^T u``
    with ``u[2i] = alpha - beta``, ``u[2i + 1] = -gamma alpha`` (storage
    order) interleaved.

    Diagonal H0 (``diag [n]``, adaQN, block layout; ``collapsed`` is
    ignored, as in the JAX package): project ``W g``, three m-sized
    solves, expand.  The coupling term ``YD g - YD Y^T alpha`` is

    * ``coupling="matvec"``: ``Y @ (D (g - Y^T alpha))``, two matvecs;
    * ``coupling="gram"``: ``(Y*D) g - ((Y*D) Y^T) alpha``;
    * ``use_pallas=True`` with float32 ``grad`` and float32 pair storage
      (decided before any launch): ``W g``, ``(Y*D) g`` and ``(Y*D) Y^T``
      come from :func:`project_adaqn` (the CUDA kernel for CUDA tensors,
      its plain version for CPU ones), whatever ``coupling`` says.

    With no stored pairs the result is ``diag * grad``.

    ``comm``: the mesh of a sharded run (module docstring).  Sharded, the
    uncollapsed form sums ``W g`` in one all-reduce, the diagonal form
    ``W g`` (matvec coupling: then ``Y u2`` too, a second, dependent one)
    or ``W g``, ``(Y*D) g`` and ``(Y*D) Y^T`` together (gram coupling, or
    the projection kernel on this rank's columns).
    """
    if coupling not in ("matvec", "gram"):
        raise ValueError(f"coupling must be 'matvec' or 'gram', "
                         f"got {coupling!r}")
    interleaved = hasattr(mem, "sy")
    if interleaved and diag is not None:
        raise ValueError(
            "pairs_interleaved does not support a diagonal H0 (adaQN)")
    dtype = grad.dtype
    acc_t = mem.bwd_inv.dtype
    has_pairs = mem.count > 0
    g_acc = grad.to(acc_t)

    if diag is None:
        gamma = (torch.full((), h0, dtype=acc_t, device=grad.device)
                 if h0 > 0 else mem.gamma)
        gamma = torch.where(has_pairs, gamma, torch.ones_like(gamma))
        if collapsed:
            d = _collapsed(grad, mem, gamma, interleaved, comm)
        else:
            d = _uncollapsed(grad, mem, gamma, interleaved, comm)
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
    if ydg_st is None:
        (wg,) = _psum(comm, wg.to(acc_t))
    else:
        wg, ydg_st, ydy_st = _psum(comm, wg.to(acc_t), ydg_st.to(acc_t),
                                   ydy_st.to(acc_t))
    alpha = mem.bwd_inv @ (mem.rho * wg[:m][perm])

    # u2 = D (g - Y^T alpha): the direction's diagonal term, and in the
    # matvec coupling also YD g - YD Y^T alpha = Y @ u2 (no [m, n] Y*D and
    # no [m, m] weighted Gram).
    st_alpha_y = _mem_mm(_to_storage_order(alpha, perm), y_mem, acc_t)
    u2 = diag_acc * (g_acc - st_alpha_y)
    if ydg_st is None:
        (y_r0,) = _psum(comm, _mem_mm(y_mem, u2, acc_t))
        y_r0 = y_r0[perm]
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


def collapsed_route(first: torch.Tensor, grad: torch.Tensor,
                    acc_t: torch.dtype, comm=None) -> str:
    """The route the collapsed direction takes, decided before any launch:
    ``"split"`` on a sharded param axis; else ``"direction"`` (float32
    gradient and pairs within the card's cap) or ``"direction_streamed"``
    (a float32 gradient with bfloat16 pairs or over the cap, or a
    bfloat16 gradient, which the wrapper upcasts); else ``"plain"``
    (float64)."""
    if _sharded(comm):
        return "split"
    kernel_types = (torch.float32, torch.bfloat16)
    if (grad.dtype in kernel_types and acc_t == torch.float32
            and first.dtype in kernel_types):
        m, n = first.shape
        one_read = (grad.dtype == first.dtype == torch.float32
                    and direction_fits(m, n, grad.device))
        return "direction" if one_read else "direction_streamed"
    return "plain"


def _collapsed(grad: torch.Tensor, mem, gamma: torch.Tensor,
               interleaved: bool, comm=None) -> torch.Tensor:
    """``gamma g + W^T ((c0 + gamma cg) (W g))`` in the memory's row
    order, through a direction kernel for a float32 gradient, or on the
    split route (``W g`` summed over the param axis between the
    projection and the expansion)."""
    global SPLIT_ROUTE
    acc_t = mem.bwd_inv.dtype
    c = mem.c0 + gamma * mem.cg
    if interleaved:
        m = mem.mem_size
        first, second = mem.sy[:m], mem.sy[m:]    # W = [first; second]
    else:
        first, second = mem.s, mem.y
    route = collapsed_route(first, grad, acc_t, comm)
    if route in ("direction", "direction_streamed"):
        kernel = direction if route == "direction" else direction_streamed
        return kernel(first, second, grad, c, gamma)
    w = mem.sy if interleaved else torch.cat([first, second], dim=0)
    wg = _mem_mm(w, grad, acc_t)
    if route == "split":
        SPLIT_ROUTE += 1
        (wg,) = _psum(comm, wg)
    u = c @ wg
    return gamma * grad.to(acc_t) + _mem_mm(u, w, acc_t)


def _uncollapsed(grad: torch.Tensor, mem, gamma: torch.Tensor,
                 interleaved: bool, comm=None) -> torch.Tensor:
    """The scalar-H0 two-loop from the chronological cache: ``W g`` (one
    all-reduce on a sharded param axis), the backward and forward m-sized
    products, the expansion."""
    acc_t = mem.bwd_inv.dtype
    perm = mem.perm
    g_acc = grad.to(acc_t)
    if interleaved:
        (wg,) = _psum(comm, _mem_mm(mem.sy, grad, acc_t))
        sg, yg = wg[0::2][perm], wg[1::2][perm]
    else:
        sg, yg = _psum(comm, _mem_mm(mem.s, grad, acc_t),
                       _mem_mm(mem.y, grad, acc_t))
        sg, yg = sg[perm], yg[perm]
    alpha = mem.bwd_inv @ (mem.rho * sg)
    y_r0 = gamma * (yg - mem.yy_c @ alpha)
    beta = mem.fwd_inv @ (mem.rho * y_r0 + mem.rl_c @ alpha)
    if interleaved:
        # invalid chronological slots carry exact zeros (rho masking)
        u = torch.zeros(2 * perm.shape[0], dtype=acc_t, device=grad.device)
        u.index_copy_(0, 2 * perm, alpha - beta)
        u.index_copy_(0, 2 * perm + 1, -gamma * alpha)
        return gamma * g_acc + _mem_mm(u, mem.sy, acc_t)
    st_alpha_y = _mem_mm(_to_storage_order(alpha, perm), mem.y, acc_t)
    st_coeff_s = _mem_mm(_to_storage_order(alpha - beta, perm), mem.s,
                         acc_t)
    return gamma * (g_acc - st_alpha_y) + st_coeff_s


def _scalar_i64(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int64, device=device)


def two_loop(grad: torch.Tensor, s_mem: torch.Tensor, y_mem: torch.Tensor,
             head, count, *, h0: float = 0.0,
             diag: Optional[torch.Tensor] = None,
             gram: Optional[torch.Tensor] = None,
             use_pallas: bool = False, comm=None) -> torch.Tensor:
    """Approximate ``H^{-1} grad`` from the stored pairs, with no cache:
    the compact form (three products over ``W = [s_mem; y_mem]`` and two
    m x m triangular solves) that :func:`two_loop_cached` is audited
    against.

    ``s_mem``/``y_mem`` ``[m, n]`` in storage order, ``head``/``count`` the
    ring indices (tensors or Python ints).  ``h0 <= 0`` selects
    ``gamma = (s.y)/(y.y)`` of the latest pair; ``diag [n]`` is adaQN's
    elementwise H0 and overrides ``h0``.  ``gram`` is an optional cached
    ``W W^T`` in storage order.  With no stored pairs the result is
    ``grad`` (``diag * grad``), not ``h0 * grad``.

    ``use_pallas=True`` with float32 ``grad`` and pairs (decided before any
    launch; other dtypes take the plain route, as in the JAX package)
    fuses the projection into one hand-written kernel pass: ``W g`` and
    ``W W^T`` from :func:`project` when no Gram is given and no ``diag``;
    ``W g``, ``(Y*D) g`` and ``(Y*D) Y^T`` from :func:`project_adaqn` with
    ``diag``.  With a cached Gram and no ``diag`` there is nothing to
    fuse.  On CUDA the kernels launch or raise; on the CPU they run their
    plain versions.

    ``comm``: the mesh of a sharded run (module docstring).  Sharded,
    ``grad``, ``s_mem``, ``y_mem`` and ``diag`` are this rank's column
    slices, a given ``gram`` is the full one, and ``W g``, ``W W^T`` and
    the diagonal's products (kernel or plain, on this rank's columns) are
    summed in one all-reduce.
    """
    m = s_mem.shape[0]
    dtype = grad.dtype
    dev = grad.device
    acc_t = torch.promote_types(dtype, torch.float32)
    head = _scalar_i64(head, dev)
    count = _scalar_i64(count, dev)
    perm = _chrono_perm(m, head, count)
    valid = torch.arange(m, dtype=torch.int64, device=dev) < count
    validf = valid.to(acc_t)

    def w():
        return torch.cat([s_mem, y_mem], dim=0)                # [2m, n]

    ydg_st = ydy_st = None
    gram_given = gram is not None       # replicated; a computed one is local
    kernels = (use_pallas and dtype == torch.float32
               and s_mem.dtype == torch.float32)
    if kernels and diag is not None:
        wg, ydg_st, ydy_st = project_adaqn(s_mem, y_mem, diag, grad)
    elif kernels and gram is None:
        wg, gram = project(s_mem, y_mem, grad)
    else:
        wg = _mem_mm(w(), grad, acc_t)
    if gram is None:
        w_all = w()
        gram = _mem_mm(w_all, w_all.T, acc_t)
    if diag is not None and ydg_st is None:
        yd = y_mem.to(acc_t) * diag.to(acc_t)[None, :]
        ydg_st = _mem_mm(yd, grad, acc_t)
        ydy_st = _mem_mm(yd, y_mem.T, acc_t)
    if _sharded(comm):
        parts = [wg.to(acc_t)] + ([] if gram_given else [gram.to(acc_t)])
        if ydg_st is not None:
            parts += [ydg_st.to(acc_t), ydy_st.to(acc_t)]
        parts = list(_psum(comm, *parts))
        wg = parts.pop(0)
        gram = gram if gram_given else parts.pop(0)
        if ydg_st is not None:
            ydg_st, ydy_st = parts
    wg, gram = wg.to(acc_t), gram.to(acc_t)

    # chronologically ordered small quantities
    sg = wg[:m][perm]
    yg = wg[m:][perm]
    sy = gram[:m, m:][perm][:, perm]    # sy[c, d] = s_c . y_d
    yy = gram[m:, m:][perm][:, perm]
    sy_diag = torch.diagonal(sy)
    rho = validf / torch.where(valid, sy_diag, torch.ones_like(sy_diag))
    eye = torch.eye(m, dtype=acc_t, device=dev)

    # backward pass: unit-upper-triangular solve for alpha
    upper = torch.triu(rho[:, None] * sy, diagonal=1)
    alpha = torch.linalg.solve_triangular(
        eye + upper, (rho * sg)[:, None], upper=True)[:, 0] * validf

    has_pairs = count > 0
    g_acc = grad.to(acc_t)
    if diag is None:
        if h0 > 0:
            gamma = torch.full((), h0, dtype=acc_t, device=dev)
        else:
            # index_select, not [last]: a 0-d CUDA index is read on the host
            last = torch.clamp(count - 1, min=0).reshape(1)
            yy_last = torch.diagonal(yy).index_select(0, last)[0]
            gamma = sy_diag.index_select(0, last)[0] / torch.where(
                has_pairs, yy_last, torch.ones_like(yy_last))
        gamma = torch.where(has_pairs, gamma, torch.ones_like(gamma))
        h0_vec = gamma
        y_r0 = gamma * (yg - yy @ alpha)
    else:
        h0_vec = diag.to(acc_t)
        y_r0 = (ydg_st.to(acc_t)[perm]
                - ydy_st.to(acc_t)[perm][:, perm] @ alpha)

    # forward pass: unit-lower-triangular solve for beta
    lower = torch.tril(rho[:, None] * sy.T, diagonal=-1)
    beta = torch.linalg.solve_triangular(
        eye + lower, (rho * y_r0 + lower @ alpha)[:, None],
        upper=False)[:, 0] * validf

    # chronological coefficients back to storage order, then expand
    st_alpha_y = _mem_mm(_to_storage_order(alpha, perm), y_mem, acc_t)
    st_coeff_s = _mem_mm(_to_storage_order(alpha - beta, perm), s_mem, acc_t)
    d = h0_vec * (g_acc - st_alpha_y) + st_coeff_s
    empty = g_acc if diag is None else h0_vec * g_acc
    return torch.where(has_pairs, d, empty).to(dtype)


def two_loop_sequential(grad: torch.Tensor, s_mem: torch.Tensor,
                        y_mem: torch.Tensor, head, count, *, h0: float = 0.0,
                        diag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Operation-faithful sequential two-loop (``src/stochqn.c:663-708``):
    ``2 count`` dependent dot products and axpys, for cross-checks.  The
    loop bounds are Python ints, so ``head`` and ``count`` are read on the
    host."""
    m = s_mem.shape[0]
    head, count = int(head), int(count)
    if count == 0:
        return grad.clone() if diag is None else diag * grad
    rows = [(head - count + c) % m for c in range(count)]
    q = grad.clone()
    alpha, rho = [0.0] * count, [0.0] * count
    for c in reversed(range(count)):
        s_c, y_c = s_mem[rows[c]], y_mem[rows[c]]
        rho[c] = 1.0 / torch.dot(y_c, s_c)
        alpha[c] = rho[c] * torch.dot(q, s_c)
        q = q - alpha[c] * y_c
    if diag is not None:
        r = diag * q
    elif h0 > 0:
        r = h0 * q
    else:
        s_l, y_l = s_mem[rows[-1]], y_mem[rows[-1]]
        denom = torch.dot(y_l, y_l)
        r = torch.dot(s_l, y_l) / torch.where(
            denom != 0, denom, torch.ones_like(denom)) * q
    for c in range(count):
        s_c, y_c = s_mem[rows[c]], y_mem[rows[c]]
        beta = rho[c] * torch.dot(y_c, r)
        r = r + (alpha[c] - beta) * s_c
    return r
