"""The grouped matrix product of a mixture of experts, and its plain
PyTorch version.

Rows of ``x [M, K]`` sorted by group (expert) hold group ``g``'s rows at
``offsets[g] : offsets[g + 1]``; ``w [G, K, N]`` holds one matrix a group.

    grouped_mm(x, w, offsets)[r] = x[r] @ w[g]   for r in group g,
                                   0             for a row of no group
    grouped_wgrad(a, c, offsets)[g] = a[rows of g]^T @ c[rows of g]

The offsets live on the device and are never read on the host there, so
a routing that changes from one call to the next needs no new shapes,
and a CUDA graph that holds these products replays any routing.

On the card each is one CUDA kernel of ``csrc/grouped_mm.cu``, built
into the port's kernel library (:func:`two_loop_kernel.build`), float32
with IEEE products (fused multiply-adds, no TF32); the source's header
says how it is designed:

* ``grouped_mm``: a block per ``(group, 128-row block, 128 columns)``;
  enough row blocks a group for its largest possible group
  (``max_rows``), and a block that starts past its group's last row exits
  at once;
* ``grouped_wgrad``: a block per ``(group, 128 x 128 tile)`` of
  ``[K, N]``, reducing over the group's rows from the device offsets.

Both read their operands through their strides: a transposed weight or a
strided tangent is not copied.

CPU tensors take a loop over the groups with the same offsets, in the
tensors' dtype.

:func:`grouped_mm` is differentiable in both modes, to any order that a
Hessian-vector product by ``torch.func.jvp`` of ``torch.func.grad``
needs: the backward is made of the same two products (``dx = grouped_mm
(dy, w^T)``, ``dw = grouped_wgrad(x, dy)``), themselves
``torch.autograd.Function`` s with forward-mode rules (``d(x w) = dx w +
x dw``, ``d(a^T c) = da^T c + a^T dc``), so the jvp of the gradient runs
through them.  Launches are counted as the two-loop kernels' are
(``two_loop_kernel.GROUPED_MM_LAUNCHES``; a launch recorded into a CUDA
graph is counted at each replay).
"""
from __future__ import annotations

import torch

from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk


def _check(name: str, x: torch.Tensor, w: torch.Tensor,
           offsets: torch.Tensor) -> None:
    if x.device != w.device or offsets.device != x.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if x.dtype != w.dtype:
        raise TypeError(f"{name}: operands of one dtype, got {x.dtype}, "
                        f"{w.dtype}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 \
            or offsets.stride(0) != 1:
        raise TypeError(f"{name}: offsets must be a contiguous 1-d int64 "
                        "tensor")
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")


def _rows_plain(x, w, offsets):
    y = x.new_zeros((x.shape[0], w.shape[2]))
    bounds = offsets.tolist()
    for g in range(w.shape[0]):
        a, b = bounds[g], bounds[g + 1]
        if b > a:
            y[a:b] = x[a:b] @ w[g]
    return y


def _wgrad_plain(a, c, offsets):
    out = a.new_zeros((len(offsets) - 1, a.shape[1], c.shape[1]))
    bounds = offsets.tolist()
    for g in range(out.shape[0]):
        lo, hi = bounds[g], bounds[g + 1]
        if hi > lo:
            out[g] = a[lo:hi].T @ c[lo:hi]
    return out


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _on_values(launch, *args):
    """``launch(*args)`` on the values under ``torch.func``'s wrappers (a
    kernel reads storage, which a wrapped tensor has not), its result
    wrapped again at the innermost level the arguments were at.  A
    forward-mode rule runs at one transform's level on tensors of that
    level, and its answer is a value there."""
    fc = torch._C._functorch
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    level = max((fc.maybe_get_level(t) for t in tensors), default=-1)
    with torch._C._DisableFuncTorch():     # plain tensors in and out
        out = launch(*[plain(a) if isinstance(a, torch.Tensor) else a
                       for a in args])
    return fc._wrap_for_grad(out, level) if level >= 0 else out


def plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every wrapper of ``torch.func``'s transforms taken off."""
    fc = torch._C._functorch
    while fc.is_functorch_wrapped_tensor(t):
        t = fc.get_unwrapped(t)
    return t


def _rows(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
          max_rows: int) -> torch.Tensor:
    """``y [M, N]``: each group's rows times its matrix, zeros elsewhere."""
    _check("grouped_mm", x, w, offsets)
    if not _on_card(x):
        return _rows_plain(x, w, offsets)
    return _on_values(_rows_kernel, x, w, offsets, max_rows)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    tlk._launched("GROUPED_MM_LAUNCHES")


def _rows_kernel(x, w, offsets, max_rows):
    M, K = x.shape
    G, _, N = w.shape
    y = torch.zeros((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0 or G == 0:
        return y
    with torch.cuda.device(x.device):
        err = tlk._library().grouped_mm_rows_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), offsets.data_ptr(), G,
            max_rows, M, K, N, x.stride(0), x.stride(1), w.stride(0),
            w.stride(1), w.stride(2), y.stride(0), y.stride(1), _stream(x))
    _launched(err, "grouped_mm")
    return y


def _wgrad(a: torch.Tensor, c: torch.Tensor,
           offsets: torch.Tensor) -> torch.Tensor:
    """``[G, K, N]``: each group's ``a`` rows transposed times its ``c``
    rows."""
    _check("grouped_wgrad", a, c, offsets)
    if not _on_card(a):
        return _wgrad_plain(a, c, offsets)
    return _on_values(_wgrad_kernel, a, c, offsets)


def _wgrad_kernel(a, c, offsets):
    K, N, G = a.shape[1], c.shape[1], offsets.shape[0] - 1
    out = torch.empty((G, K, N), dtype=a.dtype, device=a.device)
    if K == 0 or N == 0 or G == 0:
        return out
    with torch.cuda.device(a.device):
        err = tlk._library().grouped_mm_wgrad_launch(
            a.data_ptr(), c.data_ptr(), out.data_ptr(), offsets.data_ptr(), G,
            K, N, a.stride(0), a.stride(1), c.stride(0), c.stride(1),
            _stream(a))
    _launched(err, "grouped_wgrad")
    return out


def _plus(a, b):
    return b if a is None else (a if b is None else a + b)


class _GroupedMM(torch.autograd.Function):
    @staticmethod
    def forward(x, w, offsets, max_rows):
        return _rows(x, w, offsets, max_rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, offsets, max_rows = inputs
        ctx.save_for_backward(x, w, offsets)
        ctx.save_for_forward(x, w, offsets)
        ctx.max_rows = max_rows

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _GroupedMM.apply(dy, w.transpose(1, 2), offsets,
                                  ctx.max_rows)
        if ctx.needs_input_grad[1]:
            dw = _GroupedWGrad.apply(x, dy, offsets, ctx.max_rows)
        return dx, dw, None, None

    @staticmethod
    def jvp(ctx, dx, dw, _offsets, _max_rows):
        x, w, offsets = ctx.saved_tensors
        return _plus(None if dx is None else _rows(dx, w, offsets,
                                                   ctx.max_rows),
                     None if dw is None else _rows(x, dw, offsets,
                                                   ctx.max_rows))


class _GroupedWGrad(torch.autograd.Function):
    @staticmethod
    def forward(a, c, offsets, max_rows):
        return _wgrad(a, c, offsets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, c, offsets, max_rows = inputs
        ctx.save_for_backward(a, c, offsets)
        ctx.save_for_forward(a, c, offsets)
        ctx.max_rows = max_rows

    @staticmethod
    def backward(ctx, dg):
        a, c, offsets = ctx.saved_tensors
        da = dc = None
        if ctx.needs_input_grad[0]:
            da = _GroupedMM.apply(c, dg.transpose(1, 2), offsets,
                                  ctx.max_rows)
        if ctx.needs_input_grad[1]:
            dc = _GroupedMM.apply(a, dg, offsets, ctx.max_rows)
        return da, dc, None, None

    @staticmethod
    def jvp(ctx, da, dc, _offsets, _max_rows):
        a, c, offsets = ctx.saved_tensors
        return _plus(None if da is None else _wgrad(da, c, offsets),
                     None if dc is None else _wgrad(a, dc, offsets))


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
               max_rows: int = None) -> torch.Tensor:
    """``y [M, N]``, ``y[r] = x[r] @ w[g]`` for the rows ``offsets[g] :
    offsets[g + 1]`` of each group ``g`` (``offsets [G + 1]`` int64 on
    ``x``'s device, ascending), zeros for the rows of no group.
    ``max_rows``: the most rows any group can hold (``M`` where None);
    the kernel's grid is sized by it.  Differentiable in both modes."""
    return _GroupedMM.apply(x, w, offsets,
                            x.shape[0] if max_rows is None else max_rows)


def grouped_wgrad(a: torch.Tensor, c: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """``[G, K, N]``: ``a[rows of g]^T @ c[rows of g]`` for each group (the
    weight gradient of :func:`grouped_mm`).  Differentiable in both
    modes."""
    return _GroupedWGrad.apply(a, c, offsets, a.shape[0])
