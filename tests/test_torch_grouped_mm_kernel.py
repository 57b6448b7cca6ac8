"""The grouped product of a mixture of experts
(:mod:`stochqn_tpu_torch.ops.kernels.grouped_mm`): forward, backward and
the forward-mode rule against a per-group ``torch.mm``, with empty groups,
a group that holds every row and rows of no group, and the jvp of a
gradient through it against double backward.  On the CPU the plain
version runs; the ``cuda`` cases run the CUDA kernels on the card, and
replay one captured graph with two routings.

This file imports no JAX: run its card cases on the machine with the
card, ``python -m pytest --noconftest -m cuda
tests/test_torch_grouped_mm_kernel.py``.
"""
import pytest
import torch

from stochqn_tpu_torch.ops.kernels import grouped_mm as gm
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk

G, K, N = 4, 40, 24
# rows per group, then rows of no group at the end of the buffer
COUNTS = {
    "mixed": ([5, 0, 17, 3], 7),
    "empty": ([0, 0, 0, 0], 9),
    "full": ([0, 32, 0, 0], 0),
    "one_each": ([1, 1, 1, 1], 2),
}


def _case(name, device, dtype, seed=0):
    counts, tail = COUNTS[name]
    g = torch.Generator().manual_seed(seed)
    M = sum(counts) + tail
    x = torch.randn(M, K, generator=g, dtype=dtype).to(device)
    w = torch.randn(G, K, N, generator=g, dtype=dtype).to(device)
    offsets = torch.tensor([0] + counts, dtype=torch.int64).cumsum(0) \
        .to(device)
    return x, w, offsets


def _per_group(x, w, offsets):
    out = torch.zeros(x.shape[0], w.shape[2], dtype=x.dtype, device=x.device)
    b = offsets.tolist()
    for e in range(w.shape[0]):
        out[b[e]:b[e + 1]] = torch.mm(x[b[e]:b[e + 1]], w[e])
    return out


def _loss(x, w, offsets):
    return (torch.tanh(gm.grouped_mm(x, w, offsets)) ** 2).sum()


def _loss_plain(x, w, offsets):
    return (torch.tanh(_per_group(x, w, offsets)) ** 2).sum()


def _check_all(device, dtype, name, tol):
    x, w, off = _case(name, device, dtype)
    torch.testing.assert_close(gm.grouped_mm(x, w, off), _per_group(x, w, off),
                               rtol=tol, atol=tol)
    dx, dw = torch.func.grad(_loss, argnums=(0, 1))(x, w, off)
    rx, rw = torch.func.grad(_loss_plain, argnums=(0, 1))(x, w, off)
    torch.testing.assert_close(dx, rx, rtol=tol, atol=tol)
    torch.testing.assert_close(dw, rw, rtol=tol, atol=tol)
    tx, tw = torch.randn_like(x), torch.randn_like(w)
    _, jv = torch.func.jvp(lambda a, b: gm.grouped_mm(a, b, off), (x, w),
                           (tx, tw))
    _, rj = torch.func.jvp(lambda a, b: _per_group(a, b, off), (x, w),
                           (tx, tw))
    torch.testing.assert_close(jv, rj, rtol=tol, atol=tol)
    # the jvp of the gradient (a Hessian-vector product) against double
    # backward of the per-group product
    hv = torch.func.jvp(lambda a, b: torch.func.grad(_loss, argnums=(0, 1))(
        a, b, off), (x, w), (tx, tw))[1]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(_loss_plain(xr, wr, off), (xr, wr),
                                 create_graph=True)
    hr = torch.autograd.grad((gx * tx).sum() + (gw * tw).sum(), (xr, wr))
    torch.testing.assert_close(hv[0], hr[0], rtol=tol, atol=tol)
    torch.testing.assert_close(hv[1], hr[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_plain_version_matches_per_group_mm(name):
    _check_all(torch.device("cpu"), torch.float64, name, 1e-12)


def test_rows_of_no_group_are_zero_and_wgrad_of_an_empty_group_is_zero():
    x, w, off = _case("mixed", "cpu", torch.float64)
    y = gm.grouped_mm(x, w, off)
    assert torch.equal(y[int(off[-1]):], torch.zeros_like(y[int(off[-1]):]))
    g = gm.grouped_wgrad(x, y, off)
    assert torch.equal(g[1], torch.zeros_like(g[1]))
    torch.testing.assert_close(g[2], x[5:22].T @ y[5:22])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run on the "
                    "card only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(COUNTS))
def test_kernel_matches_per_group_mm(dev, name):
    torch.backends.cuda.matmul.allow_tf32 = False
    before = tlk.GROUPED_MM_LAUNCHES
    _check_all(dev, torch.float32, name, 1e-4)
    assert tlk.GROUPED_MM_LAUNCHES > before


@pytest.mark.cuda
def test_two_replays_of_one_graph_with_two_routings(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, off = _case("mixed", dev, torch.float32)
    routings = [off.clone(), torch.tensor([0, 2, 2, 30, 32], device=dev)]
    static = off.clone()
    gm.grouped_mm(x, w, static)                 # builds the kernel
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            out = gm.grouped_mm(x, w, static)
            wg = gm.grouped_wgrad(x, out, static)
    torch.cuda.current_stream().wait_stream(s)
    for r in routings:
        static.copy_(r)
        graph.replay()
        torch.cuda.synchronize()
        want = _per_group(x, w, r)
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
        b = r.tolist()
        for e in range(G):
            torch.testing.assert_close(
                wg[e], x[b[e]:b[e + 1]].T @ want[b[e]:b[e + 1]],
                rtol=1e-4, atol=1e-3)
