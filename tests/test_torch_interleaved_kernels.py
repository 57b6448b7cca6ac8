"""The two direction kernels on an interleaved pair memory.

SQN's collapsed direction from a ``BFGSMemoryInterleaved`` is the same
function as from a block memory with ``W``'s rows permuted: ``W = sy``,
and ``C`` in the same row order.  ``two_loop_cached(collapsed=True)``
hands the wrappers the two halves ``sy[:m]`` and ``sy[m:]`` as views of
the one buffer, with no copy.  The second view starts ``m * n`` elements
into ``sy``, so for most ``n`` its base address is not 16-byte aligned,
where a block memory's ``y`` is its own allocation: the kernels must take
each row's 16-byte phase from its address.  The ``cuda`` cases hold both
kernels on such views against their plain versions at every phase of
``n = 2,001 ... 2,008`` (tolerance of ``tests/test_torch_direction_kernel.py``:
rtol 3e-5, atol 1e-4, ``c`` scaled by 1 / n) and check the same bits
twice.  This file imports no JAX, so that it runs on a machine with a card
and no JAX (``pytest --noconftest -m cuda``).
"""
import numpy as np
import pytest
import torch

from stochqn_tpu_torch.core.state import BFGSMemoryInterleaved
from stochqn_tpu_torch.ops import pairs, two_loop
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk

RTOL, ATOL = 3e-5, 1e-4
NS = range(2001, 2009)          # every 16-byte phase of the rows


def _views(m, n, storage, device="cpu", seed=0):
    """An interleaved buffer ``sy [2m, n]``, its halves, a gradient, ``c``
    and gamma, made with numpy."""
    rng = np.random.default_rng(seed + 100 * m + n)
    sy = torch.from_numpy(rng.standard_normal((2 * m, n)).astype(np.float32))
    sy = sy.to(device, storage)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    c = torch.from_numpy((rng.standard_normal((2 * m, 2 * m)) / n).astype(
        np.float32)).to(device)
    return sy, (sy[:m], sy[m:], g, c, torch.tensor(0.7, device=device))


def _interleaved_memory(m, n, commits):
    rng = np.random.default_rng(m + n)
    mem = BFGSMemoryInterleaved.create(m, n)
    for _ in range(commits):
        s = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        y = s + 0.3 * torch.from_numpy(rng.standard_normal(n).astype(
            np.float32))
        mem, _ = pairs.commit_pair(mem.replace(s_pending=s), y, 1e-4, 0.0,
                                   direction_cache=True)
    return mem


@pytest.mark.parametrize("kernel", ["direction", "direction_streamed"])
def test_collapsed_interleaved_hands_the_kernel_views(monkeypatch, kernel):
    """The gate's kernel (or the streamed one where the gate refuses the
    one-read kernel) gets ``sy[:m]`` and ``sy[m:]``: the buffer itself, no
    copy."""
    m, n = 3, 2003
    mem = _interleaved_memory(m, n, commits=5)
    calls = []

    def spy(*args):
        calls.append(args)
        return getattr(tlk, kernel)(*args)
    monkeypatch.setattr(two_loop, kernel, spy)
    if kernel == "direction_streamed":
        monkeypatch.setattr(two_loop, "direction_fits", lambda m, n, d: False)
    g = torch.ones(n)
    two_loop.two_loop_cached(g, mem, collapsed=True)
    (first, second, grad, c, gamma), = calls
    esize = mem.sy.element_size()
    assert first.data_ptr() == mem.sy.data_ptr()
    assert second.data_ptr() == mem.sy.data_ptr() + m * n * esize
    assert (second.data_ptr() % 16) != 0 or (m * n * esize) % 16 == 0
    assert grad is g and c.shape == (2 * m, 2 * m)


@pytest.mark.parametrize("kernel", ["direction", "direction_streamed"])
@pytest.mark.parametrize("m", [1, 10, 20])
@pytest.mark.parametrize("n", [2001, 2004])
def test_wrappers_take_views_on_the_cpu(n, m, kernel):
    """On CPU tensors the wrappers accept the two views and run their
    plain version: ``gamma g + sy^T (c (sy g))``."""
    sy, args = _views(m, n, torch.float32)
    got = getattr(tlk, kernel)(*args)
    g, c, gamma = args[2:]
    want = gamma * g + (c @ (sy @ g)) @ sy
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; runs on the card only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,storage", [
    ("direction", torch.float32), ("direction_streamed", torch.float32),
    ("direction_streamed", torch.bfloat16)],   # direction takes float32 only
    ids=["direction", "direction_streamed", "direction_streamed_bf16"])
@pytest.mark.parametrize("m", [1, 10, 20])
@pytest.mark.parametrize("n", NS)
def test_kernels_on_interleaved_views_match_ref_on_cuda(cuda_device, n, m,
                                                        kernel, storage):
    sy, args = _views(m, n, storage, cuda_device)
    counter = "DIRECTION_LAUNCHES" if kernel == "direction" else "LAUNCHES"
    before = getattr(tlk, counter)
    got = getattr(tlk, kernel)(*args)
    again = getattr(tlk, kernel)(*args)
    torch.cuda.synchronize()
    assert getattr(tlk, counter) == before + 2
    want = getattr(tlk, f"{kernel}_ref")(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)
    # and the same as from a block memory holding the same rows
    block = getattr(tlk, kernel)(args[0].clone(), args[1].clone(), *args[2:])
    np.testing.assert_allclose(got.cpu().numpy(), block.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
