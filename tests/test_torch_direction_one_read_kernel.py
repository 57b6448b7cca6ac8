"""The one-read ``direction`` kernel's plain PyTorch version against the
JAX package's Pallas ``direction`` (interpret mode) and against both
packages' ``two_loop_cached(collapsed=True)``, the gate that chooses
between the two direction kernels and the plain route, and (on a machine
with an NVIDIA GPU) the CUDA kernel against the plain version up to the
card's cap.

Tolerances are those of ``tests/test_pallas_kernels.py`` and
``tests/test_fused.py`` for the same kernel
(``test_direction_kernel_matches_collapsed_xla``: rtol 3e-5, atol 1e-4):
float32 sums over n columns and 2m rows in different orders.
"""
import dataclasses

import numpy as np
import pytest
import torch

from stochqn_tpu_torch.core.state import BFGSMemory
from stochqn_tpu_torch.ops import pairs, two_loop
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk
from stochqn_tpu_torch.ops.two_loop import two_loop_cached

RTOL, ATOL = 3e-5, 1e-4
M, N = 4, 900


def _inputs(n, m=M, seed=0):
    rng = np.random.default_rng(seed + n)
    s = rng.standard_normal((m, n)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal((2 * m, 2 * m)) / n).astype(np.float32)
    return s, y, g, c, np.float32(0.7)


def _torch_args(s, y, g, c, gamma, device="cpu"):
    return (*(torch.from_numpy(a).to(device) for a in (s, y, g, c)),
            torch.tensor(gamma, device=device))


@pytest.mark.parametrize("n", [700, 900, 1000, 1500])  # not tile multiples
def test_ref_matches_pallas_interpret(n):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from stochqn_tpu.ops.pallas.two_loop_kernel import direction

    arrays = _inputs(n)
    want = np.asarray(direction(*(jnp.asarray(a) for a in arrays),
                                tile_n=256, interpret=True))
    launches = tlk.DIRECTION_LAUNCHES
    args = _torch_args(*arrays)
    got = tlk.direction(*args)
    assert tlk.DIRECTION_LAUNCHES == launches   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(),
                                  tlk.direction_ref(*args).numpy())


def test_direction_matches_collapsed_two_loop_of_both_packages():
    """On a real commit cache with the ring overfilled (6 commits into
    m = 4): the kernel's function on ``c0 + gamma * cg`` is the collapsed
    direction of the port and of the JAX package."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from stochqn_tpu.core.state import BFGSMemory as JaxMemory
    from stochqn_tpu.ops.pairs import commit_pair as jax_commit
    from stochqn_tpu.ops.two_loop import two_loop_cached as jax_two_loop
    from stochqn_tpu_torch.convert import bfgs_memory_from_numpy

    rng = np.random.default_rng(3)
    jmem = JaxMemory.create(M, N, jnp.float32)
    for _ in range(6):
        s = rng.standard_normal(N).astype(np.float32)
        y = (s + 0.3 * rng.standard_normal(N)).astype(np.float32)
        jmem, acc = jax_commit(jmem.replace(s_pending=jnp.asarray(s)),
                               jnp.asarray(y), 1e-4, 0.0,
                               direction_cache=True)
        assert bool(acc)
    g = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, collapsed=True))
    mem = bfgs_memory_from_numpy(
        {f.name: np.asarray(getattr(jmem, f.name))
         for f in dataclasses.fields(jmem)}, device="cpu")
    tg = torch.from_numpy(g)
    got = tlk.direction(mem.s, mem.y, tg, mem.c0 + mem.gamma * mem.cg,
                        mem.gamma)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    port = two_loop_cached(tg, mem, collapsed=True)
    np.testing.assert_array_equal(got.numpy(), port.numpy())


def _port_mem(dtype, storage):
    rng = np.random.default_rng(6)
    mem = BFGSMemory.create(M, N, dtype, storage_dtype=storage)
    for _ in range(3):
        s = torch.from_numpy(rng.standard_normal(N)).to(dtype)
        y = s + 0.3 * torch.from_numpy(rng.standard_normal(N)).to(dtype)
        mem, _ = pairs.commit_pair(mem.replace(s_pending=s), y, 1e-8, 0.0,
                                   direction_cache=True)
    return mem


@pytest.mark.parametrize("dtype,storage,route", [
    (torch.float32, torch.float32, "direction"),
    (torch.float32, torch.bfloat16, "direction_streamed"),
    (torch.float64, torch.float64, "plain"),
    (torch.bfloat16, torch.bfloat16, "direction_streamed"),
], ids=["float32", "bf16_pairs", "float64", "bf16_state"])
def test_gate_routes_by_dtype(monkeypatch, dtype, storage, route):
    """The collapsed branch decides its route before any call: float32
    gradient and pairs take ``direction``, bfloat16 pairs or a bfloat16
    gradient (a bfloat16 iterate's) ``direction_streamed``, float64 plain
    torch."""
    calls = []
    for name in ("direction", "direction_streamed"):
        def spy(*args, _name=name, _fn=getattr(tlk, name)):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(two_loop, name, spy)
    mem = _port_mem(dtype, storage)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(N)).to(dtype)
    d = two_loop_cached(g, mem, collapsed=True)
    assert d.dtype == dtype and d.shape == (N,)
    assert calls == ([] if route == "plain" else [route])
    w = torch.cat([mem.s, mem.y]).double()
    gamma = mem.gamma.double()
    c = mem.c0.double() + gamma * mem.cg.double()
    want = gamma * g.double() + (c @ (w @ g.double())) @ w
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4 if (
        dtype == torch.float32) else 1e-12
    np.testing.assert_allclose(d.double().numpy(), want.numpy(), rtol=tol,
                               atol=tol)


def test_gate_sends_a_shape_over_the_cap_to_direction_streamed(monkeypatch):
    calls = []
    monkeypatch.setattr(two_loop, "direction_fits", lambda m, n, dev: False)
    monkeypatch.setattr(two_loop, "direction",
                        lambda *a: pytest.fail("over the cap"))

    def spy(*args):
        calls.append(args)
        return tlk.direction_streamed(*args)
    monkeypatch.setattr(two_loop, "direction_streamed", spy)
    mem = _port_mem(torch.float32, torch.float32)
    two_loop_cached(torch.ones(N), mem, collapsed=True)
    assert len(calls) == 1
    assert tlk.direction_fits(M, 10 ** 9, torch.device("cpu"))


def _bad_args(case):
    s, y, g, c, gamma = _torch_args(*_inputs(64))
    if case == "float64_storage":
        s, y = s.double(), y.double()
    elif case == "bf16_storage":
        s, y = s.to(torch.bfloat16), y.to(torch.bfloat16)
    elif case == "bf16_grad":
        g = g.to(torch.bfloat16)
    elif case == "grad_shape":
        g = g[:-1]
    elif case == "c_shape":
        c = c[:-1]
    elif case == "gamma_vector":
        gamma = torch.ones(2)
    elif case == "noncontiguous":
        s = torch.from_numpy(np.asfortranarray(s.numpy()))
    elif case == "too_many_pairs":
        s = torch.zeros(33, 64)
        y = torch.zeros(33, 64)
        c = torch.zeros(66, 66)
    elif case == "mixed_device":
        g = g.to("meta")
    return s, y, g, c, gamma


@pytest.mark.parametrize("case,exc", [
    ("float64_storage", TypeError), ("bf16_storage", TypeError),
    ("bf16_grad", TypeError), ("grad_shape", ValueError),
    ("c_shape", ValueError), ("gamma_vector", ValueError),
    ("noncontiguous", ValueError), ("too_many_pairs", ValueError),
    ("mixed_device", ValueError)])
def test_wrapper_rejects_bad_arguments(case, exc):
    with pytest.raises(exc, match="direction:"):
        tlk.direction(*_bad_args(case))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; runs on the card only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 10, 32])
@pytest.mark.parametrize("n", [100, 700, 900, 1000, 1500, 292_083])
def test_kernel_matches_ref_on_cuda(cuda_device, n, m):
    if not tlk.direction_fits(m, n, cuda_device):
        pytest.skip(f"m={m}, n={n} is over this card's cap "
                    f"({tlk.direction_max_n(m, cuda_device)})")
    args = _torch_args(*_inputs(n, m=m), cuda_device)
    launches = tlk.DIRECTION_LAUNCHES
    got = tlk.direction(*args)
    again = tlk.direction(*args)
    torch.cuda.synchronize()
    assert tlk.DIRECTION_LAUNCHES == launches + 2
    assert torch.equal(got, again)           # fixed-order sums
    want = tlk.direction_ref(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    streamed = tlk.direction_streamed(*args)
    np.testing.assert_allclose(got.cpu().numpy(), streamed.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 10, 32])
@pytest.mark.parametrize("n", range(2001, 2009))
def test_every_row_phase_on_cuda(cuda_device, n, m):
    """n = 2,001 ... 2,008: row r of S and Y starts r * n elements on, so
    the rows (and g, and each block's first column) take every phase
    against the 16-byte boundary the bulk copies need."""
    args = _torch_args(*_inputs(n, m=m), cuda_device)
    got = tlk.direction(*args)
    again = tlk.direction(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(),
                               tlk.direction_ref(*args).cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 10, 20, 32])
def test_one_column_on_cuda(cuda_device, m):
    args = _torch_args(*_inputs(1, m=m), cuda_device)
    got = tlk.direction(*args)
    again = tlk.direction(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(),
                               tlk.direction_ref(*args).cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 10, 32])
@pytest.mark.parametrize("n", [2001, 2003, 29_207])
def test_interleaved_views_on_cuda(cuda_device, n, m):
    """``sy[:m]`` and ``sy[m:]`` of one ``[2m, n]`` buffer at odd n, as an
    interleaved memory hands them over: ``sy[m:]`` starts off a 16-byte
    boundary."""
    s, y, g, c, gamma = _torch_args(*_inputs(n, m=m), cuda_device)
    sy = torch.cat([s, y])
    args = (sy[:m], sy[m:], g, c, gamma)
    assert all(a.is_contiguous() for a in args[:2])
    got = tlk.direction(*args)
    again = tlk.direction(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, tlk.direction(s, y, g, c, gamma))
    np.testing.assert_allclose(got.cpu().numpy(),
                               tlk.direction_ref(*args).cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [900, 292_083])
def test_graph_replay_gives_eager_bits_on_cuda(cuda_device, monkeypatch, n):
    """One ``direction`` captured in a CUDA graph (one block and a plain
    launch at n = 900, a cooperative grid at the flagship): the replay
    writes the eager call's bits, and the capture records its launch
    instead of counting it."""
    monkeypatch.setattr(tlk, "CAPTURED", {})
    args = _torch_args(*_inputs(n, m=10), cuda_device)
    eager = tlk.direction(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tlk.direction(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = tlk.DIRECTION_LAUNCHES
    with torch.cuda.graph(graph):
        out = tlk.direction(*args)
    assert tlk.DIRECTION_LAUNCHES == launches
    assert tlk.CAPTURED == {"DIRECTION_LAUNCHES": 1}
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 10, 20, 32])
def test_cap_on_cuda(cuda_device, m):
    """The largest n within the card's cap runs and is right; the first n
    over it raises before any launch."""
    n = tlk.direction_max_n(m, cuda_device)
    assert n > 0
    args = _torch_args(*_inputs(n, m=m), cuda_device)
    got = tlk.direction(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               tlk.direction_ref(*args).cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    over = _torch_args(*_inputs(n + 1, m=m), cuda_device)
    launches = tlk.DIRECTION_LAUNCHES
    with pytest.raises(ValueError, match="direction_streamed"):
        tlk.direction(*over)
    assert tlk.DIRECTION_LAUNCHES == launches
