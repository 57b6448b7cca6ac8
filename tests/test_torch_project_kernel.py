"""The ``project`` kernel's plain PyTorch version against the JAX package's
Pallas ``project`` (interpret mode) and against the two matmuls, the
wrapper's checks, and (on a machine with an NVIDIA GPU) the CUDA kernel
against the plain version.

Tolerances are those of ``tests/test_pallas_kernels.py`` for the same
kernel (``test_project_matches_xla``: rtol 2e-5, atol 1e-4): float32 sums
over n columns in different orders.
"""
import numpy as np
import pytest
import torch

from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk

RTOL, ATOL = 2e-5, 1e-4
M = 5


def _inputs(n, m=M, seed=0):
    rng = np.random.default_rng(seed + n)
    s = rng.standard_normal((m, n)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return s, y, g


def _torch_args(arrays, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


# m = 5 at a non-multiple and a multiple of the tile; then m whose 2m rows
# leave room for g in their last block of 8 (1, 10, 14) and fill their blocks
# (20), at every n mod 4
_CPU_SHAPES = [pytest.param(M, 1000, id="1000"), pytest.param(M, 2048,
                                                              id="2048")]
_CPU_SHAPES += [pytest.param(m, n, id=f"m{m}-n{n}")
                for m in (1, 10, 14, 20) for n in range(1001, 1005)]


@pytest.mark.parametrize("m,n", _CPU_SHAPES)
def test_ref_matches_pallas_interpret_and_matmuls(m, n):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from stochqn_tpu.ops.pallas.two_loop_kernel import project

    s, y, g = _inputs(n, m=m)
    wg_j, gram_j = project(jnp.asarray(s), jnp.asarray(y), jnp.asarray(g),
                           tile_n=512, interpret=True)
    launches = tlk.PROJECT_LAUNCHES
    wg, gram = tlk.project(*_torch_args((s, y, g)))
    assert tlk.PROJECT_LAUNCHES == launches   # CPU tensors: the plain version
    assert wg.shape == (2 * m,) and gram.shape == (2 * m, 2 * m)
    assert wg.dtype == gram.dtype == torch.float32
    w = np.concatenate([s, y]).astype(np.float64)
    for got, pallas, exact in ((wg, wg_j, w @ g), (gram, gram_j, w @ w.T)):
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), exact, rtol=RTOL, atol=ATOL)


def _bad_args(case):
    s, y, g = _torch_args(_inputs(64))
    if case == "float64":
        s, y, g = s.double(), y.double(), g.double()
    elif case == "bf16_pairs":
        s, y = s.to(torch.bfloat16), y.to(torch.bfloat16)
    elif case == "pair_shapes":
        y = y[:-1]
    elif case == "grad_shape":
        g = g[:-1]
    elif case == "noncontiguous":
        s = torch.from_numpy(np.asfortranarray(s.numpy()))
    elif case == "too_many_pairs":
        s = torch.zeros(33, 64)
        y = torch.zeros(33, 64)
    elif case == "mixed_device":
        g = g.to("meta")
    return s, y, g


@pytest.mark.parametrize("case,exc", [
    ("float64", TypeError), ("bf16_pairs", TypeError),
    ("pair_shapes", ValueError), ("grad_shape", ValueError),
    ("noncontiguous", ValueError), ("too_many_pairs", ValueError),
    ("mixed_device", ValueError)])
def test_wrapper_rejects_bad_arguments(case, exc):
    with pytest.raises(exc, match="project"):
        tlk.project(*_bad_args(case))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; runs on the card only)")
    return torch.device("cuda")


# m: g as a row of the last row block (1, 5, 10, 14, 23) and as a unit of
# its own (20, 32), staging warps (1 ... 14, 23, 32) and none (20), one unit
# group and several (23, 32); n: one column, a tile and one more, under and
# over a few tiles, and every 16-byte phase of the rows
@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 10, 14, 20, 23, 32])
@pytest.mark.parametrize("n", [1, 257, 700, 1000, 1500, *range(2001, 2009),
                               2048])
def test_kernel_matches_ref_on_cuda(cuda_device, n, m):
    """Against the plain version, the same bits twice, and a Gram that is
    exactly symmetric."""
    args = _torch_args(_inputs(n, m=m), cuda_device)
    launches = tlk.PROJECT_LAUNCHES
    wg, gram = tlk.project(*args)
    wg2, gram2 = tlk.project(*args)
    torch.cuda.synchronize()
    assert tlk.PROJECT_LAUNCHES == launches + 2
    assert torch.equal(wg, wg2) and torch.equal(gram, gram2)
    assert torch.equal(gram, gram.T)
    for got, want in zip((wg, gram), tlk.project_ref(*args)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [10, 20])
def test_kernel_at_flagship_n_matches_float64(cuda_device, m):
    """At n = 292,083 a fixed absolute tolerance does not fit sums of that
    length: the kernel is held against a float64 version within 1e-5 of
    the sum of the terms' magnitudes, and repeats itself bit for bit."""
    arrays = _inputs(292_083, m=m)
    args = _torch_args(arrays, cuda_device)
    wg, gram = tlk.project(*args)
    wg2, gram2 = tlk.project(*args)
    torch.cuda.synchronize()
    assert torch.equal(wg, wg2) and torch.equal(gram, gram2)
    s, y, g = (a.astype(np.float64) for a in arrays)
    w = np.concatenate([s, y])
    for got, val, mag in ((wg, w @ g, np.abs(w) @ np.abs(g)),
                          (gram, w @ w.T, np.abs(w) @ np.abs(w).T)):
        err = np.abs(got.cpu().numpy().astype(np.float64) - val)
        assert (err <= 1e-5 * mag).all(), float((err / mag).max())
