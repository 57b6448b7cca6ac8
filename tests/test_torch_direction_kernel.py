"""The direction kernel's plain PyTorch version against the JAX package's
Pallas ``direction_streamed`` (interpret mode), the wrapper's checks, and —
on a machine with an NVIDIA GPU — the CUDA kernel against the plain version.

Tolerances are those of ``tests/test_pallas_kernels.py`` for the same
kernel (rtol 3e-5, atol 1e-4): float32 accumulation in different orders
over n columns and 2m rows.  bfloat16 storage is rounded the same way on
both sides (round to nearest even from the same float32 values) and
upcast before any arithmetic, so it takes the same tolerance.
"""
import numpy as np
import pytest
import torch

from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk

RTOL, ATOL = 3e-5, 1e-4
M = 4


def _inputs(n, m=M, seed=0):
    rng = np.random.default_rng(seed + n)
    s = rng.standard_normal((m, n)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal((2 * m, 2 * m)) / n).astype(np.float32)
    gamma = np.float32(0.7)
    return s, y, g, c, gamma


def _torch_args(s, y, g, c, gamma, storage, device="cpu"):
    return (torch.from_numpy(s).to(device, storage),
            torch.from_numpy(y).to(device, storage),
            torch.from_numpy(g).to(device),
            torch.from_numpy(c).to(device),
            torch.tensor(gamma, device=device))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [700, 900, 1000, 1500])  # not tile multiples
def test_ref_matches_pallas_interpret(n, storage):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from stochqn_tpu.ops.pallas.two_loop_kernel import direction_streamed

    s, y, g, c, gamma = _inputs(n)
    want = np.asarray(direction_streamed(
        jnp.asarray(s).astype(storage), jnp.asarray(y).astype(storage),
        jnp.asarray(g), jnp.asarray(c), jnp.asarray(gamma), tile_n=256,
        interpret=True))
    launches = tlk.LAUNCHES
    args = _torch_args(s, y, g, c, gamma, getattr(torch, storage))
    got = tlk.direction_streamed(*args)
    assert tlk.LAUNCHES == launches     # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(),
                                  tlk.direction_streamed_ref(*args).numpy())


def _bad_args(case):
    s, y, g, c, gamma = _torch_args(*_inputs(64), torch.float32)
    if case == "float64_storage":
        s, y = s.double(), y.double()
    elif case == "mixed_storage":
        y = y.to(torch.bfloat16)
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
    ("float64_storage", TypeError), ("mixed_storage", TypeError),
    ("bf16_grad", TypeError), ("grad_shape", ValueError),
    ("c_shape", ValueError), ("gamma_vector", ValueError),
    ("noncontiguous", ValueError), ("too_many_pairs", ValueError),
    ("mixed_device", ValueError)])
def test_wrapper_rejects_bad_arguments(case, exc):
    with pytest.raises(exc, match="direction_streamed"):
        tlk.direction_streamed(*_bad_args(case))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; runs on the card only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [700, 900, 1000, 1500, 292_083])
def test_kernel_matches_ref_on_cuda(cuda_device, n, storage):
    args = _torch_args(*_inputs(n, m=10), storage, cuda_device)
    launches = tlk.LAUNCHES
    got = tlk.direction_streamed(*args)
    torch.cuda.synchronize()
    assert tlk.LAUNCHES == launches + 1
    want = tlk.direction_streamed_ref(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
