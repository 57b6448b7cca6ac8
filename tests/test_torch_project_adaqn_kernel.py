"""The adaQN projection kernel's plain PyTorch version against the JAX
package's Pallas ``project_adaqn`` (interpret mode), the wrapper's checks,
and — on a machine with an NVIDIA GPU — the CUDA kernel against the plain
version.

Tolerances at n <= 1,500 are those of ``tests/test_pallas_kernels.py``
for the same kernel (rtol 2e-5, atol 1e-4): float32 sums over n columns
in different orders.  At n = 292,083 an absolute tolerance fixed in
advance no longer fits sums of that length, so both are held against a
float64 plain version instead, within 1e-5 of the sum of the terms'
magnitudes: a float32 sum in any blocked order carries at most a few
hundred roundings of eps = 6e-8 relative to that sum.

n takes every remainder mod 4: a row of the pair memory starts ``r * n``
floats after the first, so with such an n every row lies differently to
the 16-byte boundaries, and the CUDA kernel stages each row onto a boundary
of its own before it reads 16 bytes at a time.
"""
import numpy as np
import pytest
import torch

from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk

RTOL, ATOL = 2e-5, 1e-4
BOUND_REL = 1e-5


def _inputs(n, m=4, signed=False, seed=0):
    rng = np.random.default_rng(seed + n + 7 * m)
    s = rng.standard_normal((m, n)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    d = (rng.standard_normal(n) if signed
         else rng.uniform(0.1, 2.0, n)).astype(np.float32)
    return s, y, d, g


def _torch_args(s, y, d, g, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in (s, y, d, g))


def _float64_ref(s, y, d, g):
    """(values, magnitudes): the three products in float64, and the same
    products of the absolute values (the sum of |terms| of each entry)."""
    s, y, d, g = (np.asarray(a, np.float64) for a in (s, y, d, g))
    w, yd = np.concatenate([s, y]), y * d
    vals = (w @ g, yd @ g, yd @ y.T)
    mags = (np.abs(w) @ np.abs(g), np.abs(yd) @ np.abs(g),
            np.abs(yd) @ np.abs(y).T)
    return vals, mags


@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
# not multiples of 512; 1000 ... 1003 have every remainder mod 4
@pytest.mark.parametrize("n", [700, 1000, 1001, 1002, 1003, 1500])
def test_ref_matches_pallas_interpret(n, signed):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from stochqn_tpu.ops.pallas.two_loop_kernel import project_adaqn

    s, y, d, g = _inputs(n, signed=signed)
    want = project_adaqn(jnp.asarray(s), jnp.asarray(y), jnp.asarray(d),
                         jnp.asarray(g), tile_n=512, interpret=True)
    launches = tlk.PROJECT_ADAQN_LAUNCHES
    args = _torch_args(s, y, d, g)
    got = tlk.project_adaqn(*args)
    assert tlk.PROJECT_ADAQN_LAUNCHES == launches   # CPU: the plain version
    assert [t.shape for t in got] == [(8,), (4,), (4, 4)]
    for name, a, b in zip(("wg", "ydg", "ydy"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    ref = tlk.project_adaqn_ref(*args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ref_matches_float64():
    s, y, d, g = _inputs(1000, m=6, signed=True)
    got = tlk.project_adaqn(*_torch_args(s, y, d, g))
    vals, mags = _float64_ref(s, y, d, g)
    for a, v, mag in zip(got, vals, mags):
        assert np.all(np.abs(a.numpy() - v) <= BOUND_REL * mag)


def _bad_args(case):
    s, y, d, g = _torch_args(*_inputs(64))
    if case == "float64":
        s, y = s.double(), y.double()
    elif case == "bf16_pairs":
        s, y = s.to(torch.bfloat16), y.to(torch.bfloat16)
    elif case == "bf16_diag":
        d = d.to(torch.bfloat16)
    elif case == "diag_shape":
        d = d[:-1]
    elif case == "grad_shape":
        g = g[:-1]
    elif case == "y_shape":
        y = y[:-1]
    elif case == "noncontiguous":
        s = torch.from_numpy(np.asfortranarray(s.numpy()))
    elif case == "too_many_pairs":
        s, y = torch.zeros(33, 64), torch.zeros(33, 64)
    elif case == "mixed_device":
        g = g.to("meta")
    elif case == "meta_device":
        s, y, d, g = (t.to("meta") for t in (s, y, d, g))
    return s, y, d, g


@pytest.mark.parametrize("case,exc", [
    ("float64", TypeError), ("bf16_pairs", TypeError),
    ("bf16_diag", TypeError), ("diag_shape", ValueError),
    ("grad_shape", ValueError), ("y_shape", ValueError),
    ("noncontiguous", ValueError), ("too_many_pairs", ValueError),
    ("mixed_device", ValueError), ("meta_device", ValueError)])
def test_wrapper_rejects_bad_arguments(case, exc):
    with pytest.raises(exc, match="project_adaqn"):
        tlk.project_adaqn(*_bad_args(case))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; runs on the card only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("m", [1, 4, 10, 23, 32])
@pytest.mark.parametrize("n", [700, 1000, 1001, 1002, 1003, 1500])
def test_kernel_matches_ref_on_cuda(cuda_device, n, m, signed):
    args = _torch_args(*_inputs(n, m=m, signed=signed), cuda_device)
    launches = tlk.PROJECT_ADAQN_LAUNCHES
    got = tlk.project_adaqn(*args)
    torch.cuda.synchronize()
    assert tlk.PROJECT_ADAQN_LAUNCHES == launches + 1
    want = tlk.project_adaqn_ref(*args)
    for name, a, b in zip(("wg", "ydg", "ydy"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    ydy = got[2].cpu().numpy()
    np.testing.assert_array_equal(ydy, ydy.T)      # mirrored, not recomputed
    again = tlk.project_adaqn(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)                   # the same bits twice


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("m", [4, 10])
def test_kernel_at_flagship_n_matches_float64(cuda_device, m, signed):
    arrays = _inputs(292_083, m=m, signed=signed)
    args = _torch_args(*arrays, cuda_device)
    got = tlk.project_adaqn(*args)
    plain = tlk.project_adaqn_ref(*args)
    torch.cuda.synchronize()
    vals, mags = _float64_ref(*arrays)
    for name, a, p, v, mag in zip(("wg", "ydg", "ydy"), got, plain, vals,
                                  mags):
        for who, t in (("kernel", a), ("plain", p)):
            err = np.abs(t.cpu().numpy().astype(np.float64) - v)
            assert np.all(err <= BOUND_REL * mag), (name, who,
                                                    float(err.max()))
