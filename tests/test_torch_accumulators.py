"""The torch port's AdaGrad / RMSProp accumulator and diagonal rescaling
against the JAX package.

Elementwise float32 on both sides; ``rsqrt`` may differ by an ulp between
the two frameworks, so rtol 1e-6 (atol 1e-7 for entries near zero).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.ops import accumulators as jacc  # noqa: E402
from stochqn_tpu_torch.ops import accumulators as tacc  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
N = 257


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    g = (3.0 * rng.standard_normal(N)).astype(np.float32)
    acc = rng.uniform(0.0, 5.0, N).astype(np.float32)
    return g, acc


@pytest.mark.parametrize("rmsprop_weight", [0.0, 0.5, 0.9],
                         ids=["adagrad", "rmsprop_0.5", "rmsprop_0.9"])
def test_update_sum_sq_matches_jax(rmsprop_weight):
    g, acc = _inputs()
    want = np.asarray(jacc.update_sum_sq(jnp.asarray(g), jnp.asarray(acc),
                                         rmsprop_weight))
    got = tacc.update_sum_sq(torch.from_numpy(g), torch.from_numpy(acc),
                             rmsprop_weight)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scal_reg", [1e-4, 1e-2])
@pytest.mark.parametrize("rmsprop_weight", [0.0, 0.9],
                         ids=["adagrad", "rmsprop"])
def test_diag_rescal_matches_jax(rmsprop_weight, scal_reg):
    g, acc = _inputs(1)
    jres, jnew = jacc.diag_rescal(jnp.asarray(g), jnp.asarray(acc), scal_reg,
                                  rmsprop_weight)
    tres, tnew = tacc.diag_rescal(torch.from_numpy(g), torch.from_numpy(acc),
                                  scal_reg, rmsprop_weight)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=RTOL,
                               atol=ATOL)


def test_adagrad_first_step_from_zero():
    """From a zero accumulator the rescaled gradient is g / sqrt(g^2 + reg),
    inside (-1, 1), on both sides."""
    g, _ = _inputs(2)
    zero = np.zeros(N, np.float32)
    tres, tnew = tacc.diag_rescal(torch.from_numpy(g), torch.from_numpy(zero),
                                  1e-4, 0.0)
    jres, _ = jacc.diag_rescal(jnp.asarray(g), jnp.asarray(zero), 1e-4, 0.0)
    np.testing.assert_allclose(tnew.numpy(), g * g, rtol=RTOL)
    assert np.all(np.abs(tres.numpy()) < 1.0)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=RTOL,
                               atol=ATOL)
