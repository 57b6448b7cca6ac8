"""The torch port's collapsed cached two-loop against the JAX package.

The pair memory is built by the JAX package's own commits and carried
across with ``convert``, so this isolates the direction.  On the CPU the
port's direction kernel wrapper runs its plain PyTorch version.
Tolerance: float32 with different summation orders over n = 300 and the
2m = 8 rows (rtol 3e-5, atol 1e-5 on directions of order 1-10); the
``count == 0`` case must return ``g`` exactly.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core.state import BFGSMemory as JaxMemory  # noqa: E402
from stochqn_tpu.ops.pairs import commit_pair as jax_commit  # noqa: E402
from stochqn_tpu.ops.pairs import conditional_flush as jax_flush  # noqa: E402
from stochqn_tpu.ops.two_loop import two_loop_cached as jax_two_loop  # noqa: E402
from stochqn_tpu_torch.convert import bfgs_memory_from_numpy  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel  # noqa: E402
from stochqn_tpu_torch.ops.two_loop import (_chrono_perm,  # noqa: E402
                                            two_loop_cached)

M, N = 4, 300


def _jax_mem(n_commits, flush=False):
    rng = np.random.default_rng(21)
    mem = JaxMemory.create(M, N, jnp.float32)
    for _ in range(n_commits):
        s = rng.standard_normal(N).astype(np.float32)
        y = (s + 0.3 * rng.standard_normal(N)).astype(np.float32)
        mem, _ = jax_commit(mem.replace(s_pending=jnp.asarray(s)),
                            jnp.asarray(y), 1e-4, 0.0, direction_cache=True)
    if flush:
        mem = jax_flush(mem, jnp.asarray(True))
    return mem


def _to_torch(mem):
    return bfgs_memory_from_numpy({f.name: np.asarray(getattr(mem, f.name))
                                   for f in dataclasses.fields(mem)})


@pytest.mark.parametrize("n_commits", [1, 3, 4, 6])   # 6 overfills the ring
@pytest.mark.parametrize("h0", [0.0, 0.5])
def test_collapsed_matches_jax(n_commits, h0):
    jmem = _jax_mem(n_commits)
    g = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, h0=h0,
                                   collapsed=True))
    launches = two_loop_kernel.LAUNCHES
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem), h0=h0,
                          collapsed=True)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-5)
    assert two_loop_kernel.LAUNCHES == launches   # CPU: plain version only


@pytest.mark.parametrize("flush", [False, True])
def test_empty_memory_returns_gradient(flush):
    """count == 0 returns g, also when a flush left a stale c0/cg behind."""
    jmem = _jax_mem(3 if flush else 0, flush=flush)
    g = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem),
                          collapsed=True)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, collapsed=True))
    np.testing.assert_array_equal(got.numpy(), g)
    np.testing.assert_array_equal(want, g)


@pytest.mark.parametrize("head,count", [(0, 0), (1, 3), (3, 4), (0, 4),
                                        (2, 2)])
def test_chrono_perm_matches_jax(head, count):
    from stochqn_tpu.ops.two_loop import _chrono_perm as jax_perm
    got = _chrono_perm(M, torch.tensor(head), torch.tensor(count))
    want = np.asarray(jax_perm(M, jnp.int32(head), jnp.int32(count)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kwargs", [dict(collapsed=False),
                                    dict(collapsed=True,
                                         diag=torch.ones(N))])
def test_unported_branches_raise(kwargs):
    mem = _to_torch(_jax_mem(2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        two_loop_cached(torch.zeros(N), mem, **kwargs)
