"""The torch port's pair commit, NaN guard and flush against the JAX package.

Both sides get the same float32 inputs, made with numpy.  Tolerance: the
two frameworks sum the n-length dot products and the small m x m products
in different orders, so float32 results agree to a few ulps of the
largest term, amplified a little by the Neumann inverses and the c0/cg
products (rtol 2e-5, atol 1e-6 on values of order 1-40).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core.state import BFGSMemory as JaxMemory  # noqa: E402
from stochqn_tpu.ops import pairs as jpairs  # noqa: E402
from stochqn_tpu_torch.convert import (bfgs_memory_from_numpy,  # noqa: E402
                                       bfgs_memory_to_numpy)
from stochqn_tpu_torch.core.state import BFGSMemory  # noqa: E402
from stochqn_tpu_torch.ops import pairs  # noqa: E402

RTOL, ATOL = 2e-5, 1e-6
M, N = 4, 37


def _jax_fields(mem):
    return {f.name: np.asarray(getattr(mem, f.name))
            for f in dataclasses.fields(mem)}


def _assert_mem_close(tmem, jmem):
    got = bfgs_memory_to_numpy(tmem)
    want = _jax_fields(jmem)
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _pair(rng, kind):
    s = rng.standard_normal(N).astype(np.float32)
    if kind == "reject":                       # negative curvature
        y = -s
    else:
        y = (s + 0.3 * rng.standard_normal(N)).astype(np.float32)
    return s, y.astype(np.float32)


# 6 accepted commits overfill the m=4 ring (head wraps), with a curvature
# rejection and an enabled=False veto in between.
SEQUENCE = ["ok", "ok", "reject", "ok", "veto", "ok", "ok", "ok"]


@pytest.mark.parametrize("y_reg", [0.0, 0.1])
def test_commit_sequence_matches_jax(y_reg):
    rng = np.random.default_rng(7)
    jmem = JaxMemory.create(M, N, jnp.float32)
    tmem = BFGSMemory.create(M, N, torch.float32)
    _assert_mem_close(tmem, jmem)
    n_accepted = 0
    for kind in SEQUENCE:
        s, y = _pair(rng, kind)
        enabled = kind != "veto"
        jmem, jacc = jpairs.commit_pair(
            jmem.replace(s_pending=jnp.asarray(s)), jnp.asarray(y), 1e-4,
            y_reg, enabled=jnp.asarray(enabled), direction_cache=True)
        tmem, tacc = pairs.commit_pair(
            tmem.replace(s_pending=torch.from_numpy(s)), torch.from_numpy(y),
            1e-4, y_reg, enabled=torch.tensor(enabled), direction_cache=True)
        assert bool(tacc) == bool(jacc) == (kind == "ok")
        n_accepted += kind == "ok"
        _assert_mem_close(tmem, jmem)
    assert int(tmem.count) == M and n_accepted == 6
    assert int(tmem.head) == 6 % M


def test_commit_without_direction_cache_zeroes_c0_cg():
    rng = np.random.default_rng(3)
    tmem = BFGSMemory.create(M, N, torch.float32)
    jmem = JaxMemory.create(M, N, jnp.float32)
    for _ in range(2):
        s, y = _pair(rng, "ok")
        jmem, _ = jpairs.commit_pair(jmem.replace(s_pending=jnp.asarray(s)),
                                     jnp.asarray(y), 1e-4, 0.0)
        tmem, _ = pairs.commit_pair(
            tmem.replace(s_pending=torch.from_numpy(s)), torch.from_numpy(y),
            1e-4, 0.0)
    _assert_mem_close(tmem, jmem)
    assert not tmem.c0.any() and not tmem.cg.any()


def test_zero_over_zero_curvature_rejects():
    """s == 0 gives curvature 0/0 = NaN, which rejects on both sides
    (the C reference would accept)."""
    zeros = np.zeros(N, np.float32)
    tmem = BFGSMemory.create(M, N, torch.float32).replace(
        s_pending=torch.from_numpy(zeros))
    _, tacc = pairs.commit_pair(tmem, torch.from_numpy(zeros), 1e-4, 0.0)
    jmem = JaxMemory.create(M, N, jnp.float32).replace(
        s_pending=jnp.asarray(zeros))
    _, jacc = jpairs.commit_pair(jmem, jnp.asarray(zeros), 1e-4, 0.0)
    assert not bool(tacc) and not bool(jacc)


@pytest.mark.parametrize("case", ["finite", "nan", "inf", "huge",
                                  "large_but_ok"])
def test_direction_is_bad_matches_jax(case):
    d = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    if case == "nan":
        d[3] = np.nan
    elif case == "inf":
        d[0] = -np.inf
    elif case == "huge":
        d[1] = 2e3 * N                      # norm > 1e3 * n
    elif case == "large_but_ok":
        d[2] = 0.9e3 * N                    # norm just under 1e3 * n
    got = bool(pairs.direction_is_bad(torch.from_numpy(d)))
    want = bool(jpairs.direction_is_bad(jnp.asarray(d)))
    assert got == want == (case in ("nan", "inf", "huge"))


@pytest.mark.parametrize("pred", [False, True])
def test_conditional_flush_matches_jax(pred):
    rng = np.random.default_rng(11)
    jmem = JaxMemory.create(M, N, jnp.float32)
    for _ in range(3):
        s, y = _pair(rng, "ok")
        jmem, _ = jpairs.commit_pair(jmem.replace(s_pending=jnp.asarray(s)),
                                     jnp.asarray(y), 1e-4, 0.0,
                                     direction_cache=True)
    tmem = bfgs_memory_from_numpy(_jax_fields(jmem))
    jout = jpairs.conditional_flush(jmem, jnp.asarray(pred))
    tout = pairs.conditional_flush(tmem, torch.tensor(pred))
    _assert_mem_close(tout, jout)
    assert int(tout.count) == (0 if pred else 3)
    # only the indices change: the pair rows and caches are the same tensors
    assert tout.s is tmem.s and tout.c0 is tmem.c0
