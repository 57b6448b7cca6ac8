"""The torch port's Fisher ring and empirical-Fisher ``y`` against the JAX
package.

``append`` runs in both modes from the same gate: shift (rebuild, newest
row first) and ring (one row written in place at ``head``), the latter
forced at small n and run past ``fisher_size`` so that the ring wraps.
Appends copy values, so the rings must match exactly; ``fisher_y`` sums
in float32 in each framework's order (rtol 2e-5, atol 1e-6).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core import state as jstate  # noqa: E402
from stochqn_tpu.ops.pairs import fisher_y as jax_fisher_y  # noqa: E402
from stochqn_tpu_torch.convert import (fisher_memory_from_numpy,  # noqa: E402
                                       fisher_memory_to_numpy)
from stochqn_tpu_torch.core import state as tstate  # noqa: E402
from stochqn_tpu_torch.ops.pairs import fisher_y  # noqa: E402

RTOL, ATOL = 2e-5, 1e-6
FS, N = 4, 37


def _jax_fields(fisher):
    return {f.name: np.asarray(getattr(fisher, f.name))
            for f in dataclasses.fields(fisher)}


def _assert_fisher_equal(tf, jf):
    got, want = fisher_memory_to_numpy(tf), _jax_fields(jf)
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_array_equal(got[name], ref, err_msg=name)


def _grads(k, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, N)).astype(np.float32)


@pytest.mark.parametrize("shift", [True, False], ids=["shift", "ring"])
def test_append_matches_jax(shift):
    jf = jstate.FisherMemory.create(FS, N, jnp.float32, shift=shift)
    tf = tstate.FisherMemory.create(FS, N, torch.float32, shift=shift)
    _assert_fisher_equal(tf, jf)
    for g in _grads(FS + 3):            # 3 past fisher_size: wraps
        jf = jf.append(jnp.asarray(g))
        tf = tf.append(torch.from_numpy(g))
        _assert_fisher_equal(tf, jf)
    assert int(tf.count) == FS and int(tf.head) == (FS + 3) % FS


@pytest.mark.parametrize("k,pre", [(2, 0), (4, 3), (6, 1), (9, 2)])
@pytest.mark.parametrize("shift", [True, False], ids=["shift", "ring"])
def test_append_block_matches_jax(shift, k, pre):
    """``append_block(g[k])`` after ``pre`` single appends: the JAX
    package's ``append_block`` and the port's ``k`` successive
    ``append`` calls, exactly (partial fills, and k past fisher_size)."""
    pre_grads, grads = _grads(pre, seed=10 + pre), _grads(k, seed=20 + k)
    jf = jstate.FisherMemory.create(FS, N, jnp.float32, shift=shift)
    tf = tstate.FisherMemory.create(FS, N, torch.float32, shift=shift)
    seq = tstate.FisherMemory.create(FS, N, torch.float32, shift=shift)
    for g in pre_grads:
        jf, tf = jf.append(jnp.asarray(g)), tf.append(torch.from_numpy(g))
        seq = seq.append(torch.from_numpy(g))
    for g in grads:
        seq = seq.append(torch.from_numpy(g))
    jf = jf.append_block(jnp.asarray(grads))
    tf = tf.append_block(torch.from_numpy(grads))
    _assert_fisher_equal(tf, jf)
    _assert_fisher_equal(seq, jf)


def test_ring_append_block_writes_in_place():
    tf = tstate.FisherMemory.create(FS, N, torch.float32, shift=False)
    buf = tf.f
    out = tf.append_block(torch.ones(2, N))
    assert out.f is buf and bool((buf[:2] == 1).all())


def test_ring_append_writes_in_place():
    tf = tstate.FisherMemory.create(FS, N, torch.float32, shift=False)
    buf = tf.f
    out = tf.append(torch.ones(N))
    assert out.f is buf and bool((buf[0] == 1).all())


@pytest.mark.parametrize("fisher_size,n,shift", [
    (4, N, True), (100, 292_083, False), (4, 292_083, True)])
def test_shift_gate_matches_jax(fisher_size, n, shift):
    """The append mode follows FISHER_SHIFT_MAX_BYTES on both sides; the
    flagship fisher_size=100 buffer (117 MB) takes the ring."""
    assert tstate.FISHER_SHIFT_MAX_BYTES == jstate.FISHER_SHIFT_MAX_BYTES
    jf = jax.eval_shape(lambda: jstate.FisherMemory.create(fisher_size, n))
    tf = tstate.FisherMemory.create(fisher_size, n, device="meta")
    assert tf.shift == jf.shift == shift


def test_flush_matches_jax():
    jf = jstate.FisherMemory.create(FS, N, jnp.float32)
    for g in _grads(3):
        jf = jf.append(jnp.asarray(g))
    tf = fisher_memory_from_numpy(_jax_fields(jf), device="cpu")
    jf, tf2 = jf.flush(), tf.flush()
    _assert_fisher_equal(tf2, jf)
    assert int(tf2.count) == 0 and tf2.f is tf.f   # rows stay, count goes


@pytest.mark.parametrize("n_appends,flush", [(0, False), (2, False),
                                             (4, False), (6, False),
                                             (3, True)],
                         ids=["empty", "partial", "full", "wrapped",
                              "flushed_then_one"])
@pytest.mark.parametrize("shift", [True, False], ids=["shift", "ring"])
def test_fisher_y_matches_jax(n_appends, flush, shift):
    """Rows at or past ``count`` are masked: a partial ring, and a ring
    flushed and refilled by one row over stale ones."""
    jf = jstate.FisherMemory.create(FS, N, jnp.float32, shift=shift)
    tf = tstate.FisherMemory.create(FS, N, torch.float32, shift=shift)
    grads = _grads(n_appends + 1, seed=n_appends)
    for g in grads[:n_appends]:
        jf, tf = jf.append(jnp.asarray(g)), tf.append(torch.from_numpy(g))
    if flush:
        jf, tf = jf.flush(), tf.flush()
        jf = jf.append(jnp.asarray(grads[-1]))
        tf = tf.append(torch.from_numpy(grads[-1]))
    s = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    want = np.asarray(jax_fisher_y(jf, jnp.asarray(s)))
    got = fisher_y(tf, torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if n_appends == 0:
        assert not got.any()
