"""The torch port's fused SQN engine against the JAX package's ``jit_epochs``.

A small BibTeX-like multinomial problem (12 features, 5 classes, batches
of 4, 8 batches per epoch, m = 3, L = 4) runs on both sides from the same
numpy data, and the whole state after the run must agree: ``x``,
``x_sum``, ``x_avg_prev``, ``grad_prev``, the ring with its caches, and
the info codes.

Tolerance: 16 optimizer steps in float32, where each side sums in its own
order; quasi-Newton steps amplify those ulp-level differences somewhat,
and the cached inverses and c0/cg products more (rtol 1e-4, atol 2e-5).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core.config import SQNConfig as JaxConfig  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu_torch import (FusedTrainer, SQNConfig, Info,  # noqa: E402
                               sqn_state_from_numpy, sqn_state_to_numpy)
from stochqn_tpu_torch.models import losses as tl  # noqa: E402

F, C, BS, B, M, L, REG, ETA = 12, 5, 4, 8, 3, 4, 0.1, 0.05
RTOL, ATOL = 1e-4, 2e-5


def _data():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((B, BS, F)).astype(np.float32)
    Y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, BS))]
    x0 = (0.1 * rng.standard_normal((F + 1) * C)).astype(np.float32)
    return X, Y, x0


def _jax_grad(x, batch):
    return jl.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def _jax_hess_vec(x, v, batch):
    return jl.multinomial_logistic_hessvec(x, v, batch[0], batch[1], None,
                                           REG)


def _torch_grad(x, batch):
    return tl.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def _torch_hess_vec(x, v, batch):
    return tl.multinomial_logistic_hessvec(x, v, batch[0], batch[1], None,
                                           REG)


def _trainers(hvp, cfg_kw):
    jtr = JaxTrainer("SQN", JaxConfig.create(mem_size=M, bfgs_upd_freq=L,
                                             **cfg_kw), _jax_grad,
                     hess_vec_fn=_jax_hess_vec if hvp == "closed" else None)
    ttr = FusedTrainer("SQN", SQNConfig.create(mem_size=M, bfgs_upd_freq=L,
                                               **cfg_kw), _torch_grad,
                       hess_vec_fn=_torch_hess_vec if hvp == "closed"
                       else None)
    return jtr, ttr


def _jax_numpy(state):
    def conv(obj):
        return {f.name: (conv(getattr(obj, f.name))
                         if dataclasses.is_dataclass(getattr(obj, f.name))
                         else np.asarray(getattr(obj, f.name)))
                for f in dataclasses.fields(obj)}
    return conv(state)


def _assert_state_close(tstate, jstate):
    got, want = sqn_state_to_numpy(tstate), _jax_numpy(jstate)
    for name in ("x", "x_sum", "x_avg_prev", "grad_prev", "niter",
                 "section"):
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name, ref in want["mem"].items():
        np.testing.assert_allclose(got["mem"][name], ref, rtol=RTOL,
                                   atol=ATOL, err_msg=f"mem.{name}")


def _run_jax(jtr, state, X, Y, etas):
    return jtr.jit_epochs()(state, (jnp.asarray(X), jnp.asarray(Y)),
                            jnp.asarray(etas, jnp.float32),
                            nepochs=len(etas))


def _run_torch(ttr, state, X, Y, etas):
    return ttr.epochs(state, (torch.from_numpy(X), torch.from_numpy(Y)),
                      torch.tensor(etas, dtype=torch.float32),
                      nepochs=len(etas))


@pytest.mark.parametrize("hvp,cfg_kw", [
    ("jvp", {}),
    ("closed", {}),
    ("jvp", {"use_grad_diff": True}),
], ids=["jvp_hvp", "closed_form_hvp", "grad_diff"])
def test_two_epochs_match_jax(hvp, cfg_kw):
    X, Y, x0 = _data()
    jtr, ttr = _trainers(hvp, cfg_kw)
    jst, jinfos = _run_jax(jtr, jtr.init(jnp.asarray(x0)), X, Y, [ETA] * 2)
    tst, tinfos = _run_torch(ttr, ttr.init(torch.from_numpy(x0)), X, Y,
                             [ETA] * 2)
    assert tinfos.dtype == torch.int32 and tinfos.shape == (2, B)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert int(tst.mem.count) == int(jst.mem.count) > 0
    _assert_state_close(tst, jst)


def test_carry_over_from_jax_state():
    """One epoch in JAX, the state moved across, one more epoch on both
    sides."""
    X, Y, x0 = _data()
    jtr, ttr = _trainers("jvp", {})
    jst, _ = _run_jax(jtr, jtr.init(jnp.asarray(x0)), X, Y, [ETA])
    tst = sqn_state_from_numpy(_jax_numpy(jst))
    _assert_state_close(tst, jst)
    jst, jinfos = _run_jax(jtr, jst, X, Y, [ETA])
    tst, tinfos = _run_torch(ttr, tst, X, Y, [ETA])
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    _assert_state_close(tst, jst)


def test_numpy_round_trip_is_exact():
    X, Y, x0 = _data()
    _, ttr = _trainers("jvp", {})
    tst, _ = _run_torch(ttr, ttr.init(torch.from_numpy(x0)), X, Y, [ETA])
    d = sqn_state_to_numpy(tst)
    back = sqn_state_to_numpy(sqn_state_from_numpy(d))
    for name in ("x", "x_sum", "niter"):
        np.testing.assert_array_equal(back[name], d[name])
    for name in d["mem"]:
        np.testing.assert_array_equal(back["mem"][name], d["mem"][name])
    assert d["mem"]["perm"].dtype == np.int32


def test_nan_step_flushes_on_both_sides():
    """A normal epoch fills the ring; then a huge step overflows x, the
    next direction is NaN, and both sides report
    SEARCH_DIRECTION_WAS_NAN and flush the ring."""
    X, Y, x0 = _data()
    jtr, ttr = _trainers("jvp", {})
    etas = [ETA, 1e38]
    jst, jinfos = _run_jax(jtr, jtr.init(jnp.asarray(x0)), X, Y, etas)
    tst, tinfos = _run_torch(ttr, ttr.init(torch.from_numpy(x0)), X, Y,
                             etas)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert (tinfos[1] == int(Info.SEARCH_DIRECTION_WAS_NAN)).any()
    assert int(tst.mem.count) == int(jst.mem.count) == 0
    _assert_state_close(tst, jst)


def test_unaligned_layouts_raise():
    X, Y, x0 = _data()
    _, ttr = _trainers("jvp", {})
    state = ttr.init(torch.from_numpy(x0))
    data = (torch.from_numpy(X[:6]), torch.from_numpy(Y[:6]))   # 6 % 4 != 0
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        ttr.epochs(state, data, ETA, nepochs=1)
    mid_round = dataclasses.replace(state, niter=torch.tensor(2))
    full = (torch.from_numpy(X), torch.from_numpy(Y))
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        ttr.epochs(mid_round, full, ETA, nepochs=1)


@pytest.mark.parametrize("optimizer", ["oLBFGS", "adaQN"])
def test_unported_optimizers_raise(optimizer):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FusedTrainer(optimizer, SQNConfig(), _torch_grad)
