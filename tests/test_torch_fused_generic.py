"""The torch port's generic per-step epoch layout against the JAX package's.

The generic layout (``FusedTrainer.epoch(aligned=False)``, any epoch of
``B % upd_freq != 0`` batches, any epoch that starts mid-round) runs the
boundary after every step that ends a round, on the cyclic window of the
last ``upd_freq`` minibatches.  The same small multinomial problem as
``test_torch_fused_sqn.py`` (12 features, 5 classes, batches of 4, m = 3,
L = 4) goes through both packages from the same numpy data.

Tolerances:

* generic against chunked on an aligned epoch, inside the port: the same
  ops in the same order, so bit for bit;
* the port against the JAX package: float64 on both sides, where the
  two sum in their own orders over a few dozen steps: rtol 1e-9 (as the
  float64 cases of ``test_torch_fused_sqn.py``), atol 1e-12 for entries
  that cancel to near zero.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core.config import AdaQNConfig as JaxAdaQNConfig  # noqa: E402
from stochqn_tpu.core.config import SQNConfig as JaxSQNConfig  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               SQNConfig, adaqn_state_to_numpy,
                               sqn_state_to_numpy)
from stochqn_tpu_torch.models import losses as tl  # noqa: E402
from test_torch_fused_layouts import assert_same_bits  # noqa: E402

F, C, BS, M, L, REG, ETA = 12, 5, 4, 3, 4, 0.1, 0.05
RTOL, ATOL = 1e-9, 1e-12


def _data(nb, dtype=np.float64, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((nb, BS, F)).astype(dtype)
    Y = np.eye(C, dtype=dtype)[rng.integers(0, C, (nb, BS))]
    x0 = (0.1 * rng.standard_normal((F + 1) * C)).astype(dtype)
    return X, Y, x0


def _jgrad(x, b):
    return jl.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _jobj(x, b):
    return jl.multinomial_logistic_loss(x, b[0], b[1], None, REG)


def _jhv(x, v, b):
    return jl.multinomial_logistic_hessvec(x, v, b[0], b[1], None, REG)


def _tgrad(x, b):
    return tl.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _tobj(x, b):
    return tl.multinomial_logistic_loss(x, b[0], b[1], None, REG)


def _thv(x, v, b):
    return tl.multinomial_logistic_hessvec(x, v, b[0], b[1], None, REG)


# (optimizer, config kwargs, closed-form Hessian-vector product)
CASES = {
    "sqn_jvp": ("SQN", {}, False),
    "sqn_hess_vec_fn": ("SQN", {}, True),
    "sqn_grad_diff": ("SQN", {"use_grad_diff": True}, False),
    "adaqn_max_incr": ("adaQN", {"fisher_size": 6, "max_incr": 1.01}, False),
    "adaqn_no_guard": ("adaQN", {"fisher_size": 6, "max_incr": None}, False),
    "adaqn_grad_diff": ("adaQN", {"use_grad_diff": True, "max_incr": 1.01},
                        False),
}


def _trainers(case):
    kind, kw, closed = CASES[case]
    if kind == "SQN":
        jtr = JaxTrainer("SQN", JaxSQNConfig.create(
            mem_size=M, bfgs_upd_freq=L, **kw), _jgrad,
            hess_vec_fn=_jhv if closed else None)
        ttr = FusedTrainer("SQN", SQNConfig.create(
            mem_size=M, bfgs_upd_freq=L, **kw), _tgrad,
            hess_vec_fn=_thv if closed else None)
    else:
        jtr = JaxTrainer("adaQN", JaxAdaQNConfig.create(
            mem_size=M, bfgs_upd_freq=L, **kw), _jgrad, obj_fn=_jobj)
        ttr = FusedTrainer("adaQN", AdaQNConfig.create(
            mem_size=M, bfgs_upd_freq=L, **kw), _tgrad, obj_fn=_tobj)
    return jtr, ttr


def _jax_numpy(obj):
    return {f.name: (_jax_numpy(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _to_numpy(tstate):
    return (sqn_state_to_numpy(tstate) if hasattr(tstate, "mem")
            and not hasattr(tstate, "fisher")
            else adaqn_state_to_numpy(tstate))


def _assert_close(got, want, prefix=""):
    for name, ref in want.items():
        if isinstance(ref, dict):
            _assert_close(got[name], ref, f"{prefix}{name}.")
        else:
            np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                       np.asarray(ref, np.float64),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=prefix + name)


def _assert_state_close(tstate, jstate):
    _assert_close(_to_numpy(tstate), _jax_numpy(jstate))


def _tdata(X, Y):
    return torch.from_numpy(X), torch.from_numpy(Y)


def _jdata(X, Y):
    return jnp.asarray(X), jnp.asarray(Y)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generic_equals_chunked_bit_for_bit(case, dtype):
    """On aligned epochs (B % L == 0, fresh state) the generic layout runs
    the chunked layout's ops in the same order: the same bits."""
    X, Y, x0 = _data(8, dtype)
    _, ttr = _trainers(case)
    runs = {}
    for aligned in (True, False):
        st = ttr.init(torch.from_numpy(x0))
        runs[aligned] = ttr.epochs(st, _tdata(X, Y), ETA, nepochs=2,
                                   aligned=aligned)
    (sc, ic), (sg, ig) = runs[True], runs[False]
    assert torch.equal(ic, ig)
    assert_same_bits(sc, sg)
    assert int(sg.niter) == 16


@pytest.mark.parametrize("case", sorted(CASES))
def test_misaligned_epochs_match_jax(case):
    """B = 10, L = 4: the window of the boundary after step 1 of the
    second round of each epoch wraps into batches 8, 9, 0, 1; the second
    epoch starts 2 steps into a round.  Two epochs on both sides."""
    X, Y, x0 = _data(10)
    jtr, ttr = _trainers(case)
    ep = jax.jit(jtr.epoch, static_argnames=("aligned",))
    jst, jinfos = jtr.init(jnp.asarray(x0)), []
    for _ in range(2):
        jst, info = ep(jst, _jdata(X, Y), ETA, aligned=False)
        jinfos.append(np.asarray(info))
    tst, tinfos = ttr.epochs(ttr.init(torch.from_numpy(x0)), _tdata(X, Y),
                             ETA, nepochs=2)
    assert tinfos.shape == (2, 10) and tinfos.dtype == torch.int32
    np.testing.assert_array_equal(tinfos.numpy(), np.stack(jinfos))
    assert int(tst.mem.count) == int(jst.mem.count)
    _assert_state_close(tst, jst)


@pytest.mark.parametrize("case", ["sqn_jvp", "sqn_hess_vec_fn",
                                  "adaqn_max_incr"])
def test_mid_round_resume_matches_jax(case):
    """Two batches (niter = 2, mid-round), then a full epoch: the port's
    ``epoch`` with ``aligned=None`` reads niter once and takes the generic
    layout; the JAX package's jitted auto dispatch does the same under
    ``lax.cond``.  The chunked layout forced onto this state must differ
    (the dispatch matters)."""
    X, Y, x0 = _data(8)
    jtr, ttr = _trainers(case)
    jst, _ = jtr.epoch(jtr.init(jnp.asarray(x0)), _jdata(X[:2], Y[:2]), ETA)
    jst, jinfo = jax.jit(jtr.epoch)(jst, _jdata(X, Y), ETA)

    def resumed():
        st, _ = ttr.epoch(ttr.init(torch.from_numpy(x0)),
                          _tdata(X[:2], Y[:2]), ETA)
        assert int(st.niter) == 2
        return st
    tst, tinfo = ttr.epoch(resumed(), _tdata(X, Y), ETA)
    np.testing.assert_array_equal(tinfo.numpy(), np.asarray(jinfo))
    _assert_state_close(tst, jst)
    wrong, _ = ttr.epoch(resumed(), _tdata(X, Y), ETA, aligned=True)
    assert not np.allclose(wrong.x.numpy(), tst.x.numpy(), rtol=1e-6)


@pytest.mark.parametrize("case", ["sqn_jvp", "adaqn_max_incr"])
def test_epochs_resume_mid_round_like_run_epochs(case):
    """``epochs`` from a mid-round state resolves the start once and
    advances its host count by B per epoch; the JAX ``run_epochs`` does
    the same."""
    X, Y, x0 = _data(8)
    jtr, ttr = _trainers(case)
    jst, _ = jtr.epoch(jtr.init(jnp.asarray(x0)), _jdata(X[:3], Y[:3]), ETA)
    jst, jinfos = jtr.run_epochs(jst, _jdata(X, Y), 2, ETA)
    tst, _ = ttr.epoch(ttr.init(torch.from_numpy(x0)), _tdata(X[:3], Y[:3]),
                       ETA)
    tst, tinfos = ttr.epochs(tst, _tdata(X, Y), ETA, nepochs=2)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert int(tst.niter) == int(jst.niter) == 19
    _assert_state_close(tst, jst)


def test_aligned_fresh_state_still_chunked():
    """``aligned=None`` on a fresh aligned state reads niter and takes the
    chunked layout: the same bits as ``aligned=True``."""
    X, Y, x0 = _data(8, np.float32)
    _, ttr = _trainers("sqn_jvp")
    sa, ia = ttr.epoch(ttr.init(torch.from_numpy(x0)), _tdata(X, Y), ETA)
    sc, ic = ttr.epoch(ttr.init(torch.from_numpy(x0)), _tdata(X, Y), ETA,
                       aligned=True)
    assert torch.equal(ia, ic)
    assert_same_bits(sa, sc)


def test_generic_val_data_guard_matches_jax():
    """adaQN's function-value guard on ``val_data`` instead of the cyclic
    window, on a misaligned epoch."""
    X, Y, x0 = _data(10)
    Xv, Yv, _ = _data(1, seed=5)
    kind, kw, _ = CASES["adaqn_max_incr"]
    jtr = JaxTrainer("adaQN", JaxAdaQNConfig.create(
        mem_size=M, bfgs_upd_freq=L, **kw), _jgrad, obj_fn=_jobj,
        val_data=_jdata(Xv[0], Yv[0]))
    ttr = FusedTrainer("adaQN", AdaQNConfig.create(
        mem_size=M, bfgs_upd_freq=L, **kw), _tgrad, obj_fn=_tobj,
        val_data=_tdata(Xv[0], Yv[0]))
    jst, jinfo = jax.jit(jtr.epoch, static_argnames=("aligned",))(
        jtr.init(jnp.asarray(x0)), _jdata(X, Y), ETA, aligned=False)
    tst, tinfo = ttr.epoch(ttr.init(torch.from_numpy(x0)), _tdata(X, Y), ETA,
                           aligned=False)
    np.testing.assert_array_equal(tinfo.numpy(), np.asarray(jinfo))
    _assert_state_close(tst, jst)


def test_epoch_shorter_than_a_round():
    """B < L: the window is the whole epoch (``min(L, B)`` batches) and
    boundaries land across epochs."""
    X, Y, x0 = _data(3)
    jtr, ttr = _trainers("sqn_jvp")
    jst, jinfos = jtr.init(jnp.asarray(x0)), []
    for _ in range(3):
        jst, info = jtr.epoch(jst, _jdata(X, Y), ETA, aligned=False)
        jinfos.append(np.asarray(info))
    tst, tinfos = ttr.epochs(ttr.init(torch.from_numpy(x0)), _tdata(X, Y),
                             ETA, nepochs=3, aligned=False)
    np.testing.assert_array_equal(tinfos.numpy(), np.stack(jinfos))
    _assert_state_close(tst, jst)
