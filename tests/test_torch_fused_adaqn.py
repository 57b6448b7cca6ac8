"""The torch port's fused adaQN engine against the JAX package's
``jit_epochs``.

A small BibTeX-like multinomial problem (12 features, 5 classes, batches
of 4, 8 batches per epoch, m = 3, L = 4, fisher_size = 10) runs on both
sides from the same numpy data, and the whole state after the run must
agree: ``x``, the averages, the accumulator, ``f_prev``, the pair ring
with its caches, the Fisher ring with its append mode, and the info codes.

The port's ``use_pallas=True`` route (the projection kernel on CUDA, its
plain version here) is held against the JAX package's ``coupling="gram"``,
the same math in XLA: the JAX Pallas kernel itself runs on a TPU or in
interpret mode only, and ``tests/test_torch_project_adaqn_kernel.py``
holds the two kernels' plain versions together.

Tolerance: 16 optimizer steps in float32, each side summing in its own
order; quasi-Newton steps amplify those ulp-level differences somewhat,
and the cached inverses more (rtol 1e-4, atol 2e-5, as for SQN).  The
float64 cases run the same program in float64 and hold the two to rtol
1e-9.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core.config import AdaQNConfig as JaxConfig  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer, Info,  # noqa: E402
                               adaqn_state_from_numpy, adaqn_state_to_numpy)
from stochqn_tpu_torch.core.state import AdaQNState  # noqa: E402
from stochqn_tpu_torch.models import losses as tl  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402

F, C, BS, B, M, FS, L, REG, ETA = 12, 5, 4, 8, 3, 10, 4, 0.1, 0.1
RTOL, ATOL = 1e-4, 2e-5
_FINC = int(Info.FUNC_INCREASED)


def _data(seed=2):
    """Labels from a linear model, so that the loss falls and the guard
    accepts most boundaries."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, BS, F)).astype(np.float32)
    Y = np.eye(C, dtype=np.float32)[np.argmax(
        X @ rng.standard_normal((F, C)), axis=-1)]
    x0 = (0.1 * rng.standard_normal((F + 1) * C)).astype(np.float32)
    return X, Y, x0


def _jax_grad(x, batch):
    return jl.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def _jax_obj(x, batch):
    return jl.multinomial_logistic_loss(x, batch[0], batch[1], None, REG)


def _torch_grad(x, batch):
    return tl.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def _torch_obj(x, batch):
    return tl.multinomial_logistic_loss(x, batch[0], batch[1], None, REG)


def _configs(cfg_kw):
    kw = dict(mem_size=M, fisher_size=FS, bfgs_upd_freq=L, **cfg_kw)
    jkw = dict(kw)
    if jkw.pop("use_pallas", None):
        jkw["coupling"] = "gram"        # the kernel route's math, in XLA
    return JaxConfig.create(**jkw), AdaQNConfig.create(**kw)


def _trainers(cfg_kw, jax_obj=_jax_obj, torch_obj=_torch_obj, val=None):
    jcfg, tcfg = _configs(cfg_kw)
    jtr = JaxTrainer("adaQN", jcfg, _jax_grad, obj_fn=jax_obj,
                     val_data=None if val is None
                     else tuple(jnp.asarray(a) for a in val))
    ttr = FusedTrainer("adaQN", tcfg, _torch_grad, obj_fn=torch_obj,
                       val_data=None if val is None
                       else tuple(torch.from_numpy(a) for a in val))
    return jtr, ttr


def _jax_numpy(state):
    def conv(obj):
        return {f.name: (conv(getattr(obj, f.name))
                         if dataclasses.is_dataclass(getattr(obj, f.name))
                         else np.asarray(getattr(obj, f.name)))
                for f in dataclasses.fields(obj)}
    return conv(state)


def _assert_state_close(tstate, jstate):
    got, want = adaqn_state_to_numpy(tstate), _jax_numpy(jstate)
    assert set(got) == set(want)
    for name in ("x", "x_sum", "x_avg_prev", "grad_prev", "grad_sum_sq",
                 "f_prev", "niter", "section"):
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for sub in ("mem", "fisher"):
        assert set(got[sub]) == set(want[sub])
        for name, ref in want[sub].items():
            np.testing.assert_allclose(got[sub][name], ref, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{sub}.{name}")


def _run_jax(jtr, state, X, Y, etas):
    return jtr.jit_epochs()(state, (jnp.asarray(X), jnp.asarray(Y)),
                            jnp.asarray(etas, jnp.float32),
                            nepochs=len(etas))


def _run_torch(ttr, state, X, Y, etas):
    return ttr.epochs(state, (torch.from_numpy(X), torch.from_numpy(Y)),
                      torch.tensor(etas, dtype=torch.float32),
                      nepochs=len(etas))


def _run_both(jtr, ttr, etas, data=None):
    X, Y, x0 = data if data is not None else _data()
    jst, jinfos = _run_jax(jtr, jtr.init(jnp.asarray(x0)), X, Y, etas)
    tst, tinfos = _run_torch(ttr, ttr.init(torch.from_numpy(x0)), X, Y,
                             etas)
    assert tinfos.dtype == torch.int32 and tinfos.shape == (len(etas), B)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    _assert_state_close(tst, jst)
    return tst, tinfos


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"max_incr": None},
    {"use_grad_diff": True},
    {"use_grad_diff": True, "max_incr": None},
    {"rmsprop_weight": 0.9},
    {"h0_exact_reference": False},
    {"coupling": "gram"},
    {"use_pallas": True},
    {"use_pallas": True, "rmsprop_weight": 0.9},
], ids=["fisher", "fisher_no_guard", "grad_diff", "grad_diff_no_guard",
        "rmsprop", "paper_h0", "gram", "kernel_route", "kernel_rmsprop"])
def test_two_epochs_match_jax(cfg_kw):
    jtr, ttr = _trainers(cfg_kw)
    launches = tlk.PROJECT_ADAQN_LAUNCHES
    tst, tinfos = _run_both(jtr, ttr, [ETA] * 2)
    # a later boundary committed a pair, so the two-loop ran on pairs
    assert (tinfos.flatten()[2 * L - 1::L] == 200).any()
    assert tlk.PROJECT_ADAQN_LAUNCHES == launches   # CPU: plain versions
    assert tst.fisher.shift                 # small buffer: shift append


def test_val_data_guard_matches_jax():
    rng = np.random.default_rng(5)
    val = (rng.standard_normal((6, F)).astype(np.float32),
           np.eye(C, dtype=np.float32)[rng.integers(0, C, 6)])
    jtr, ttr = _trainers({}, val=val)
    _run_both(jtr, ttr, [ETA] * 2)


def test_func_increased_matches_jax():
    """An objective that spikes once the loss falls below a threshold
    makes the guard reject (func_increased) on both sides, flushing both
    memories and reverting x.  The threshold is calibrated between the
    first two boundary values of an unguarded run."""
    X, Y, x0 = _data()
    _, cal = _trainers({"max_incr": 1e6})
    st = cal.init(torch.from_numpy(x0))
    fvals = []
    for _ in range(2):
        st, _ = _run_torch(cal, st, X[:L], Y[:L], [ETA])
        fvals.append(float(st.f_prev))
    assert fvals[1] < fvals[0], "calibration run did not descend"
    thresh = 0.5 * (fvals[0] + fvals[1])

    def jax_obj(x, batch):
        base = _jax_obj(x, batch)
        return jnp.where(base < thresh, 1e30, base)

    def torch_obj(x, batch):
        base = _torch_obj(x, batch)
        return torch.where(base < thresh, 1e30, base)

    jtr, ttr = _trainers({}, jax_obj, torch_obj)
    _, tinfos = _run_both(jtr, ttr, [ETA] * 2)
    assert (tinfos == _FINC).any(), "no func_increased seen"


def test_nan_direction_matches_jax():
    """A huge step overflows x; the next direction is NaN on both sides:
    the pair ring is flushed, the Fisher ring is not (reference quirk),
    and the guard rejects the non-finite objective."""
    jtr, ttr = _trainers({})
    tst, tinfos = _run_both(jtr, ttr, [ETA, 1e38])
    assert (tinfos[1] == int(Info.SEARCH_DIRECTION_WAS_NAN)).any()
    assert int(tst.mem.count) == 0


def test_ring_mode_fisher_matches_jax():
    """A state converted from JAX with its Fisher ring forced to ring
    (in-place) mode continues as the JAX state does."""
    X, Y, x0 = _data()
    jtr, ttr = _trainers({})
    jst = jtr.init(jnp.asarray(x0))
    jst = jst.replace(fisher=jst.fisher.replace(shift=False))
    jst, _ = _run_jax(jtr, jst, X, Y, [ETA])
    tst = adaqn_state_from_numpy(_jax_numpy(jst), device="cpu")
    assert not tst.fisher.shift
    _assert_state_close(tst, jst)
    jst, jinfos = _run_jax(jtr, jst, X, Y, [ETA])
    tst, tinfos = _run_torch(ttr, tst, X, Y, [ETA])
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    _assert_state_close(tst, jst)


@pytest.mark.parametrize("cfg_kw", [
    {"rmsprop_weight": 0.9},
    {},
    {"use_grad_diff": True},
    {"h0_exact_reference": False},
    {"coupling": "gram"},
], ids=["rmsprop", "fisher", "grad_diff", "paper_h0", "gram"])
def test_float64_trajectory_matches_jax(cfg_kw):
    """The same run in float64, the Fisher ring in ring mode as at the
    BibTeX shape, four epochs: the two packages take the same steps to
    float64 rounding (rtol 1e-9).  A float32 trajectory amplifies its
    roundings too fast for a tolerance this tight, so this is the check
    that the two implement the same algorithm."""
    X, Y, x0 = (a.astype(np.float64) for a in _data())
    etas = [ETA] * 4
    jtr, ttr = _trainers(cfg_kw)
    jst = jtr.init(jnp.asarray(x0))
    jst = jst.replace(fisher=jst.fisher.replace(shift=False))
    jst, jinfos = jtr.jit_epochs()(jst, (jnp.asarray(X), jnp.asarray(Y)),
                                   jnp.asarray(etas), nepochs=len(etas))
    tst = AdaQNState.create(torch.from_numpy(x0), M, FS)
    tst = tst.replace(fisher=tst.fisher.replace(shift=False))
    tst, tinfos = ttr.epochs(tst, (torch.from_numpy(X), torch.from_numpy(Y)),
                             torch.tensor(etas, dtype=torch.float64),
                             nepochs=len(etas))
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert (tinfos.flatten()[2 * L - 1::L] == 200).any()
    got, want = adaqn_state_to_numpy(tst), _jax_numpy(jst)
    assert got["x"].dtype == want["x"].dtype == np.float64
    for name in ("x", "x_avg_prev", "grad_sum_sq", "f_prev"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    for name in ("s", "y", "count", "head"):
        np.testing.assert_allclose(got["mem"][name], want["mem"][name],
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_numpy_round_trip_is_exact():
    X, Y, x0 = _data()
    _, ttr = _trainers({})
    tst, _ = _run_torch(ttr, ttr.init(torch.from_numpy(x0)), X, Y, [ETA])
    d = adaqn_state_to_numpy(tst)
    back = adaqn_state_to_numpy(adaqn_state_from_numpy(d, device="cpu"))
    for name in ("x", "f_prev", "grad_sum_sq", "niter"):
        np.testing.assert_array_equal(back[name], d[name])
    for sub in ("mem", "fisher"):
        for name in d[sub]:
            np.testing.assert_array_equal(back[sub][name], d[sub][name])
    assert d["fisher"]["count"].dtype == np.int32
    assert back["fisher"]["shift"] is True


def test_missing_obj_fn_raises():
    cfg = AdaQNConfig.create(max_incr=1.01)
    with pytest.raises(ValueError, match="objective function"):
        FusedTrainer("adaQN", cfg, _torch_grad)
    # without the guard obj_fn is optional
    FusedTrainer("adaQN", AdaQNConfig.create(max_incr=None), _torch_grad)
    with pytest.raises(TypeError, match="AdaQNConfig"):
        FusedTrainer("adaQN", object(), _torch_grad, obj_fn=_torch_obj)


@pytest.mark.parametrize("kw", [
    dict(mem_size=0), dict(fisher_size=0), dict(rmsprop_weight=1.5),
    dict(scal_reg=0.0), dict(coupling="dense"), dict(max_incr=-1.0)])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig.create(**kw)
    with pytest.raises(ValueError):
        AdaQNConfig.create(**kw)


def test_config_fields_match_jax():
    kw = dict(fisher_size=None, rmsprop_weight=0.5, y_reg=0.1,
              use_pallas=True, coupling="gram", max_incr=None)
    assert (dataclasses.asdict(AdaQNConfig.create(**kw))
            == dataclasses.asdict(JaxConfig.create(**kw)))
