"""The torch port's fused SQN engine against the JAX package's ``jit_epochs``.

A small BibTeX-like multinomial problem (12 features, 5 classes, batches
of 4, 8 batches per epoch, m = 3, L = 4) runs on both sides from the same
numpy data, and the whole state after the run must agree: ``x``,
``x_sum``, ``x_avg_prev``, ``grad_prev``, the ring with its caches, and
the info codes.

Tolerance: 16 optimizer steps in float32, where each side sums in its own
order; quasi-Newton steps amplify those ulp-level differences somewhat,
and the cached inverses and c0/cg products more (rtol 1e-4, atol 2e-5).
The float64 cases run the same program in float64 and hold the two to
rtol 1e-9.
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
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               Info, OLBFGSConfig, SQNConfig,
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


@pytest.mark.parametrize("hvp,cfg_kw", [
    ("jvp", {}),
    ("closed", {}),
    ("jvp", {"use_grad_diff": True}),
], ids=["jvp_hvp", "closed_form_hvp", "grad_diff"])
def test_float64_trajectory_matches_jax(hvp, cfg_kw):
    """The same run in float64, three epochs: the collapsed direction
    takes its plain route (the direction kernels are float32), and the two
    packages take the same steps to float64 rounding (rtol 1e-9)."""
    X, Y, x0 = (a.astype(np.float64) for a in _data())
    etas = [ETA] * 3
    jtr, ttr = _trainers(hvp, cfg_kw)
    jst, jinfos = jtr.jit_epochs()(
        jtr.init(jnp.asarray(x0)), (jnp.asarray(X), jnp.asarray(Y)),
        jnp.asarray(etas, jnp.float64), nepochs=len(etas))
    tst, tinfos = ttr.epochs(
        ttr.init(torch.from_numpy(x0)),
        (torch.from_numpy(X), torch.from_numpy(Y)),
        torch.tensor(etas, dtype=torch.float64), nepochs=len(etas))
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert int(tst.mem.count) == int(jst.mem.count) > 0
    got, want = sqn_state_to_numpy(tst), _jax_numpy(jst)
    assert got["x"].dtype == want["x"].dtype == np.float64
    for name in ("x", "x_sum", "x_avg_prev", "grad_prev"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    for name in ("s", "y", "gram", "gamma", "c0", "cg"):
        np.testing.assert_allclose(got["mem"][name], want["mem"][name],
                                   rtol=1e-8, atol=1e-11,
                                   err_msg=f"mem.{name}")


def test_carry_over_from_jax_state():
    """One epoch in JAX, the state moved across, one more epoch on both
    sides."""
    X, Y, x0 = _data()
    jtr, ttr = _trainers("jvp", {})
    jst, _ = _run_jax(jtr, jtr.init(jnp.asarray(x0)), X, Y, [ETA])
    tst = sqn_state_from_numpy(_jax_numpy(jst), device="cpu")
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
    back = sqn_state_to_numpy(sqn_state_from_numpy(d, device="cpu"))
    for name in ("x", "x_sum", "niter"):
        np.testing.assert_array_equal(back[name], d[name])
    for name in d["mem"]:
        np.testing.assert_array_equal(back["mem"][name], d["mem"][name])
    assert d["mem"]["perm"].dtype == np.int32


def test_convert_with_no_device_means_the_card():
    """``*_from_numpy`` with no device puts the state on the card, as
    every other entry point does: where there is none it raises (it used
    to return CPU tensors)."""
    X, Y, x0 = _data()
    _, ttr = _trainers("jvp", {})
    d = sqn_state_to_numpy(ttr.init(torch.from_numpy(x0)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sqn_state_from_numpy(d)
        return
    assert sqn_state_from_numpy(d).x.device.type == "cuda"


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
    """The layouts the round-chunked path cannot take (6 % 4 != 0, a
    mid-round start) no longer raise: they take the generic per-step
    layout, the one ``aligned=False`` forces (tests/
    test_torch_fused_generic.py holds it against the JAX package).  What
    still raises is a schedule whose rows do not make whole batches."""
    X, Y, x0 = _data()
    _, ttr = _trainers("jvp", {})

    def run(data, niter, aligned):
        state = dataclasses.replace(ttr.init(torch.from_numpy(x0)),
                                    niter=torch.tensor(niter))
        return ttr.epochs(state, data, ETA, nepochs=1, aligned=aligned)
    short = (torch.from_numpy(X[:6]), torch.from_numpy(Y[:6]))   # 6 % 4 != 0
    full = (torch.from_numpy(X), torch.from_numpy(Y))
    for data, niter in ((short, 0), (full, 2)):
        (sa, ia), (sg, ig) = run(data, niter, None), run(data, niter, False)
        assert torch.equal(ia, ig) and torch.equal(sa.x, sg.x)
        assert bool(torch.isfinite(sa.x).all())
    with pytest.raises(ValueError, match="multiple of batch_size"):
        ttr.epochs_scheduled(ttr.init(torch.from_numpy(x0)), full[0][0],
                             ETA, torch.zeros((1, 3), dtype=torch.int64),
                             batch_size=BS)


@pytest.mark.parametrize("optimizer", ["oLBFGS", "adaQN"])
def test_unported_optimizers_raise(optimizer):
    """bfloat16 memories are built (pairs_bf16, fisher_bf16), and so is a
    bfloat16 iterate (its pair rows bfloat16, its Gram float32); a float16
    iterate raises."""
    if optimizer == "oLBFGS":
        trainer = FusedTrainer(optimizer, OLBFGSConfig.create(
            pairs_bf16=True), _torch_grad)
        assert trainer.init(torch.zeros(3)).mem.s.dtype == torch.bfloat16
    else:
        trainer = FusedTrainer(optimizer, AdaQNConfig.create(
            max_incr=None, fisher_bf16=True), _torch_grad)
        st = trainer.init(torch.zeros(3))
        assert st.fisher.f.dtype == torch.bfloat16
        assert st.mem.s.dtype == torch.float32
    st = trainer.init(torch.zeros(3, dtype=torch.bfloat16))
    assert st.x.dtype == st.mem.s.dtype == torch.bfloat16
    assert st.mem.gram.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="bfloat16"):
        trainer.init(torch.zeros(3, dtype=torch.float16))


def _init_trainer(optimizer):
    if optimizer == "SQN":
        return FusedTrainer("SQN", SQNConfig.create(mem_size=M), _torch_grad)
    return FusedTrainer("adaQN", AdaQNConfig.create(
        mem_size=M, fisher_size=4, max_incr=None), _torch_grad)


def _assert_same_state(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            _assert_same_state(va, vb)
        elif isinstance(va, torch.Tensor):
            assert va.device == vb.device and va.dtype == vb.dtype, f.name
            assert torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("kind", ["numpy", "list"])
@pytest.mark.parametrize("optimizer", ["SQN", "adaQN"])
def test_init_non_tensor_x0_defaults_to_the_card(optimizer, kind):
    """A numpy array or a list is no statement about a device: it goes to
    the card, and without one ``init`` raises instead of running the whole
    fused loop on the CPU unasked."""
    trainer = _init_trainer(optimizer)
    x0 = _data()[2]
    arg = x0 if kind == "numpy" else x0.tolist()
    if torch.cuda.is_available():
        assert trainer.init(arg).x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer.init(arg)


@pytest.mark.parametrize("kind", ["numpy", "list"])
@pytest.mark.parametrize("optimizer", ["SQN", "adaQN"])
def test_init_honours_device_cpu(optimizer, kind):
    trainer = _init_trainer(optimizer)
    x0 = _data()[2]
    arg = x0 if kind == "numpy" else x0.tolist()
    state = trainer.init(arg, device="cpu")
    assert state.x.device.type == "cpu" and state.x.dtype == torch.float32
    _assert_same_state(state, trainer.init(torch.from_numpy(x0)))


@pytest.mark.parametrize("optimizer", ["SQN", "adaQN"])
def test_init_tensor_stays_where_it_is(optimizer):
    trainer = _init_trainer(optimizer)
    x0 = torch.from_numpy(_data()[2])
    state = trainer.init(x0)
    assert state.x.device.type == "cpu" and state.mem.s.device.type == "cpu"
    assert state.x.data_ptr() != x0.data_ptr()      # copied
    np.testing.assert_array_equal(state.x.numpy(), x0.numpy())
