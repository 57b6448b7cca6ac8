"""The torch port's guided ``fit(engine="fused")`` against its protocol
engine and against the JAX package's fused fit.

Counterpart of ``test_guided_fused.py`` less the mesh tests (a sharded
fit runs in ``test_torch_parallel.py``'s cluster).  The callables are
least squares written with the operators numpy arrays, JAX arrays and
tensors share, so one set of functions serves the protocol engine (numpy)
and both fused engines (JAX arrays, tensors).

Tolerances, float64 on both sides: fused against protocol and against the
JAX fused fit, ``test_guided_fused.py``'s rtol 1e-8 and atol 1e-10 (the
big batches are the same rows summed in a merged order); two fused
drivers of the port against each other, rtol 1e-9 and atol 1e-12 (the
port's float64 tolerance); a fallback, which is the protocol loop, bit for
bit.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import scipy.sparse as sp  # noqa: E402

from stochqn_tpu import guided as jg  # noqa: E402
from stochqn_tpu_torch import guided as tg  # noqa: E402

RTOL, ATOL = 1e-8, 1e-10
SAME_RTOL, SAME_ATOL = 1e-9, 1e-12


def _linreg(rng, n_samples=200, n_features=8, noise=0.05):
    X = rng.standard_normal((n_samples, n_features))
    w_true = rng.standard_normal(n_features)
    y = X @ w_true + noise * rng.standard_normal(n_samples)
    return X, y


def _lsq_funs():
    def obj(w, X, y, sample_weight=None, **kw):
        r = X @ w - y
        if sample_weight is not None:
            return 0.5 * (sample_weight * r ** 2).sum() / X.shape[0]
        return 0.5 * (r ** 2).mean()

    def grad(w, X, y, sample_weight=None, **kw):
        r = X @ w - y
        if sample_weight is not None:
            r = r * sample_weight
        return X.T @ r / X.shape[0]

    def hessvec(w, v, X, y, sample_weight=None, **kw):
        return X.T @ (X @ v) / X.shape[0]
    return obj, grad, hessvec


def _makers():
    obj, grad, hessvec = _lsq_funs()
    return {
        "oLBFGS": lambda m, x0, **kw: m.oLBFGS(
            x0, grad, obj_fun=obj, step_size=0.1, batches_per_epoch=10,
            nepochs=4, verbose=False, **kw),
        "SQN-hv": lambda m, x0, **kw: m.SQN(
            x0, grad, obj_fun=obj, hess_vec_fun=hessvec, step_size=0.1,
            batches_per_epoch=10, bfgs_upd_freq=5, nepochs=4,
            verbose=False, **kw),
        "SQN-gd": lambda m, x0, **kw: m.SQN(
            x0, grad, obj_fun=obj, use_grad_diff=True, step_size=0.1,
            batches_per_epoch=10, bfgs_upd_freq=5, nepochs=4,
            verbose=False, **kw),
        "adaQN": lambda m, x0, **kw: m.adaQN(
            x0, grad, obj_fun=obj, step_size=0.5, batches_per_epoch=10,
            bfgs_upd_freq=5, fisher_size=20, nepochs=4, verbose=False, **kw),
        "adaQN-gd": lambda m, x0, **kw: m.adaQN(
            x0, grad, obj_fun=obj, use_grad_diff=True, step_size=0.5,
            batches_per_epoch=10, bfgs_upd_freq=5, nepochs=4,
            verbose=False, **kw),
    }


def _port(make, x0, **kw):
    return make(tg, x0, device="cpu", **kw)


def assert_close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.x, b.x, rtol=rtol, atol=atol)
    assert a.niter == b.niter
    assert a.req["task"] == b.req["task"] == "calc_grad"
    assert (a.req["info"]["iteration_number"]
            == b.req["info"]["iteration_number"])


@pytest.mark.parametrize("kind", list(_makers()))
def test_fused_fit_matches_protocol_and_jax(rng, kind):
    """Aligned config (divisible rows, B % upd_freq == 0, fresh state,
    shuffle on, the default 'auto' or None schedule): the port's fused fit
    takes the scheduled single dispatch and lands on its protocol fit and
    on the JAX package's fused fit."""
    X, y = _linreg(rng)
    make = _makers()[kind]
    x0 = np.zeros(X.shape[1])
    p = _port(make, x0).fit(X, y, engine="protocol")
    f = _port(make, x0).fit(X, y, engine="fused")
    j = make(jg, x0).fit(X, y, engine="fused")
    assert f._fused_single_dispatch is True
    assert f._fused_dispatch_mode == j._fused_dispatch_mode == "scheduled"
    assert f.niter == 40
    assert_close(f, p)
    assert_close(f, j)
    assert f.optimizer.state.x.device.type == "cpu"


def test_fused_fit_with_sample_weights_matches_protocol(rng):
    X, y = _linreg(rng)
    w = rng.uniform(0.5, 1.5, X.shape[0])
    make = _makers()["SQN-gd"]
    p = _port(make, np.zeros(X.shape[1]))
    f = _port(make, np.zeros(X.shape[1]))
    p.fit(X, y, sample_weight=w, engine="protocol")
    f.fit(X, y, sample_weight=w, engine="fused")
    assert_close(f, p)


@pytest.mark.parametrize("kind", ["SQN-hv", "adaQN"])
def test_fused_then_partial_fit_matches_jax(rng, kind):
    """The state the fused fit hands back is a protocol resume point with
    its own iteration count: ``partial_fit`` afterwards keys its steps on
    ``niter`` = 40 and matches the JAX package's (and an all-protocol
    run's) ``niter`` and ``x``."""
    X, y = _linreg(rng)
    make = _makers()[kind]
    x0 = np.zeros(X.shape[1])
    p = _port(make, x0).fit(X, y, engine="protocol")
    f = _port(make, x0).fit(X, y, engine="fused")
    j = make(jg, x0).fit(X, y, engine="fused")
    assert f.niter == j.niter == 40
    assert f.optimizer.niter == 40
    for opt in (p, f, j):
        for i in range(0, 200, 20):
            opt.partial_fit(X[i:i + 20], y[i:i + 20])
    assert f.niter == j.niter == p.niter == 50
    assert_close(f, j)
    assert_close(f, p)


def test_fused_valset_early_stop_matches_protocol(rng):
    X, y = _linreg(rng, n_samples=200)
    obj, grad, _ = _lsq_funs()
    Xv, yv = _linreg(rng, n_samples=50)

    def run(m, engine, **kw):
        calls = []
        opt = m.oLBFGS(np.zeros(X.shape[1]), grad, obj_fun=obj,
                       step_size=0.1, batches_per_epoch=10, nepochs=50,
                       tol=1e-3, verbose=False,
                       callback_epoch=lambda x: calls.append(1), **kw)
        opt.fit(X, y, valset=(Xv, yv, None), engine=engine)
        return opt, len(calls)

    p, ep = run(tg, "protocol", device="cpu")
    f, ef = run(tg, "fused", device="cpu")
    j, ej = run(jg, "fused")
    assert ef == ep == ej < 50
    assert f._fused_dispatch_mode == "loop"
    assert_close(f, p)
    assert_close(f, j)


def test_fused_adaqn_guard_on_valset_matches_protocol(rng):
    X, y = _linreg(rng)
    obj, grad, _ = _lsq_funs()
    Xv, yv = _linreg(rng, n_samples=40)

    def run(m, engine, **kw):
        opt = m.adaQN(np.zeros(X.shape[1]), grad, obj_fun=obj,
                      step_size=0.5, batches_per_epoch=10, bfgs_upd_freq=5,
                      fisher_size=20, nepochs=4, tol=0.0, verbose=False, **kw)
        return opt.fit(X, y, valset=(Xv, yv, None), engine=engine)

    p, f = run(tg, "protocol", device="cpu"), run(tg, "fused", device="cpu")
    assert_close(f, p)
    assert_close(f, run(jg, "fused"))


# ---------------------------------------------------------------------- #
# Fallbacks
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["ragged", "callback_iter", "sparse",
                                  "numpy_grad", "item_grad", "wrong_shape"])
def test_fallback_is_the_protocol_loop(rng, case):
    """Each reason the fused engine cannot run falls back to the protocol
    loop with the JAX package's warning; the fallback is the protocol
    loop, bit for bit."""
    X, y = _linreg(rng, n_samples=205 if case == "ragged" else 200)
    obj, grad, _ = _lsq_funs()
    kw = dict(obj_fun=obj, step_size=0.1, batches_per_epoch=10, nepochs=2,
              verbose=False, device="cpu")
    fit_X, match = X, "falling back"
    if case == "ragged":
        match = "not divisible"
    elif case == "callback_iter":
        kw["callback_iter"] = lambda x: None
        match = "callback_iter"
    elif case == "sparse":
        fit_X, match = sp.csr_matrix(X), "sparse"
    elif case in ("numpy_grad", "item_grad", "wrong_shape"):
        def bad_grad(w, Xb, yb, sample_weight=None, **kw_):
            if case == "numpy_grad":
                w = np.asarray(w)    # needs data: fails on the probe
            g = Xb.T @ (Xb @ w - yb) / Xb.shape[0]
            if case == "item_grad":
                g = g * float((g * g).sum().item() >= 0)
            if case == "wrong_shape":
                g = g[:-1] if len(g) == Xb.shape[1] else g
            return g
        match = ("shape" if case == "wrong_shape"
                 else "not traceable on tensors")
        grad = bad_grad
    opt = tg.oLBFGS(np.zeros(X.shape[1]), grad, **kw)
    ref = tg.oLBFGS(np.zeros(X.shape[1]), grad, **kw)
    if case == "wrong_shape":
        with pytest.warns(UserWarning, match=match):
            with pytest.raises(ValueError, match="elements"):
                opt.fit(fit_X, y, engine="fused")
        return
    with pytest.warns(UserWarning, match=match):
        opt.fit(fit_X, y, engine="fused")
    assert opt._fused_dispatch_mode == "protocol"
    ref.fit(fit_X, y, engine="protocol")
    np.testing.assert_array_equal(opt.x, ref.x)


def test_fallback_on_mid_iteration_state(rng):
    """An SQN optimizer parked mid-iteration (awaiting hess_vec) cannot
    enter the fused epoch; fit falls back and still completes."""
    X, y = _linreg(rng)
    obj, grad, hessvec = _lsq_funs()
    opt = tg.SQN(np.zeros(X.shape[1]), grad, obj_fun=obj,
                 hess_vec_fun=hessvec, step_size=0.1, batches_per_epoch=10,
                 bfgs_upd_freq=5, nepochs=2, verbose=False, device="cpu")
    for _ in range(10):
        opt.optimizer.update_gradient(grad(opt.x, X[:20], y[:20]))
        opt.req = opt.optimizer.run_optimizer(opt.x, 0.1)
        if opt.req["task"] != "calc_grad":
            break
    assert opt.req["task"] == "calc_hess_vec"
    with pytest.warns(UserWarning, match="mid-iteration"):
        opt.fit(X, y, engine="fused")
    assert opt.req["task"] == "calc_grad"


def test_engine_mesh_and_backend_args(rng):
    X, y = _linreg(rng)
    _, grad, _ = _lsq_funs()
    opt = tg.oLBFGS(np.zeros(X.shape[1]), grad, step_size=0.1,
                    batches_per_epoch=10, nepochs=1, verbose=False,
                    device="cpu")
    with pytest.raises(ValueError, match="engine"):
        opt.fit(X, y, engine="warp")
    with pytest.raises(TypeError, match="DeviceMesh"):
        opt.fit(X, y, engine="fused", mesh=object())
    with pytest.raises(ValueError, match="requires engine='fused'"):
        opt.fit(X, y, engine="protocol", mesh=object())
    native = tg.oLBFGS(np.zeros(3), grad, backend="native", device="cpu")
    assert native._fused_unsupported_reason(X, y, None) == (
        "the optimizer uses the native (C++) backend")


# ---------------------------------------------------------------------- #
# Dispatch modes
# ---------------------------------------------------------------------- #
def _sqn_like(kind, x0, callback=None, **over):
    obj, grad, hessvec = _lsq_funs()
    common = dict(step_size=0.05, batches_per_epoch=10, nepochs=4,
                  shuffle_data=False, decr_step_size=None,
                  callback_epoch=callback, verbose=False, device="cpu")
    common.update(over)
    if kind == "oLBFGS":
        return tg.oLBFGS(x0, grad, obj_fun=obj, **common)
    if kind == "SQN-hv":
        return tg.SQN(x0, grad, obj_fun=obj, hess_vec_fun=hessvec,
                      bfgs_upd_freq=common.pop("bfgs_upd_freq", 5), **common)
    return tg.adaQN(x0, grad, obj_fun=obj, bfgs_upd_freq=5, fisher_size=20,
                    **common)


@pytest.mark.parametrize("kind", ["oLBFGS", "SQN-hv", "adaQN"])
def test_invariant_single_dispatch_matches_loop_and_protocol(rng, kind):
    """Shuffle off and a constant step: one call of ``epochs`` (mode
    "invariant") against the per-epoch loop (forced with a no-op
    callback) and the protocol engine."""
    X, y = _linreg(rng)
    x0 = np.zeros(X.shape[1])
    p = _sqn_like(kind, x0).fit(X, y, engine="protocol")
    f1 = _sqn_like(kind, x0, callback=lambda x: None).fit(X, y,
                                                          engine="fused")
    f2 = _sqn_like(kind, x0).fit(X, y, engine="fused")
    assert f1._fused_single_dispatch is False
    assert f1._fused_dispatch_mode == "loop"
    assert f2._fused_dispatch_mode == "invariant"
    np.testing.assert_allclose(f2.x, f1.x, rtol=SAME_RTOL, atol=SAME_ATOL)
    assert_close(f2, p)
    assert f2.niter == f1.niter == p.niter == 40


@pytest.mark.parametrize("mode", ["decay", "scheduled", "misaligned"])
def test_single_dispatch_modes_match_loop(rng, mode):
    """'decay' (shuffle off, sqrt steps as a [nepochs] tensor),
    'scheduled' (shuffle and sqrt steps, the composed orders gathered on
    the device) and a misaligned single dispatch (B % upd_freq != 0, the
    generic layout) each against the per-epoch loop."""
    X, y = _linreg(rng)
    x0 = np.zeros(X.shape[1])
    over = {"decay": dict(decr_step_size="auto"),
            "scheduled": dict(decr_step_size="auto", shuffle_data=True),
            "misaligned": dict(bfgs_upd_freq=4, nepochs=3)}[mode]
    f1 = _sqn_like("SQN-hv", x0, callback=lambda x: None, **over)
    f1.fit(X, y, engine="fused")
    f2 = _sqn_like("SQN-hv", x0, **over).fit(X, y, engine="fused")
    assert f1._fused_dispatch_mode == "loop"
    assert f2._fused_dispatch_mode == {"decay": "decay",
                                       "scheduled": "scheduled",
                                       "misaligned": "invariant"}[mode]
    np.testing.assert_allclose(f2.x, f1.x, rtol=SAME_RTOL, atol=SAME_ATOL)
    assert f2.niter == f1.niter
    if mode == "misaligned":
        j = jg.SQN(x0, _lsq_funs()[1], obj_fun=_lsq_funs()[0],
                   hess_vec_fun=_lsq_funs()[2], bfgs_upd_freq=4,
                   step_size=0.05, batches_per_epoch=10, nepochs=3,
                   shuffle_data=False, decr_step_size=None, verbose=False)
        assert_close(f2, j.fit(X, y, engine="fused"))


def test_dispatch_mode_resets_on_protocol_fit(rng):
    X, y = _linreg(rng)
    opt = _sqn_like("SQN-hv", np.zeros(X.shape[1]), nepochs=2,
                    shuffle_data=True, decr_step_size="auto")
    opt.fit(X, y, engine="fused")
    assert opt._fused_dispatch_mode == "scheduled"
    opt.fit(X, y, engine="protocol")
    assert opt._fused_dispatch_mode == "protocol"
    assert opt._fused_single_dispatch is False


# ---------------------------------------------------------------------- #
# The user's hess_vec_fun on the fused engine
# ---------------------------------------------------------------------- #
def test_fused_traces_user_hess_vec_fun(rng):
    """A hess_vec_fun that passes the probe drives SQN's pairs on the
    fused engine: a scaled Gauss-Newton product (not the true Hessian)
    still gives the protocol's trajectory, and the scaling moves it."""
    X, y = _linreg(rng)
    obj, grad, hessvec = _lsq_funs()

    def scaled_hessvec(w, v, Xb, yb, sample_weight=None, **kw):
        return 1.7 * (Xb.T @ (Xb @ v)) / Xb.shape[0]

    kw = dict(obj_fun=obj, hess_vec_fun=scaled_hessvec, step_size=0.1,
              batches_per_epoch=10, bfgs_upd_freq=5, nepochs=4,
              verbose=False)
    p = tg.SQN(np.zeros(X.shape[1]), grad, device="cpu", **kw)
    p.fit(X, y, engine="protocol")
    f = tg.SQN(np.zeros(X.shape[1]), grad, device="cpu", **kw)
    f.fit(X, y, engine="fused")
    j = jg.SQN(np.zeros(X.shape[1]), grad, **kw).fit(X, y, engine="fused")
    assert_close(f, p)
    assert_close(f, j)
    g = tg.SQN(np.zeros(X.shape[1]), grad, device="cpu",
               **{**kw, "hess_vec_fun": hessvec})
    g.fit(X, y, engine="fused")
    assert not np.allclose(g.x, f.x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("failure", ["numpy", "shape"])
def test_failing_hess_vec_fun_takes_jvp_with_a_warning(rng, failure):
    """A hess_vec_fun that fails the probe (numpy inside, or a wrong
    shape) keeps the fit on the fused engine with ``torch.func.jvp`` of
    ``grad_fun``, and the port says why.  For least squares jvp-of-grad is
    ``X^T X v / B``, so the trajectory is the protocol's (which calls the
    user's numpy callable)."""
    X, y = _linreg(rng)
    obj, grad, hessvec = _lsq_funs()

    def numpy_only_hessvec(w, v, Xb, yb, sample_weight=None, **kw):
        if failure == "numpy":
            v = np.asarray(v)        # needs data: fails on the probe
            return Xb.T @ (Xb @ v) / Xb.shape[0]
        hv = hessvec(w, v, Xb, yb)
        return hv if isinstance(hv, np.ndarray) else hv[:-1]

    kw = dict(obj_fun=obj, step_size=0.1, batches_per_epoch=10,
              bfgs_upd_freq=5, nepochs=4, verbose=False, device="cpu")
    f = tg.SQN(np.zeros(X.shape[1]), grad, hess_vec_fun=numpy_only_hessvec,
               **kw)
    with pytest.warns(UserWarning, match="torch.func.jvp"):
        f.fit(X, y, engine="fused")
    assert f._fused_single_dispatch
    p = tg.SQN(np.zeros(X.shape[1]), grad, hess_vec_fun=numpy_only_hessvec,
               **kw)
    p.fit(X, y, engine="protocol")
    assert_close(f, p)
