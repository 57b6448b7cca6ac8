"""The torch port's guided driver (``fit`` / ``partial_fit`` on the
protocol engine) against the JAX package's.

Counterparts of ``test_guided.py`` and ``test_guided_driver.py``.  The
callables are numpy least squares written with the operators numpy
arrays, JAX arrays and tensors share, so the same functions drive both
packages: each test runs the port (``device="cpu"``) and the JAX package
side by side and holds the port to the JAX package's iterate, iteration
count and call stream, besides the reference semantics the JAX tests
check (shuffle orders, long-batch windows, schedule keys, the validation
split, early stopping, the stored-batch container).

Tolerance: float64 on both sides (the port's default dtype; the JAX
package's under ``jax_enable_x64``), rtol 1e-9 and atol 1e-12, each side
summing in its own order.  Call streams (which rows each callable saw)
must be equal.
"""
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
import scipy.sparse as sp  # noqa: E402

from stochqn_tpu import guided as jg  # noqa: E402
from stochqn_tpu_torch import guided as tg  # noqa: E402
from test_guided_driver import (Recorder, _check_long_windows,  # noqa: E402
                                _tagged_problem, reference_long_window,
                                reference_shuffle_orders)

RTOL, ATOL = 1e-9, 1e-12


def _linreg_problem(rng, n_samples=400, n_features=8, noise=0.01):
    X = rng.standard_normal((n_samples, n_features))
    w_true = rng.standard_normal(n_features)
    y = X @ w_true + noise * rng.standard_normal(n_samples)
    return X, y


def _lsq_funs():
    def obj(w, X, y, sample_weight=None, **kw):
        r = X @ w - y
        return 0.5 * (r ** 2).mean()

    def grad(w, X, y, sample_weight=None, **kw):
        r = X @ w - y
        return X.T @ r / X.shape[0]

    def hessvec(w, v, X, y, sample_weight=None, **kw):
        return X.T @ (X @ v) / X.shape[0]

    def pred(w, X, **kw):
        return X @ w
    return obj, grad, hessvec, pred


def _both(make):
    """``make(module, **port_only)`` for the JAX package and the port."""
    return make(jg), make(tg, device="cpu")


def assert_same(port, ref):
    np.testing.assert_allclose(port.x, ref.x, rtol=RTOL, atol=ATOL)
    assert port.niter == ref.niter
    assert port.req["task"] == ref.req["task"]
    assert (port.req["info"]["iteration_number"]
            == ref.req["info"]["iteration_number"])


MAKERS = {
    "oLBFGS": (lambda m, x0, g, o, h, p, **kw: m.oLBFGS(
        x0, g, obj_fun=o, pred_fun=p, step_size=0.1, batches_per_epoch=10,
        nepochs=12, verbose=False, **kw), 1e-2),
    "SQN-hv": (lambda m, x0, g, o, h, p, **kw: m.SQN(
        x0, g, obj_fun=o, hess_vec_fun=h, pred_fun=p, step_size=0.1,
        batches_per_epoch=10, bfgs_upd_freq=5, nepochs=12, verbose=False,
        **kw), 1e-2),
    # grad-diff pairs need consistent big-batch windows: the window is the
    # whole (unshuffled) epoch, like the reference benchmark setups
    "SQN-gd": (lambda m, x0, g, o, h, p, **kw: m.SQN(
        x0, g, obj_fun=o, pred_fun=p, use_grad_diff=True, step_size=0.1,
        batches_per_epoch=5, bfgs_upd_freq=5, shuffle_data=False,
        nepochs=15, verbose=False, **kw), 5e-2),
    "adaQN": (lambda m, x0, g, o, h, p, **kw: m.adaQN(
        x0, g, obj_fun=o, pred_fun=p, step_size=0.5, batches_per_epoch=10,
        bfgs_upd_freq=5, nepochs=15, verbose=False, **kw), 5e-2),
}


@pytest.mark.parametrize("kind", list(MAKERS))
def test_fit_converges_and_matches_jax(rng, kind):
    X, y = _linreg_problem(rng)
    obj, grad, hessvec, pred = _lsq_funs()
    make, tol = MAKERS[kind]
    ref, port = _both(lambda m, **kw: make(m, np.zeros(X.shape[1]), grad,
                                           obj, hessvec, pred, **kw))
    ref.fit(X, y)
    port.fit(X, y)
    assert_same(port, ref)
    assert obj(port.x, X, y) < tol
    assert port.predict(X[:5]).shape == (5,)
    assert port.optimizer.state.x.device.type == "cpu"


def test_partial_fit_stream_matches_jax(rng):
    X, y = _linreg_problem(rng)
    obj, grad, hessvec, _ = _lsq_funs()
    ref, port = _both(lambda m, **kw: m.SQN(
        np.zeros(X.shape[1]), grad, obj_fun=obj, hess_vec_fun=hessvec,
        step_size=0.05, decr_step_size=None, bfgs_upd_freq=4, verbose=False,
        **kw))
    loss0 = obj(port.x, X, y)
    for _ in range(6):
        for i in range(0, 400, 40):
            for opt in (ref, port):
                opt.partial_fit(X[i:i + 40], y[i:i + 40])
    assert port.niter == 6 * 10
    assert obj(port.x, X, y) < loss0 * 0.1
    assert_same(port, ref)


def test_partial_fit_adaqn_guard_plus_grad_diff(rng):
    """Two big-batch requests at one boundary (the guard, then the
    gradient-difference y) are served from one assembled batch."""
    X, y = _linreg_problem(rng)
    obj, grad, _, _ = _lsq_funs()
    ref, port = _both(lambda m, **kw: m.adaQN(
        np.zeros(X.shape[1]), grad, obj_fun=obj, use_grad_diff=True,
        max_incr=1.01, bfgs_upd_freq=4, step_size=0.05, decr_step_size=None,
        verbose=False, **kw))
    loss0 = obj(port.x, X, y)
    for _ in range(4):
        for i in range(0, 400, 40):
            for opt in (ref, port):
                opt.partial_fit(X[i:i + 40], y[i:i + 40])
    assert port.niter == 4 * 10
    assert obj(port.x, X, y) < loss0
    assert_same(port, ref)


def test_valset_early_stopping_matches_jax(rng):
    X, y = _linreg_problem(rng, n_samples=500)
    obj, grad, _, _ = _lsq_funs()
    calls = {"jax": [], "torch": []}

    def make(m, **kw):
        key = "torch" if kw else "jax"
        return m.oLBFGS(np.zeros(X.shape[1]), grad, obj_fun=obj,
                        step_size=0.1, batches_per_epoch=10, nepochs=50,
                        valset_frac=0.2, tol=1e-3, verbose=False,
                        callback_epoch=lambda x: calls[key].append(1), **kw)
    ref, port = _both(make)
    ref.fit(X, y)
    port.fit(X, y)
    assert len(calls["torch"]) == len(calls["jax"]) < 50
    assert_same(port, ref)


def test_callbacks_and_schedule(rng):
    X, y = _linreg_problem(rng, n_samples=100)
    obj, grad, _, _ = _lsq_funs()
    iters, steps = [], []

    def sched(s0, k):
        steps.append(k)
        return s0 / (k + 1)

    opt = tg.oLBFGS(np.zeros(X.shape[1]), grad, step_size=0.1,
                    decr_step_size=sched, batches_per_epoch=5, nepochs=2,
                    verbose=False, callback_iter=lambda x: iters.append(1),
                    device="cpu")
    opt.fit(X, y)
    assert len(iters) == 10      # one per completed iteration
    assert set(steps) == {0, 1}  # keyed on epoch in fit mode


# --------------------------------------------------------------------------
# the driver layer, call for call (test_guided_driver.py's cases)
# --------------------------------------------------------------------------
def _recorded(make):
    """Run ``make(module, recorder, **port_only)`` on both packages; the
    two recorded call streams must be equal.  Returns the port's
    optimizer and recorder."""
    rec_j, rec_t = Recorder(), Recorder()
    ref = make(jg, rec_j)
    port = make(tg, rec_t, device="cpu")
    assert len(rec_t.calls) == len(rec_j.calls)
    for (kt, rt), (kj, rj) in zip(rec_t.calls, rec_j.calls):
        assert kt == kj
        np.testing.assert_array_equal(rt, rj)
    assert_same(port, ref)
    return port, rec_t


def test_fit_shuffle_and_batch_slicing_lockstep():
    n, bpe, nepochs, rs = 21, 4, 3, 7
    X, y = _tagged_problem(n)

    def make(m, rec, **kw):
        opt = m.oLBFGS(np.zeros(X.shape[1]), rec.grad, step_size=1e-3,
                       shuffle_data=True, random_state=rs, nepochs=nepochs,
                       batches_per_epoch=bpe, verbose=False, **kw)
        return opt.fit(X, y)
    _, rec = _recorded(make)
    batch_size = int(np.ceil(n / bpe))       # 6, last batch is 3 rows
    expected = [ids[b * batch_size:min(n, (b + 1) * batch_size)]
                for ids in reference_shuffle_orders(n, rs, nepochs)
                for b in range(bpe)]
    grads = rec.of_kind("grad")
    assert len(grads) == 2 * len(expected)
    for i, exp in enumerate(expected):
        np.testing.assert_array_equal(grads[2 * i], exp)
        np.testing.assert_array_equal(grads[2 * i + 1], exp)


@pytest.mark.parametrize("big_kind,upd_freq,nepochs", [
    ("grad_big", 5, 3), ("hess_vec", 3, 2)])
def test_fit_long_batch_windows_misaligned(big_kind, upd_freq, nepochs):
    n, bpe = 28, 7
    X, y = _tagged_problem(n)

    def make(m, rec, **kw):
        extra = (dict(use_grad_diff=True) if big_kind == "grad_big"
                 else dict(hess_vec_fun=rec.hess_vec))
        opt = m.SQN(np.zeros(X.shape[1]), rec.grad, step_size=1e-3,
                    shuffle_data=False, nepochs=nepochs,
                    batches_per_epoch=bpe, bfgs_upd_freq=upd_freq,
                    verbose=False, **extra, **kw)
        return opt.fit(X, y)
    _, rec = _recorded(make)
    checked = _check_long_windows(rec, big_kind, n, int(np.ceil(n / bpe)),
                                  bpe, upd_freq)
    assert checked >= 3


def test_fit_shuffled_long_windows_use_epoch_order():
    n, bpe, upd_freq, nepochs, rs = 24, 6, 3, 2, 11
    X, y = _tagged_problem(n)

    def make(m, rec, **kw):
        opt = m.SQN(np.zeros(X.shape[1]), rec.grad, use_grad_diff=True,
                    step_size=1e-3, shuffle_data=True, random_state=rs,
                    nepochs=nepochs, batches_per_epoch=bpe,
                    bfgs_upd_freq=upd_freq, verbose=False, **kw)
        return opt.fit(X, y)
    _, rec = _recorded(make)
    batch_size = int(np.ceil(n / bpe))
    orders = reference_shuffle_orders(n, rs, nepochs)
    small_seen = checked = 0
    for kind, rows in rec.calls:
        if len(rows) <= batch_size:
            small_seen += 1
            continue
        epoch, batch = divmod(small_seen - 1, bpe)
        pos = reference_long_window(n, batch_size, upd_freq, batch)
        np.testing.assert_array_equal(rows, orders[epoch][pos])
        checked += 1
    assert checked >= 2


def test_partial_fit_schedule_keyed_on_niter():
    X, y = _tagged_problem(40)
    ks = {"jax": [], "torch": []}

    def make(m, rec, **kw):
        key = "torch" if kw else "jax"

        def sched(s0, k):
            ks[key].append(int(k))
            return s0
        opt = m.oLBFGS(np.zeros(X.shape[1]), rec.grad, step_size=1e-3,
                       decr_step_size=sched, verbose=False, **kw)
        for i in range(5):
            opt.partial_fit(X[8 * i:8 * (i + 1)], y[8 * i:8 * (i + 1)])
        return opt
    port, _ = _recorded(make)
    assert port.niter == 5
    assert ks["torch"] == ks["jax"] == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5]


def test_valset_rows_routed_to_obj():
    """adaQN's calc_fun_val_batch is evaluated on the validation set when
    one is supplied (``_optimizers.py:346-348``)."""
    X, y = _tagged_problem(30)
    Xv, yv = _tagged_problem(5, seed=9)
    Xv[:, 0] += 1000          # distinguishable val rows

    def make(m, rec, **kw):
        opt = m.adaQN(np.zeros(X.shape[1]), rec.grad, obj_fun=rec.obj,
                      step_size=1e-2, nepochs=3, batches_per_epoch=5,
                      bfgs_upd_freq=2, max_incr=1.01, shuffle_data=False,
                      tol=0.0, verbose=False, **kw)
        return opt.fit(X, y, valset=(Xv, yv, None))
    _, rec = _recorded(make)
    objs = rec.of_kind("obj")
    assert objs and all(np.all(rows >= 1000) for rows in objs)


def test_early_stop_exact_condition():
    """Stop iff (prev - obj) < tol AND obj <= prev: an increase must not
    stop (``_optimizers.py:275-281``)."""
    X, y = _tagged_problem(20)
    scripted = iter([10.0, 10.5, 10.45, 10.44, 10.43])
    epochs_run = []

    def obj(x, Xv, yv, sample_weight=None, **kw):
        return next(scripted)

    _, grad, _, _ = _lsq_funs()
    opt = tg.oLBFGS(np.zeros(X.shape[1]), grad, obj_fun=obj, step_size=1e-3,
                    nepochs=5, batches_per_epoch=4, tol=0.2, verbose=False,
                    callback_epoch=lambda x: epochs_run.append(1),
                    device="cpu")
    opt.fit(X, y, valset=(X[:4], y[:4], None))
    assert len(epochs_run) == 3


@pytest.mark.parametrize("n,frac,rs", [(40, 0.25, 13), (37, 0.1, 0),
                                       (101, 0.33, 5), (10, 0.5, 2)])
def test_private_split_matches_sklearn(n, frac, rs):
    """The port's copy of ``train_test_split`` picks sklearn's rows, for
    dense, weighted and CSR inputs."""
    from sklearn.model_selection import train_test_split
    X, y = _tagged_problem(n)
    w = np.arange(n, dtype=np.float64)
    want = train_test_split(X, y, w, test_size=frac, random_state=rs)
    got = tg._train_test_split((X, y, w), frac, rs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    Xs = sp.csr_matrix(X)
    want_s = train_test_split(Xs, y, test_size=frac, random_state=rs)
    got_s = tg._train_test_split((Xs, y), frac, rs)
    np.testing.assert_array_equal(got_s[0].toarray(), want_s[0].toarray())
    np.testing.assert_array_equal(got_s[1].toarray(), want_s[1].toarray())


def test_valset_frac_split_matches_sklearn():
    from sklearn.model_selection import train_test_split
    n, rs = 40, 13
    X, y = _tagged_problem(n)

    def make(m, rec, **kw):
        opt = m.oLBFGS(np.zeros(X.shape[1]), rec.grad, obj_fun=rec.obj,
                       step_size=1e-3, nepochs=1, batches_per_epoch=2,
                       valset_frac=0.25, tol=-np.inf, random_state=rs,
                       shuffle_data=False, verbose=False, **kw)
        return opt.fit(X, y)
    _, rec = _recorded(make)
    _, X_val_exp, _, _ = train_test_split(X, y, test_size=0.25,
                                          random_state=rs)
    objs = rec.of_kind("obj")
    assert len(objs) == 1     # epoch-end evaluation only (oLBFGS)
    np.testing.assert_array_equal(objs[0], X_val_exp[:, 0])


def test_partial_fit_big_batch_is_vstack_of_stored():
    n, upd_freq, bs = 60, 3, 6
    X, y = _tagged_problem(n)

    def make(m, rec, **kw):
        opt = m.SQN(np.zeros(X.shape[1]), rec.grad, use_grad_diff=True,
                    step_size=1e-3, decr_step_size=None,
                    bfgs_upd_freq=upd_freq, verbose=False, **kw)
        for i in range(n // bs):
            opt.partial_fit(X[bs * i:bs * (i + 1)], y[bs * i:bs * (i + 1)])
        return opt
    port, rec = _recorded(make)
    pending = []
    for kind, rows in rec.calls:
        if len(rows) == bs:
            pending.append(rows)
        else:
            np.testing.assert_array_equal(rows, np.concatenate(pending))
            pending = []
    assert port.niter == n // bs


def test_partial_fit_mixed_weights_warns_and_fills_ones():
    X, y = _tagged_problem(24)
    rec = Recorder()
    weights_seen = []

    def grad(x, Xb, yb, sample_weight=None, **kw):
        weights_seen.append(None if sample_weight is None
                            else np.asarray(sample_weight).copy())
        return rec.grad(x, Xb, yb)

    opt = tg.SQN(np.zeros(X.shape[1]), grad, use_grad_diff=True,
                 step_size=1e-3, bfgs_upd_freq=2, verbose=False, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        opt.partial_fit(X[:6], y[:6], sample_weight=np.full(6, 2.0))
        opt.partial_fit(X[6:12], y[6:12])  # no weights
        assert any("weights" in str(x.message) for x in w)
    big = [w_ for w_ in weights_seen if w_ is not None and len(w_) == 12]
    assert big and np.allclose(big[0], np.r_[np.full(6, 2.0), np.ones(6)])


def test_fit_csr_matches_dense_and_jax():
    n = 24
    X, y = _tagged_problem(n)

    def grad_dense(x, Xb, yb, sample_weight=None, **kw):
        return Xb.T @ (Xb @ x - yb) / Xb.shape[0]

    def grad_sparse(x, Xb, yb, sample_weight=None, **kw):
        r = Xb @ x - np.asarray(yb)
        return np.asarray(Xb.T @ r).ravel() / Xb.shape[0]

    def make(m, grad, **kw):
        return m.SQN(np.zeros(X.shape[1]), grad, use_grad_diff=True,
                     step_size=1e-3, shuffle_data=True, random_state=5,
                     nepochs=2, batches_per_epoch=4, bfgs_upd_freq=2,
                     verbose=False, **kw)
    d = make(tg, grad_dense, device="cpu").fit(X, y)
    s = make(tg, grad_sparse, device="cpu").fit(sp.csr_matrix(X), y)
    j = make(jg, grad_sparse).fit(sp.csr_matrix(X), y)
    np.testing.assert_allclose(s.x, d.x, rtol=1e-10)
    assert_same(s, j)
    with pytest.warns(UserWarning, match="CSR"):
        make(tg, grad_sparse, device="cpu").fit(sp.csc_matrix(X), y)


def test_errors_and_device_default():
    """The reference's argument checks, and no card: the constructor
    raises rather than falling back to the CPU."""
    import torch
    _, grad, hessvec, _ = _lsq_funs()
    with pytest.raises(ValueError, match="hess_vec_fun"):
        tg.SQN(np.zeros(3), grad, device="cpu")
    with pytest.raises(ValueError, match="obj_fun"):
        tg.adaQN(np.zeros(3), grad, device="cpu")
    with pytest.raises(ValueError, match="batches_per_epoch"):
        tg.oLBFGS(np.zeros(3), grad, batches_per_epoch=0, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tg.oLBFGS(np.zeros(3), grad, device="cpu").fit(
            np.zeros((4, 3)), np.zeros(4), engine="warp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.oLBFGS(np.zeros(3), grad)
