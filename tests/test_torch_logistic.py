"""The torch port's ``StochasticLogisticRegression`` and prediction
functions against the JAX package's, on scikit-learn's digits.

Counterpart of ``test_logistic.py``.  The protocol engine shuffles with
the reference's numpy order, which both packages share, so protocol fits
are held against the JAX package's; so are fused fits with
``shuffle_data=False`` (the fused validation split is numpy's
``default_rng(random_state)`` in both).  A shuffled fused fit draws its
permutations from a ``torch.Generator`` (the JAX package's ``jax.random``
stream has no torch twin), so it is held against the port's own
``FusedTrainer.epochs_scheduled`` on the permutations that generator
draws.  The digits>=5 split reaches only 90.7% train accuracy at the
optimum (``test_logistic.py``), so convergence is checked as approach.

Tolerances: float64 on both sides, rtol 1e-9 and atol 1e-12 (oLBFGS,
whose pairs amplify roundings, rtol 1e-7); the prediction functions
against the JAX package's, rtol 1e-12.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu.models.logistic import (  # noqa: E402
    StochasticLogisticRegression as JaxLR)
from stochqn_tpu_torch.core.config import SQNConfig  # noqa: E402
from stochqn_tpu_torch.fused import FusedTrainer, batchify  # noqa: E402
from stochqn_tpu_torch.models import losses as tl  # noqa: E402
from stochqn_tpu_torch.models.logistic import (  # noqa: E402
    StochasticLogisticRegression)

RTOL, ATOL = 1e-9, 1e-12
RTOL_OLBFGS = 1e-7


@pytest.fixture(scope="module")
def digits():
    from sklearn.datasets import load_digits
    d = load_digits()
    return d.data / 16.0, d.target


def _port(**kw):
    return StochasticLogisticRegression(dtype=torch.float64, device="cpu",
                                        **kw)


def _jax(**kw):
    return JaxLR(dtype=np.float64, **kw)


def _close(port, ref, optimizer="SQN"):
    rtol = RTOL_OLBFGS if optimizer == "oLBFGS" else RTOL
    np.testing.assert_allclose(np.asarray(port.x_), np.asarray(ref.x_),
                               rtol=rtol, atol=ATOL)


def test_prediction_functions_match_jax(rng):
    n, d, k = 30, 5, 4
    X = rng.standard_normal((n, d))
    wb = rng.standard_normal(d + 1)
    wm = rng.standard_normal(k * (d + 1))
    tX = torch.from_numpy(X)
    np.testing.assert_allclose(
        tl.binary_logistic_predict_proba(torch.from_numpy(wb), tX).numpy(),
        np.asarray(jl.binary_logistic_predict_proba(jnp.asarray(wb),
                                                    jnp.asarray(X))),
        rtol=1e-12)
    for name in ("multinomial_logistic_predict_proba",
                 "multinomial_logistic_predict_softmax"):
        got = getattr(tl, name)(torch.from_numpy(wm), tX, k).numpy()
        want = np.asarray(getattr(jl, name)(jnp.asarray(wm), jnp.asarray(X),
                                            k))
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.allclose(
        tl.multinomial_logistic_predict_softmax(torch.from_numpy(wm), tX,
                                                k).sum(1).numpy(), 1.0)


@pytest.mark.parametrize("optimizer", ["oLBFGS", "SQN", "adaQN"])
def test_digits_binary_protocol_matches_jax(digits, optimizer):
    X, target = digits
    y = (target >= 5).astype(np.float64)
    kw = dict(reg_param=1e-3, optimizer=optimizer, step_size=1.0,
              valset_frac=None, verbose=False, nepochs=3,
              batches_per_epoch=20, random_state=1)
    port = _port(**kw).fit(X, y)
    _close(port, _jax(**kw).fit(X, y), optimizer)
    assert port.optimizer.niter == 60
    proba = port.predict_proba(X[:7])
    assert proba.shape == (7, 2)
    assert np.all(proba >= 0) and np.all(proba <= 1)


@pytest.mark.parametrize("optimizer", ["oLBFGS", "SQN", "adaQN"])
def test_digits_binary_convergence(digits, optimizer):
    X, target = digits
    y = (target >= 5).astype(np.float64)
    clf = _port(reg_param=1e-3, optimizer=optimizer, step_size=1.0,
                valset_frac=None, verbose=False, nepochs=10,
                batches_per_epoch=20, random_state=1)
    clf.fit(X, y)
    acc = (clf.predict(X) == y).mean()
    assert acc > 0.84, f"{optimizer} digits accuracy {acc}"
    assert clf.coef_.shape == (64,) and np.ndim(clf.intercept_) == 0


def test_digits_multinomial_partial_fit_matches_jax(digits):
    X, target = digits
    Y = np.eye(10)[target]
    kw = dict(reg_param=1e-3, optimizer="SQN", step_size=1e-1,
              valset_frac=None, verbose=False, bfgs_upd_freq=5)
    port, ref = _port(**kw), _jax(**kw)
    for _ in range(3):
        for i in range(0, X.shape[0] - 100, 100):
            for clf in (port, ref):
                clf.partial_fit(X[i:i + 100], Y[i:i + 100])
    _close(port, ref)
    assert port.optimizer.niter == ref.optimizer.niter == 51
    for _ in range(5):               # on to test_logistic.py's 8 epochs
        for i in range(0, X.shape[0] - 100, 100):
            port.partial_fit(X[i:i + 100], Y[i:i + 100])
    acc = (port.predict(X) == target).mean()
    assert acc > 0.85, f"multinomial digits accuracy {acc}"
    assert port.coef_.shape == (10, 64)
    assert port.intercept_.shape == (10,)


def test_digits_multinomial_valset_frac_matches_jax(digits):
    """The protocol engine's validation split (the port's copy of
    sklearn's) and early stopping, multinomial, with sample weights."""
    X, target = digits
    Y = np.eye(10)[target]
    w = np.random.default_rng(4).uniform(0.5, 1.5, X.shape[0])
    kw = dict(reg_param=1e-3, optimizer="SQN", step_size=1.0,
              valset_frac=0.1, tol=1e-4, verbose=False, nepochs=3,
              batches_per_epoch=20, bfgs_upd_freq=5)
    port = _port(**kw).fit(X, Y, sample_weight=w)
    _close(port, _jax(**kw).fit(X, Y, sample_weight=w))


@pytest.mark.parametrize("optimizer,multi", [
    ("oLBFGS", False), ("SQN", False), ("adaQN", False), ("SQN", True)])
def test_digits_fused_unshuffled_matches_jax(digits, optimizer, multi):
    """engine='fused' with shuffle_data=False: the same steps as the JAX
    package's fused fit, through the fused validation split."""
    X, target = digits
    y = np.eye(10)[target] if multi else (target >= 5).astype(np.float64)
    kw = dict(reg_param=1e-3, optimizer=optimizer, step_size=1.0,
              valset_frac=0.15, tol=1e-4, verbose=False, nepochs=4,
              batches_per_epoch=20, random_state=1, engine="fused",
              shuffle_data=False,
              **({"bfgs_upd_freq": 10} if optimizer != "oLBFGS" else {}))
    port = _port(**kw).fit(X, y)
    _close(port, _jax(**kw).fit(X, y), optimizer)
    assert port.coef_.shape == ((10, 64) if multi else (64,))
    assert port.predict_proba(X[:5]).shape == ((5, 10) if multi else (5, 2))


@pytest.mark.parametrize("optimizer", ["oLBFGS", "SQN"])
def test_digits_fused_engine_converges(digits, optimizer):
    """Shuffled fused fits reach the protocol engine's quality.  adaQN is
    held to the JAX package unshuffled above instead: at step 1.0 its
    AdaGrad scaling stalls on this split in both packages (the JAX
    package's shuffled fit reaches 0.88 with random_state 1 and 0.56 with
    2 and 3, its unshuffled fit 0.68, as the port's does)."""
    X, target = digits
    y = (target >= 5).astype(np.float64)
    clf = _port(reg_param=1e-3, optimizer=optimizer, step_size=1.0,
                valset_frac=0.15, tol=1e-4, verbose=False, nepochs=15,
                batches_per_epoch=20, random_state=1, engine="fused",
                **({"bfgs_upd_freq": 10} if optimizer != "oLBFGS" else {}))
    clf.fit(X, y)
    acc = (clf.predict(X) == y).mean()
    assert acc > 0.84, f"{optimizer} fused digits accuracy {acc}"


def test_fused_shuffle_is_the_generators_permutations(digits):
    """A shuffled fused fit takes each epoch's rows from a
    ``torch.Generator`` seeded with ``random_state``: the same steps as
    ``epochs_scheduled`` on the permutations that generator draws."""
    X, target = digits
    y = (target >= 5).astype(np.float64)
    n, bpe, nepochs, rs, step = 1780, 20, 3, 7, 1.0
    clf = _port(reg_param=1e-3, optimizer="SQN", step_size=step,
                valset_frac=None, nepochs=nepochs, batches_per_epoch=bpe,
                random_state=rs, engine="fused", bfgs_upd_freq=5,
                decr_step_size=None)
    clf.fit(X[:n], y[:n])

    Xt = torch.from_numpy(X[:n])
    Yt = torch.from_numpy(2.0 * y[:n] - 1.0)
    Wt = torch.full((n,), 1.0 / n, dtype=torch.float64)
    reg = 1e-3

    def grad_fn(x, b):
        return tl.binary_logistic_grad(x, b[0], b[1], b[2], reg)

    def hess_vec_fn(x, v, b):
        return tl.binary_logistic_hessvec(x, v, b[0], b[1], b[2], reg)
    trainer = FusedTrainer("SQN", SQNConfig.create(bfgs_upd_freq=5),
                           grad_fn, hess_vec_fn=hess_vec_fn)
    np.random.seed(rs)
    state = trainer.init(torch.from_numpy(np.random.normal(size=65)))
    bs = n // bpe
    gen = torch.Generator().manual_seed(rs)
    orders = torch.stack([torch.randperm(bpe * bs, generator=gen)
                          for _ in range(nepochs)])
    state, _ = trainer.epochs_scheduled(state, (Xt, Yt, Wt), step, orders,
                                        batch_size=bs)
    np.testing.assert_array_equal(clf.x_, state.x.numpy())
    # and the shuffle moved the trajectory
    unshuffled, _ = trainer.epochs(
        trainer.init(torch.from_numpy(np.random.RandomState(rs).normal(
            size=65))), batchify((Xt, Yt, Wt), bs), step, nepochs=nepochs)
    assert not np.allclose(clf.x_, unshuffled.x.numpy())


def test_fused_then_partial_fit_continues_same_model(digits):
    """partial_fit after a fused fit hands the fused weights to the
    protocol optimizer, as the JAX package does."""
    X, target = digits
    y = (target >= 5).astype(np.float64)
    kw = dict(reg_param=1e-3, optimizer="oLBFGS", step_size=1.0,
              valset_frac=None, verbose=False, nepochs=3,
              batches_per_epoch=20, engine="fused", shuffle_data=False)
    port, ref = _port(**kw).fit(X, y), _jax(**kw).fit(X, y)
    x_after_fit = np.asarray(port.x_).copy()
    for clf in (port, ref):
        clf.partial_fit(X[:100], y[:100])
    assert port._x_fused is None
    x_now = np.asarray(port.x_)
    assert not np.allclose(x_now, x_after_fit)        # it moved
    assert np.linalg.norm(x_now - x_after_fit) < 1.0  # ...from the warm start
    _close(port, ref, "oLBFGS")


def test_constructor_checks():
    with pytest.raises(ValueError, match="optimizer"):
        _port(optimizer="Adam")
    with pytest.raises(ValueError, match="engine"):
        _port(engine="warp")
    with pytest.raises(NotImplementedError, match="A.15"):
        _port(engine="fused", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StochasticLogisticRegression()


def test_fused_model_adds_no_per_step_work():
    """The model's fused fit dispatches, epoch for epoch, the ops of a bare
    ``FusedTrainer`` with the same functions on the same data, and one
    fill of the step size per round more (the model hands each epoch a
    Python number, the bare ``epochs`` a tensor of steps): the front end
    adds no per-step cost."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(0)
    n, f, k, B, L = 400, 30, 5, 20, 5
    X = rng.standard_normal((n, f)).astype(np.float32)
    Y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    counts = []
    orig = FusedTrainer._epoch_at

    def counted(self, *args, **kw):
        with Count() as c:
            out = orig(self, *args, **kw)
        counts.append(sum(c.ops.values()))
        return out
    try:
        FusedTrainer._epoch_at = counted
        StochasticLogisticRegression(
            optimizer="SQN", engine="fused", valset_frac=None,
            batches_per_epoch=B, nepochs=2, shuffle_data=False,
            decr_step_size=None, mem_size=3, bfgs_upd_freq=L,
            device="cpu").fit(X, Y)
        model = counts[:]
        counts.clear()
        trainer = FusedTrainer(
            "SQN", SQNConfig.create(mem_size=3, bfgs_upd_freq=L),
            lambda x, b: tl.multinomial_logistic_grad(x, b[0], b[1], b[2],
                                                      1e-3),
            hess_vec_fn=lambda x, v, b: tl.multinomial_logistic_hessvec(
                x, v, b[0], b[1], b[2], 1e-3))
        np.random.seed(1)
        w0 = torch.from_numpy(np.random.normal(size=(f + 1) * k)).float()
        trainer.epochs(trainer.init(w0), (
            torch.from_numpy(X).reshape(B, -1, f),
            torch.from_numpy(Y).reshape(B, -1, k),
            torch.full((B, n // B), 1.0 / n)), 0.1, nepochs=2, aligned=True)
    finally:
        FusedTrainer._epoch_at = orig
    assert len(model) == len(counts) == 2
    assert [m - b for m, b in zip(model, counts)] == [B // L] * 2
