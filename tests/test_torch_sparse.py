"""The torch port's padded-COO sparse losses and sparse logistic fits
against the port's dense forms and the JAX package's sparse forms.

Counterpart of ``test_sparse.py``.  ``csr_to_padded`` is host numpy in
both packages and must give the same arrays.  The scatter-add is
``index_add``, which on CUDA accumulates with atomics, so the sparse
forms are held within a tolerance, never by bits: in float64 against the
dense closed forms ``test_sparse.py``'s rtol 1e-12 (loss, predictions)
and rtol 1e-9 / 1e-10, atol 1e-12 (gradients, Hessian-vector products);
fits against the JAX package's, rtol 1e-9 and atol 1e-12; a CSR fit
against the fit of its densified copy, rtol 1e-9 and atol 1e-12.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.models import sparse as js  # noqa: E402
from stochqn_tpu.models.logistic import (  # noqa: E402
    StochasticLogisticRegression as JaxLR)
from stochqn_tpu_torch.models import losses  # noqa: E402
from stochqn_tpu_torch.models import sparse as ts  # noqa: E402
from stochqn_tpu_torch.models.logistic import (  # noqa: E402
    StochasticLogisticRegression, _padded)

RTOL, ATOL = 1e-9, 1e-12


def _random_csr(rng, b, nf, density=0.1):
    return sp.random(b, nf, density=density, format="csr",
                     random_state=np.random.RandomState(rng.integers(1 << 30)),
                     data_rvs=lambda k: rng.standard_normal(k))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_csr_to_padded_matches_jax(rng):
    X = _random_csr(rng, 13, 40, density=0.2)
    idx, val = ts.csr_to_padded(X, dtype=np.float64)
    jidx, jval = js.csr_to_padded(X, dtype=np.float64)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(val, jval)
    assert idx.dtype == np.int32 and idx.shape[1] % 8 == 0
    dense = np.zeros((13, 40))
    for r in range(13):
        np.add.at(dense[r], idx[r], val[r])
    np.testing.assert_allclose(dense, X.toarray(), rtol=1e-12)


def test_csr_to_padded_dense_input_and_cap(rng):
    X = rng.standard_normal((5, 12))
    for cap in (None, 3):
        got = ts.csr_to_padded(X, max_nnz=cap, dtype=np.float64)
        want = js.csr_to_padded(X, max_nnz=cap, dtype=np.float64)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    idx2, _ = ts.csr_to_padded(X, max_nnz=3, dtype=np.float64)
    for r in range(5):
        top = np.sort(np.argsort(-np.abs(X[r]))[:3])
        np.testing.assert_array_equal(np.sort(idx2[r]), top)
    with pytest.raises(ValueError):
        ts.csr_to_padded(X, max_nnz=0)


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_binary_sparse_dense_and_jax_parity(rng, intercept, weighted):
    b, nf, reg = 17, 29, 0.37
    X = _random_csr(rng, b, nf, density=0.15)
    idx, val = ts.csr_to_padded(X, dtype=np.float64)
    y = rng.integers(0, 2, b) * 2.0 - 1.0
    sw = rng.uniform(0.5, 1.5, b) if weighted else None
    w = rng.standard_normal(nf + intercept)
    v = rng.standard_normal(nf + intercept)
    T = dict(w=_t(w), v=_t(v), idx=_t(idx), val=_t(val), y=_t(y),
             sw=None if sw is None else _t(sw), Xd=_t(X.toarray()))
    J = {k: (None if a is None else jnp.asarray(a.numpy()))
         for k, a in T.items()}

    def check(name, dense, args, rtol, atol=0.0):
        got = getattr(ts, f"sparse_binary_logistic_{name}")(
            *[T[a] if isinstance(a, str) else a for a in args]).numpy()
        want_dense = dense.numpy()
        want_jax = np.asarray(getattr(js, f"sparse_binary_logistic_{name}")(
            *[J[a] if isinstance(a, str) else a for a in args]))
        np.testing.assert_allclose(got, want_dense, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got, want_jax, rtol=rtol, atol=atol)
    check("loss", losses.binary_logistic_loss(T["w"], T["Xd"], T["y"],
                                              T["sw"], reg),
          ("w", "idx", "val", "y", nf, "sw", reg), 1e-12)
    check("grad", losses.binary_logistic_grad(T["w"], T["Xd"], T["y"],
                                              T["sw"], reg),
          ("w", "idx", "val", "y", nf, "sw", reg), 1e-10, ATOL)
    check("hessvec", losses.binary_logistic_hessvec(
        T["w"], T["v"], T["Xd"], T["y"], T["sw"], reg),
        ("w", "v", "idx", "val", "y", nf, "sw", reg), 1e-10, ATOL)
    check("predict_proba", losses.binary_logistic_predict_proba(T["w"],
                                                                T["Xd"]),
          ("w", "idx", "val", nf), 1e-12)


@pytest.mark.parametrize("intercept", [True, False])
def test_multinomial_sparse_dense_and_jax_parity(rng, intercept):
    b, nf, k, reg = 11, 23, 5, 0.21
    X = _random_csr(rng, b, nf, density=0.2)
    idx, val = ts.csr_to_padded(X, dtype=np.float64)
    Y = np.eye(k)[rng.integers(0, k, b)]
    sw = rng.uniform(0.5, 1.5, b)
    w = rng.standard_normal(k * (nf + intercept))
    v = rng.standard_normal(k * (nf + intercept))
    T = dict(w=_t(w), v=_t(v), idx=_t(idx), val=_t(val), Y=_t(Y), sw=_t(sw),
             Xd=_t(X.toarray()))
    J = {key: jnp.asarray(a.numpy()) for key, a in T.items()}
    cases = [
        ("loss", losses.multinomial_logistic_loss(
            T["w"], T["Xd"], T["Y"], T["sw"], reg),
         ("w", "idx", "val", "Y", nf, "sw", reg), 1e-12),
        ("grad", losses.multinomial_logistic_grad(
            T["w"], T["Xd"], T["Y"], T["sw"], reg),
         ("w", "idx", "val", "Y", nf, "sw", reg), 1e-9),
        ("hessvec", losses.multinomial_logistic_hessvec(
            T["w"], T["v"], T["Xd"], T["Y"], T["sw"], reg),
         ("w", "v", "idx", "val", "Y", nf, "sw", reg), 1e-9),
        ("predict_proba", losses.multinomial_logistic_predict_proba(
            T["w"], T["Xd"], k), ("w", "idx", "val", nf, k), 1e-12),
    ]
    for name, dense, args, rtol in cases:
        fn = f"sparse_multinomial_logistic_{name}"
        got = getattr(ts, fn)(*[T[a] if isinstance(a, str) else a
                                for a in args]).numpy()
        want_jax = np.asarray(getattr(js, fn)(
            *[J[a] if isinstance(a, str) else a for a in args]))
        np.testing.assert_allclose(got, dense.numpy(), rtol=rtol, atol=ATOL)
        np.testing.assert_allclose(got, want_jax, rtol=rtol, atol=ATOL)


def test_sparse_grad_and_hessvec_match_autodiff(rng):
    """The scatter gradient equals ``torch.func.grad`` of the loss, and the
    closed-form Hessian-vector product ``torch.func.jvp`` of it: the
    gather/scatter algebra locked independently of the dense forms, and
    the sparse gradient transformable."""
    b, nf = 9, 21
    X = _random_csr(rng, b, nf, density=0.25)
    idx, val = (_t(a) for a in ts.csr_to_padded(X, dtype=np.float64))
    y = _t(rng.integers(0, 2, b) * 2.0 - 1.0)
    w = _t(rng.standard_normal(nf + 1))
    v = _t(rng.standard_normal(nf + 1))
    g_auto = torch.func.grad(lambda ww: ts.sparse_binary_logistic_loss(
        ww, idx, val, y, nf, None, 0.11))(w)
    g_ours = ts.sparse_binary_logistic_grad(w, idx, val, y, nf, None, 0.11)
    np.testing.assert_allclose(g_ours.numpy(), g_auto.numpy(), rtol=1e-10,
                               atol=ATOL)
    hv_auto = losses.hvp_from_grad(
        lambda ww: ts.sparse_binary_logistic_grad(ww, idx, val, y, nf, None,
                                                  0.11))(w, v)
    hv_ours = ts.sparse_binary_logistic_hessvec(w, v, idx, val, y, nf, None,
                                                0.11)
    np.testing.assert_allclose(hv_ours.numpy(), hv_auto.numpy(), rtol=1e-10,
                               atol=ATOL)


def test_fused_sqn_on_sparse_ctr_batches_matches_jax(rng):
    """Fused SQN over padded-COO batches (the Criteo-shaped configuration,
    BASELINE config 5): the loss falls, and the port lands on the JAX
    package's iterate."""
    from stochqn_tpu.core.config import SQNConfig as JCfg
    from stochqn_tpu.fused import FusedTrainer as JTrainer
    from stochqn_tpu_torch import FusedTrainer, SQNConfig

    nf, b, nb, k = 4096, 32, 8, 8
    w_true = np.zeros(nf)
    hot = rng.choice(nf, 64, replace=False)
    w_true[hot] = rng.standard_normal(64) * 2.0
    idx = rng.integers(0, nf, (nb, b, k)).astype(np.int32)
    val = rng.standard_normal((nb, b, k))
    z = np.einsum("nbk,nbk->nb", val, np.take(w_true, idx))
    y = np.where(rng.uniform(size=z.shape) < 1 / (1 + np.exp(-z)), 1.0, -1.0)

    def funs(mod, data):
        def grad_fn(x, batch):
            return mod.sparse_binary_logistic_grad(x, *batch, nf, None, 1e-3)

        def obj_fn(x, batch):
            return mod.sparse_binary_logistic_loss(x, *batch, nf, None, 1e-3)
        return grad_fn, obj_fn

    cfg_kw = dict(mem_size=5, bfgs_upd_freq=4, use_grad_diff=True)
    tdata = (_t(idx), _t(val), _t(y))
    grad_fn, obj_fn = funs(ts, tdata)
    trainer = FusedTrainer("SQN", SQNConfig.create(**cfg_kw), grad_fn,
                           obj_fn=obj_fn)
    state = trainer.init(torch.zeros(nf, dtype=torch.float64))

    def total_loss(x):
        return float(sum(obj_fn(x, tuple(a[i] for a in tdata))
                         for i in range(nb)))
    l0 = total_loss(state.x)
    state, _ = trainer.epochs(state, tdata, 0.5, nepochs=6, aligned=True)
    l1 = total_loss(state.x)
    assert np.isfinite(l1) and l1 < 0.7 * l0, (l0, l1)

    jdata = tuple(jnp.asarray(a) for a in (idx, val, y))
    jgrad, jobj = funs(js, jdata)
    jt = JTrainer("SQN", JCfg.create(**cfg_kw), jgrad, obj_fn=jobj)
    jstate = jt.init(jnp.zeros(nf))
    epoch = jax.jit(jt.epoch, static_argnames=("aligned",))
    for _ in range(6):
        jstate, _ = epoch(jstate, jdata, jnp.float64(0.5), aligned=True)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["protocol", "fused"])
def test_logistic_model_sparse_matches_dense_and_jax(rng, engine):
    """``StochasticLogisticRegression`` on scipy CSR input trains through
    the padded-COO forms: the same steps as the fit of its densified copy
    and as the JAX package's CSR fit (unshuffled fused: the fused shuffle
    is a torch.Generator's)."""
    nf, n = 512, 600
    X = _random_csr(rng, n, nf, density=0.05)
    w_true = rng.standard_normal(nf)
    y = (X @ w_true + 0.1 * rng.standard_normal(n) > 0).astype(np.float64)
    kw = dict(reg_param=1e-4, optimizer="SQN", step_size=1.0,
              valset_frac=None, nepochs=10, batches_per_epoch=10,
              engine=engine, random_state=3,
              shuffle_data=engine == "protocol")
    clf = StochasticLogisticRegression(dtype=torch.float64, device="cpu",
                                       **kw).fit(X, y)
    dense = StochasticLogisticRegression(dtype=torch.float64, device="cpu",
                                         **kw).fit(X.toarray(), y)
    ref = JaxLR(dtype=np.float64, **kw).fit(X, y)
    np.testing.assert_allclose(clf.x_, dense.x_, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(clf.x_, np.asarray(ref.x_), rtol=RTOL,
                               atol=ATOL)
    assert (clf.predict(X) == y).mean() > 0.85
    proba = clf.predict_proba(X[:5])
    assert proba.shape == (5, 2)
    np.testing.assert_allclose(proba, dense.predict_proba(X[:5].toarray()),
                               rtol=1e-12)


def test_protocol_engine_sparse_pins_padded_width(rng):
    """fit() derives the padded width k from the full matrix so every batch
    has the same [B, k] shape, and the conversion is memoized on the batch
    object."""
    nf, n = 64, 120
    X = _random_csr(rng, n, nf, density=0.1)
    w_true = rng.standard_normal(nf)
    y = (X @ w_true > 0).astype(np.float64)
    clf = StochasticLogisticRegression(
        reg_param=1e-4, optimizer="SQN", step_size=0.5, valset_frac=None,
        nepochs=2, batches_per_epoch=4, engine="protocol", random_state=0,
        use_grad_diff=True, device="cpu")
    clf.fit(X, y)
    max_nnz = int(np.diff(X.tocsr().indptr).max())
    assert clf._pad_k is not None and clf._pad_k >= max_nnz
    assert clf._pad_k % 8 == 0
    idx_a, _ = _padded(X[:10].tocsr(), torch.float64, clf._pad_k)
    idx_b, _ = _padded(X[10:13].tocsr(), torch.float64, clf._pad_k)
    assert idx_a.shape[1] == idx_b.shape[1] == clf._pad_k
    Xb = X[:10].tocsr()
    first = _padded(Xb, torch.float64, clf._pad_k)
    second = _padded(Xb, torch.float64, clf._pad_k)
    assert first[0] is second[0] and first[1] is second[1]
    assert first[0].dtype == torch.int64 and first[1].dtype == torch.float64


def test_padded_pinned_width_never_truncates():
    """A batch denser than the pinned width widens instead of dropping
    features."""
    dense = np.zeros((4, 32))
    dense[0, :20] = 1.0          # 20 nnz in one row
    idx, val = _padded(sp.csr_matrix(dense), torch.float64, 8)
    assert idx.shape[1] >= 20
    assert int((val[0] != 0).sum()) == 20
