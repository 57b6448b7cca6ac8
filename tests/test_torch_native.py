"""``backend="native"`` in the torch port's free mode against the JAX
package's native tier and the port's own torch backend.

Mirrors the Python tests of ``tests/test_native.py`` (the C, C++ and CMake
example tests there test the library, not a package, and are not
repeated).  Each trajectory runs three optimizers in lockstep on the same
quadratic: the port's native backend, the JAX package's native backend
and the port's ``backend="torch"`` on the CPU.  The two native backends
load libraries built from the same ``native/src/capi.cpp`` with the same
flags, so they are held bit for bit; the torch backend at
``tests/test_native.py``'s tolerance, rtol 1e-8 and atol 1e-10 (float64
summed in other orders).

Skipped where there is no ``g++``, as ``tests/test_native.py`` is.
"""
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from stochqn_tpu import free as jax_free  # noqa: E402
from stochqn_tpu_torch import free as tfree  # noqa: E402
from stochqn_tpu_torch import native_backend  # noqa: E402

RTOL, ATOL = 1e-8, 1e-10
SEED = 1234     # tests/conftest.py's rng: the inputs of tests/test_native.py


@pytest.fixture(autouse=True)
def compiler():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")


def _quad(rng, n, nb=16):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T
    return a, rng.standard_normal((nb, n))


def _answer(opt, req, a, centers, b):
    """``tests/test_native.py``'s evaluations of the request."""
    task, at = req["task"], req["requested_on"]
    cmean = centers.mean(axis=0)
    if task in ("calc_grad", "calc_grad_same_batch"):
        opt.update_gradient(a @ (np.asarray(at) - centers[b % 16]))
    elif task == "calc_grad_big_batch":
        opt.update_gradient(a @ (np.asarray(at) - cmean))
    elif task == "calc_hess_vec":
        opt.update_hess_vec(a @ np.asarray(at[1]))
    elif task == "calc_fun_val_batch":
        d = np.asarray(at) - cmean
        opt.update_function(0.5 * d @ a @ d)


def _drive(cls, kw, a, centers, x0, nsteps, step=0.05):
    """The port's native, the JAX package's native and the port's torch
    backend in lockstep; returns the tasks seen."""
    opts = (cls["torch"](backend="native", **kw),
            cls["jax"](backend="native", **kw),
            cls["torch"](device="cpu", **kw))
    xs = [x0.copy() for _ in opts]
    reqs = [o.run_optimizer(x, step) for o, x in zip(opts, xs)]
    b, seen = 0, []
    for it in range(nsteps):
        tn, jn, tt = reqs
        assert tn["task"] == jn["task"] == tt["task"], f"step {it}"
        assert tn["info"] == jn["info"] == tt["info"], f"step {it}"
        np.testing.assert_array_equal(xs[0], xs[1], err_msg=f"step {it}")
        np.testing.assert_allclose(xs[0], xs[2], rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {it}")
        pts = [r["requested_on"] for r in reqs]
        for p in zip(*(p if isinstance(p, tuple) else (p,) for p in pts)):
            np.testing.assert_array_equal(p[0], p[1], err_msg=f"step {it}")
            np.testing.assert_allclose(p[0], p[2], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {it}")
        seen.append(tn["task"])
        for o, r in zip(opts, reqs):
            _answer(o, r, a, centers, b)
        if tn["task"] == "calc_grad":
            b += 1
        reqs = [o.run_optimizer(x, step) for o, x in zip(opts, xs)]
    assert opts[0].niter == opts[1].niter == opts[2].niter > 0
    return seen


def _classes(name):
    return {"torch": getattr(tfree, name), "jax": getattr(jax_free, name)}


LOCKSTEP = {
    "olbfgs": ("oLBFGS_free", dict(mem_size=5), 10, 120),
    "sqn": ("SQN_free", dict(mem_size=4, bfgs_upd_freq=5), 10, 140),
    "sqn_grad_diff": ("SQN_free", dict(mem_size=4, bfgs_upd_freq=5,
                                       use_grad_diff=True), 9, 140),
    "adaqn": ("adaQN_free", dict(mem_size=4, fisher_size=12, bfgs_upd_freq=5,
                                 max_incr=1.01), 10, 150),
}


@pytest.mark.parametrize("case", sorted(LOCKSTEP))
def test_native_matches_jax_native_and_torch(case):
    name, kw, n, nsteps = LOCKSTEP[case]
    rng = np.random.default_rng(SEED)
    a, centers = _quad(rng, n)
    seen = _drive(_classes(name), kw, a, centers, rng.standard_normal(n),
                  nsteps)
    boundary = {"sqn": "calc_hess_vec", "sqn_grad_diff":
                "calc_grad_big_batch", "adaqn": "calc_fun_val_batch",
                "olbfgs": "calc_grad_same_batch"}[case]
    assert boundary in seen


FUZZ_CONFIGS = [
    ("oLBFGS_free", dict(mem_size=1, min_curvature=None)),
    ("oLBFGS_free", dict(mem_size=3, min_curvature=1e-4)),
    ("oLBFGS_free", dict(mem_size=7, hess_init=0.5, min_curvature=None)),
    ("oLBFGS_free", dict(mem_size=3, hess_init=1.5, min_curvature=1e-4,
                         y_reg=1e-2)),
    ("SQN_free", dict(mem_size=2, bfgs_upd_freq=2, min_curvature=None)),
    ("SQN_free", dict(mem_size=5, bfgs_upd_freq=3, min_curvature=1e-4)),
    ("SQN_free", dict(mem_size=3, bfgs_upd_freq=7, min_curvature=None,
                      y_reg=1e-2)),
    ("SQN_free", dict(mem_size=4, bfgs_upd_freq=3, use_grad_diff=True,
                      min_curvature=1e-4, y_reg=1e-2)),
    ("SQN_free", dict(mem_size=6, bfgs_upd_freq=10, use_grad_diff=True,
                      min_curvature=None)),
    ("adaQN_free", dict(mem_size=2, fisher_size=3, bfgs_upd_freq=3,
                        max_incr=None, min_curvature=None)),
    ("adaQN_free", dict(mem_size=3, fisher_size=5, bfgs_upd_freq=3,
                        max_incr=1.01, rmsprop_weight=0.9,
                        min_curvature=None)),
    ("adaQN_free", dict(mem_size=4, fisher_size=8, bfgs_upd_freq=5,
                        max_incr=None, rmsprop_weight=0.9, use_grad_diff=True,
                        y_reg=1e-2, min_curvature=None)),
    ("adaQN_free", dict(mem_size=2, fisher_size=3, bfgs_upd_freq=2,
                        max_incr=1.01, min_curvature=1e-4)),
    ("adaQN_free", dict(mem_size=3, fisher_size=5, bfgs_upd_freq=3,
                        max_incr=1.01, min_curvature=None, y_reg=1e-2)),
]


@pytest.mark.parametrize("i", range(len(FUZZ_CONFIGS)))
def test_native_fuzz_matches_jax_native_and_torch(i):
    """``tests/test_native.py``'s configuration sweep, curvature rejections
    and all: the whole trajectory agrees."""
    name, kw = FUZZ_CONFIGS[i]
    rng = np.random.default_rng(SEED)
    a, centers = _quad(rng, 6)
    _drive(_classes(name), kw, a, centers, rng.standard_normal(6), 70)


def test_native_validates_input_lengths():
    rng = np.random.default_rng(SEED)
    opt = tfree.oLBFGS_free(mem_size=3, backend="native")
    opt.run_optimizer(rng.standard_normal(6), 0.05)
    with pytest.raises(ValueError, match="expected 6"):
        opt.update_gradient([0.5])
    opt2 = tfree.SQN_free(mem_size=3, bfgs_upd_freq=2, backend="native")
    opt2.run_optimizer(rng.standard_normal(6), 0.05)
    with pytest.raises(ValueError, match="expected 6"):
        opt2.update_hess_vec(np.zeros(3))
    with pytest.raises(RuntimeError, match="before the first run_optimizer"):
        tfree.SQN_free(backend="native").update_gradient(np.zeros(6))


def test_native_adaqn_rejects_zero_fisher():
    """fisher_size=0 without use_grad_diff fails in the C core's guard,
    not silently as a one-row Fisher memory; with use_grad_diff it is
    fine."""
    opt = native_backend.NativeAdaQN(fisher_size=0, use_grad_diff=False)
    with pytest.raises(ValueError, match="invalid native"):
        opt.start(np.zeros(4))
    opt2 = native_backend.NativeAdaQN(fisher_size=0, use_grad_diff=True,
                                      max_incr=0.0)
    opt2.start(np.zeros(4))


def test_native_float32():
    """float32 (use_float=True): 20 iterations, finite, and the same bits
    as the JAX package's native float32 run."""
    rng = np.random.default_rng(SEED)
    a, centers = _quad(rng, 8)
    x0 = rng.standard_normal(8).astype(np.float32)
    xs = []
    for opt in (tfree.oLBFGS_free(mem_size=4, use_float=True,
                                  backend="native"),
                jax_free.oLBFGS_free(mem_size=4, use_float=True,
                                     backend="native")):
        x = x0.copy()
        req = opt.run_optimizer(x, 0.05)
        for _ in range(40):
            opt.update_gradient((a @ (np.asarray(req["requested_on"])
                                      - centers[0])).astype(np.float32))
            req = opt.run_optimizer(x, 0.05)
        assert opt.niter == 20
        assert np.all(np.isfinite(x)) and x.dtype == np.float32
        xs.append(x)
    np.testing.assert_array_equal(xs[0], xs[1])


def test_native_takes_tensors_and_writes_x_back():
    """Gradients as torch tensors, ``x`` written back in place, and the
    request points are copies that the next call does not change."""
    rng = np.random.default_rng(SEED)
    a, centers = _quad(rng, 5)
    opt = tfree.SQN_free(mem_size=2, bfgs_upd_freq=2, backend="native")
    x = rng.standard_normal(5)
    req = opt.run_optimizer(torch.from_numpy(x), 0.1)   # a tensor x0
    for _ in range(6):
        at = req["requested_on"]
        keep = np.array(at if not isinstance(at, tuple) else at[0])
        if req["task"] == "calc_hess_vec":
            opt.update_hess_vec(torch.from_numpy(a @ at[1]))
        else:
            opt.update_gradient(torch.from_numpy(a @ (at - centers[0])))
        req = opt.run_optimizer(x, 0.1)
        np.testing.assert_array_equal(
            keep, at if not isinstance(at, tuple) else at[0])
    np.testing.assert_array_equal(x, opt._native.x)
    assert opt.state is None and opt.device == torch.device("cpu")


def test_native_arguments():
    with pytest.raises(ValueError, match="C\\+\\+ core on the CPU"):
        tfree.oLBFGS_free(backend="native", device="cuda")
    with pytest.raises(ValueError, match="float32 or float64"):
        tfree.adaQN_free(backend="native", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="backend='torch' only"):
        tfree.SQN_free(backend="native", pairs_interleaved=True)
    with pytest.raises(ValueError, match="backend must be"):
        tfree.SQN_free(backend="jax", device="cpu")
    assert tfree.SQN_free(backend="native").dtype == torch.float64
    assert tfree.SQN_free(backend="native",
                          use_float=True).dtype == torch.float32
    with pytest.raises(ValueError, match="adopt_state"):
        tfree.SQN_free(backend="native").adopt_state(None)


def test_library_is_built_in_the_ports_tree():
    """The port builds its own copy of the library, under its git-ignored
    build tree and keyed by the sources and flags; the flags that fix the
    floating-point behaviour are the JAX bridge's."""
    from stochqn_tpu import native_backend as jax_native
    path = native_backend.library_path()
    assert "/stochqn_tpu_torch/build/native/" in path
    assert native_backend.native_available()
    assert native_backend.NUMERIC_FLAGS == jax_native.NUMERIC_FLAGS
