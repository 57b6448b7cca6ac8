"""The torch port's free-mode protocol tier (``SQN_free``, ``adaQN_free``,
``core/sqn.advance``, ``core/adaqn.advance``) against the JAX package's,
and against the port's own fused engine.

Both packages' classes are driven in lockstep on a stochastic quadratic
problem (``tests/test_state_machines.py``): each side is fed the numpy
gradient, Hessian-vector product or function value at the point it asked
for, and at every call the task, the ``iteration_info``, the iteration
number and ``x_changed_in_run`` must be equal, and ``requested_on`` and
``x`` agree within rtol 1e-5 in float32 and 1e-10 in float64 (each side
sums in its own order; atol 1e-6 and 1e-12 for entries near zero).  On the
CPU the port's kernel wrappers run their plain versions.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu import free as jax_free  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               SQN_free, SQNConfig, adaQN_free,
                               adaqn_state_from_numpy, adaqn_state_to_numpy,
                               sqn_state_from_numpy, sqn_state_to_numpy)
from stochqn_tpu_torch.core import adaqn, sqn  # noqa: E402
from stochqn_tpu_torch.core.protocol import (AdvanceResult,  # noqa: E402
                                             result, select)
from stochqn_tpu_torch.fused import _flat  # noqa: E402
from stochqn_tpu_torch.models import losses  # noqa: E402

CPU = torch.device("cpu")
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "float64": dict(rtol=1e-10, atol=1e-12)}


class QuadProblem:
    """f_b(x) = 0.5 (x - c_b)^T A (x - c_b) for per-batch centers c_b."""

    def __init__(self, seed, n, nbatches=16):
        rng = np.random.default_rng(seed)
        q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        self.a = q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T
        self.centers = rng.standard_normal((nbatches, n))
        self.x0 = rng.standard_normal(n)
        self.nan_calls = ()
        self.spike_calls = ()

    def grad(self, x, b, call):
        if call in self.nan_calls:
            return np.full(x.shape, np.nan)
        return self.a @ (x - self.centers[b % len(self.centers)])

    def big_grad(self, x):
        return self.a @ (x - self.centers.mean(axis=0))

    def hess_vec(self, v):
        return self.a @ v

    def fval(self, x, call):
        if call in self.spike_calls:
            return 1e30
        r = x - self.centers.mean(axis=0)
        return 0.5 * r @ self.a @ r


def _feed(opt, req, problem, b, calls):
    """Answer ``req`` from ``problem`` at the point ``opt`` asked for."""
    task = req["task"]
    if task == "calc_grad":
        opt.update_gradient(problem.grad(np.asarray(req["requested_on"],
                                                    np.float64), b,
                                         calls["grad"]))
    elif task == "calc_grad_big_batch":
        opt.update_gradient(problem.big_grad(
            np.asarray(req["requested_on"], np.float64)))
    elif task == "calc_hess_vec":
        opt.update_hess_vec(problem.hess_vec(
            np.asarray(req["requested_on"][1], np.float64)))
    elif task == "calc_fun_val_batch":
        opt.update_function(problem.fval(
            np.asarray(req["requested_on"], np.float64), calls["fval"]))
    else:
        raise AssertionError(task)


def _points(req):
    pts = req["requested_on"]
    return pts if isinstance(pts, tuple) else (pts,)


def _drive(topt, jopt, problem, nsteps, dtype, step_size=0.05):
    """Run both implementations side by side, asserting lockstep.  Returns
    the tasks and infos seen."""
    tol = TOL[dtype]
    x_t = problem.x0.astype(dtype)
    x_j = x_t.copy()
    treq = topt.run_optimizer(x_t, step_size)
    jreq = jopt.run_optimizer(x_j, step_size)
    b = 0
    calls = {"grad": 0, "fval": 0}
    seen = []
    for it in range(nsteps):
        assert treq["task"] == jreq["task"], f"call {it}"
        assert treq["info"] == jreq["info"], f"call {it}"
        seen.append((treq["task"], treq["info"]["iteration_info"]))
        np.testing.assert_allclose(x_t, x_j, err_msg=f"call {it}: x", **tol)
        for pt, pj in zip(_points(treq), _points(jreq)):
            assert isinstance(pt, np.ndarray) and pt.dtype == np.dtype(dtype)
            np.testing.assert_allclose(pt, np.asarray(pj),
                                       err_msg=f"call {it}: requested_on",
                                       **tol)
        task = treq["task"]
        if task == "calc_grad":
            b += 1
            calls["grad"] += 1
        elif task == "calc_fun_val_batch":
            calls["fval"] += 1
        _feed(topt, treq, problem, b, calls)
        _feed(jopt, jreq, problem, b, calls)
        treq = topt.run_optimizer(x_t, step_size)
        jreq = jopt.run_optimizer(x_j, step_size)
    return seen


SQN_CASES = {
    "hessvec": dict(mem_size=4, bfgs_upd_freq=5),
    "grad_diff": dict(mem_size=4, bfgs_upd_freq=5, use_grad_diff=True,
                      y_reg=1e-2),
}
ADAQN_CASES = {
    "fisher": dict(mem_size=4, fisher_size=12, bfgs_upd_freq=5,
                   max_incr=1.01),
    "grad_diff_rmsprop": dict(mem_size=4, fisher_size=None, bfgs_upd_freq=5,
                              max_incr=1.01, rmsprop_weight=0.9,
                              use_grad_diff=True),
    "no_max_incr": dict(mem_size=3, fisher_size=10, bfgs_upd_freq=4,
                        max_incr=None),
}


def _pair(kind, kw, dtype):
    tcls, jcls = {"SQN": (SQN_free, jax_free.SQN_free),
                  "adaQN": (adaQN_free, jax_free.adaQN_free)}[kind]
    use_float = dtype == "float32"
    return (tcls(**kw, use_float=use_float, device=CPU),
            jcls(**kw, use_float=use_float))


@pytest.mark.parametrize("case,dtype", [
    ("hessvec", "float64"), ("hessvec", "float32"), ("grad_diff", "float64"),
    ("grad_diff", "float32")])
def test_sqn_free_matches_jax_in_lockstep(case, dtype):
    topt, jopt = _pair("SQN", SQN_CASES[case], dtype)
    seen = _drive(topt, jopt, QuadProblem(1234, 10), 150, dtype)
    tasks = {t for t, _ in seen}
    want = "calc_grad_big_batch" if case == "grad_diff" else "calc_hess_vec"
    assert tasks == {"calc_grad", want}
    assert int(topt.state.mem.count) == 4
    assert topt.state.x.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("case,dtype", [
    ("fisher", "float64"), ("fisher", "float32"),
    ("grad_diff_rmsprop", "float64"), ("grad_diff_rmsprop", "float32"),
    ("no_max_incr", "float64")])
def test_adaqn_free_matches_jax_in_lockstep(case, dtype):
    topt, jopt = _pair("adaQN", ADAQN_CASES[case], dtype)
    seen = _drive(topt, jopt, QuadProblem(1234, 10), 160, dtype)
    tasks = {t for t, _ in seen}
    want = {"calc_grad"}
    if case != "no_max_incr":
        want.add("calc_fun_val_batch")
    if case == "grad_diff_rmsprop":
        want.add("calc_grad_big_batch")
    assert tasks == want
    assert int(topt.state.mem.count) == int(jopt.state.mem.count)


def test_adaqn_func_increase_reverts_like_jax():
    """A forced ``func_increased`` rejection: both flush their memories and
    revert ``x`` to the archived average."""
    problem = QuadProblem(1234, 6)
    problem.spike_calls = (2,)      # the second f request -> huge value
    topt, jopt = _pair("adaQN", dict(mem_size=3, fisher_size=10,
                                     bfgs_upd_freq=4, max_incr=1.01),
                       "float64")
    seen = _drive(topt, jopt, problem, 60, "float64")
    infos = [i for _, i in seen]
    k = infos.index("func_increased")
    assert seen[k][0] == "calc_grad"     # the rejection resumes the loop
    assert seen[k - 1][0] == "calc_fun_val_batch"


@pytest.mark.parametrize("kind", ["SQN", "adaQN"])
def test_nan_gradient_rejection_matches_jax(kind):
    """A NaN gradient gives ``search_direction_was_nan``, a flushed pair
    memory and an unchanged ``x`` on both sides.  SQN recovers with the
    next finite gradient; adaQN's squared-gradient accumulator keeps the
    NaN, as in the reference, so every later step is rejected too."""
    problem = QuadProblem(1234, 8)
    problem.nan_calls = (14, 15)    # after the ring holds a pair
    kw = (SQN_CASES["hessvec"] if kind == "SQN"
          else ADAQN_CASES["no_max_incr"])
    topt, jopt = _pair(kind, kw, "float64")
    seen = _drive(topt, jopt, problem, 60, "float64")
    nans = [i for _, i in seen].count("search_direction_was_nan")
    assert nans == 2 if kind == "SQN" else nans > 2
    assert bool(torch.isfinite(topt.state.x).all())


# --- a JAX state converted mid-protocol continues identically --------------
def _jax_numpy(state):
    def conv(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f.name] = (conv(v) if dataclasses.is_dataclass(v)
                           else v if isinstance(v, bool) else np.asarray(v))
        return out
    return conv(state)


MID_PROTOCOL = {
    # kind, constructor kwargs, the sections to convert in
    "sqn_hessvec": ("SQN", SQN_CASES["hessvec"], (1, 4)),
    "sqn_grad_diff": ("SQN", SQN_CASES["grad_diff"], (2, 3)),
    "adaqn_grad_diff": ("adaQN", ADAQN_CASES["grad_diff_rmsprop"],
                        (2, 3, 4, 5)),
    "adaqn_fisher": ("adaQN", ADAQN_CASES["fisher"], (3, 5)),
}


@pytest.mark.parametrize("case", list(MID_PROTOCOL))
def test_converted_jax_state_continues_identically(case):
    """The JAX class runs to a request in each section; there its state
    crosses through ``convert`` and both ``advance`` functions take the
    next 12 transitions on the same feeds: the same codes, and the same
    state to float64 rounding."""
    kind, kw, sections = MID_PROTOCOL[case]
    problem = QuadProblem(99, 8)
    from_numpy, to_numpy, mod = {
        "SQN": (sqn_state_from_numpy, sqn_state_to_numpy, sqn),
        "adaQN": (adaqn_state_from_numpy, adaqn_state_to_numpy, adaqn),
    }[kind]
    jopt = getattr(jax_free, f"{kind}_free")(**kw)
    cfg = (SQN_free if kind == "SQN" else adaQN_free)(**kw, device=CPU)._cfg
    x = problem.x0.copy()
    eta = 0.05
    pending = set(sections)
    req = jopt.run_optimizer(x, eta)
    b, calls = 0, {"grad": 0, "fval": 0}
    for _ in range(60):
        section = int(jopt.state.section)
        if section in pending:
            pending.discard(section)
            _continue_both(jopt, mod, cfg, from_numpy, to_numpy, problem,
                           req, b, np.zeros(8) if kind == "SQN" else 0.0, eta)
        if req["task"] == "calc_grad":
            b += 1
        _feed(jopt, req, problem, b, calls)
        req = jopt.run_optimizer(x, eta)
    assert not pending, f"sections never reached: {pending}"


def _continue_both(jopt, mod, cfg, from_numpy, to_numpy, problem, req, b,
                   extra, eta):
    """From ``jopt``'s current state (not disturbed), 12 transitions of
    the JAX ``advance`` and of the port's on the same numpy feeds."""
    jst = jopt.state
    tst = from_numpy(_jax_numpy(jst), device=CPU)
    task = req["task"]
    for k in range(12):
        # the evaluation the pending request asked for, at the JAX point
        if task == "calc_hess_vec":
            grad, extra = np.zeros(8), problem.hess_vec(
                np.asarray(jst.mem.s_pending))
        elif task == "calc_fun_val_batch":
            point = jst.x_avg_prev if int(jst.section) in (2, 3) else jst.x_sum
            grad, extra = np.zeros(8), problem.fval(np.asarray(point), -1)
        elif task == "calc_grad_big_batch":
            point = jst.x_avg_prev if int(jst.section) == 2 else jst.x_sum
            grad = problem.big_grad(np.asarray(point))
        else:
            b += 1
            grad = problem.grad(np.asarray(jst.x), b, -1)
        jst, jres = jopt._advance_jit(jopt._cfg, jst, jnp.asarray(grad),
                                      jnp.asarray(extra), jnp.asarray(eta))
        textra = (torch.from_numpy(np.asarray(extra))
                  if np.ndim(extra) else float(extra))
        tst, tres = mod.advance(cfg, tst, torch.from_numpy(grad), textra, eta)
        assert isinstance(tres, AdvanceResult)
        assert (int(tres.task), int(tres.info), bool(tres.x_changed)) == (
            int(jres.task), int(jres.info), bool(jres.x_changed)), k
        task = jax_free.TASK_NAMES[jax_free.Task(int(jres.task))]
        got, want = to_numpy(tst), _jax_numpy(jst)
        assert got["section"] == want["section"]
        assert got["niter"] == want["niter"]
        for name in ("x", "x_sum", "x_avg_prev", "grad_prev"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-10,
                                       atol=1e-12, err_msg=f"{k}: {name}")
        for name in ("s_pending", "head", "count", "gamma"):
            np.testing.assert_allclose(got["mem"][name], want["mem"][name],
                                       rtol=1e-9, atol=1e-12,
                                       err_msg=f"{k}: mem.{name}")


# --- the wrapper's own contract --------------------------------------------
def rosen_grad(x):
    g = np.zeros_like(x)
    g[:-1] = -400 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
    g[1:] += 200 * (x[1:] - x[:-1] ** 2)
    return g


def rosen_hessvec(x, v, eps=1e-7):
    return (rosen_grad(x + eps * v) - rosen_grad(x - eps * v)) / (2 * eps)


def test_sqn_free_rosenbrock_hessvec():
    """Free-mode Rosenbrock minimization through the request loop, with
    the known optimum (1, 1) as ground truth
    (``tests/test_rosenbrock.py``)."""
    x = np.array([-1.2, 1.0])
    opt = SQN_free(mem_size=7, bfgs_upd_freq=4, device=CPU)
    req = opt.run_optimizer(x, 2.0e-3)
    for _ in range(40000):
        task = req["task"]
        if task in ("calc_grad", "calc_grad_big_batch"):
            opt.update_gradient(rosen_grad(np.asarray(req["requested_on"])))
        elif task == "calc_hess_vec":
            xr, vr = req["requested_on"]
            opt.update_hess_vec(rosen_hessvec(np.asarray(xr),
                                              np.asarray(vr)))
        req = opt.run_optimizer(x, 2.0e-3)
        if np.abs(rosen_grad(x)).max() < 1e-6:
            break
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-3)


@pytest.mark.parametrize("cls", [SQN_free, adaQN_free])
def test_length_checks_write_back_and_repr(cls):
    opt = cls(mem_size=3, bfgs_upd_freq=4, device=CPU)
    assert "not yet initialized" in repr(opt) and "device=cpu" in repr(opt)
    assert opt.n is None and opt.niter == 0
    x = np.linspace(-1.0, 1.0, 5)
    keep = x.copy()
    req = opt.run_optimizer(x, 0.1)
    assert req["task"] == "calc_grad" and opt.n == 5
    assert req["info"] == {"x_changed_in_run": False, "iteration_number": 0,
                           "iteration_info": "no_problems_encountered"}
    assert req["requested_on"] is not x
    np.testing.assert_array_equal(req["requested_on"], keep)
    with pytest.raises(ValueError, match="gradient has 4 elements, "
                       "expected 5"):
        opt.update_gradient(np.ones(4))
    if cls is SQN_free:
        with pytest.raises(ValueError, match="hess_vec has 6 elements"):
            opt.update_hess_vec(np.ones(6))
    # a torch tensor of the optimizer's dtype and device is used as it is
    g = torch.ones(5, dtype=torch.float64)
    opt.update_gradient(g)
    assert opt._gradient.data_ptr() == g.data_ptr()
    req = opt.run_optimizer(x, 0.1)
    assert req["info"]["x_changed_in_run"] and opt.niter == 1
    assert (x != keep).all()               # written back in place
    np.testing.assert_array_equal(x, opt.state.x.numpy())
    assert f"n=5, iteration 1" in repr(opt)
    assert repr(opt).startswith(f"{cls.__name__}(mem_size=3, ")
    # a list is consumed but cannot be written back
    x_list = [0.0] * 5
    assert opt.run_optimizer(x_list, 0.1)["task"] == "calc_grad"
    assert x_list == [0.0] * 5


def test_device_dtype_and_backend_arguments():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SQN_free()
    assert adaQN_free(backend="native").device == CPU
    with pytest.raises(ValueError, match="C\\+\\+ core on the CPU"):
        adaQN_free(backend="native", device="cuda")
    with pytest.raises(ValueError, match="float32 or float64"):
        SQN_free(backend="native", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="backend"):
        SQN_free(backend="jax", device=CPU)
    assert SQN_free(device=CPU).dtype == torch.float64
    assert SQN_free(device=CPU, use_float=True).dtype == torch.float32
    assert adaQN_free(device=CPU, dtype=np.float32).dtype == torch.float32
    assert adaQN_free(device=CPU, dtype=torch.float64,
                      use_float=True).dtype == torch.float64
    opt = adaQN_free(device=CPU, fisher_size=None)
    assert opt.use_grad_diff and opt.max_incr == 1.01
    assert opt.bfgs_upd_freq == 20
    opt = SQN_free(device=CPU, pairs_bf16=True)
    opt.run_optimizer(np.zeros(3), 0.1)
    assert opt.state.mem.s.dtype == torch.bfloat16
    assert opt.state.x.dtype == torch.float64
    opt = SQN_free(device=CPU, dtype="bfloat16")
    opt.run_optimizer(np.zeros(3, np.float32), 0.1)
    assert opt.state.x.dtype == opt.state.mem.s.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="rmsprop_weight"):
        adaQN_free(device=CPU, rmsprop_weight=1.5)


def test_result_and_select():
    res = result(101, torch.tensor(203), True, CPU)
    assert (res.task.dtype, res.info.dtype, res.x_changed.dtype) == (
        torch.int32, torch.int32, torch.bool)
    assert (int(res.task), int(res.info), bool(res.x_changed)) == (
        101, 203, True)
    a = sqn.init(torch.zeros(3), SQNConfig.create(mem_size=2))
    b = a.replace(x=torch.ones(3), niter=a.niter + 7,
                  mem=a.mem.replace(count=a.mem.count + 1))
    for pred, want in ((True, a), (False, b)):
        got = select(torch.tensor(pred), a, b)
        assert torch.equal(got.x, want.x) and int(got.niter) == int(
            want.niter) and int(got.mem.count) == int(want.mem.count)
    f = adaqn.init(torch.zeros(3), AdaQNConfig.create(fisher_size=2)).fisher
    with pytest.raises(ValueError, match="static fields differ"):
        select(torch.tensor(True), f, f.replace(shift=not f.shift))


# --- the slice as a whole: free mode reproduces the fused engine ----------
F, C, BS, L, ROUNDS, REG = 12, 5, 4, 4, 3, 0.1


def _multinomial():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((ROUNDS * L, BS, F)).astype(np.float32)
    Y = np.eye(C, dtype=np.float32)[np.argmax(
        X @ rng.standard_normal((F, C)), axis=-1)]
    x0 = (0.1 * rng.standard_normal((F + 1) * C)).astype(np.float32)
    return torch.from_numpy(X), torch.from_numpy(Y), x0


def _grad(x, batch):
    return losses.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def _obj(x, batch):
    return losses.multinomial_logistic_loss(x, batch[0], batch[1], None, REG)


def _hess_vec(x, v, batch):
    return losses.multinomial_logistic_hessvec(x, v, batch[0], batch[1],
                                               None, REG)


def _free_run(opt, X, Y, x0, eta):
    """The request loop on the fused engine's batches: minibatch b for the
    b-th ``calc_grad``, the round's L minibatches merged (the engine's
    order) for every boundary request.  Stops at the ``calc_grad`` request
    after the last boundary's work."""
    x = x0.copy()
    total = X.shape[0]
    req = opt.run_optimizer(x, eta)
    b = -1
    while True:
        task, at = req["task"], req["requested_on"]
        if task == "calc_grad":
            if opt.niter >= total:
                return x
            b += 1
            opt.update_gradient(_grad(torch.from_numpy(at), (X[b], Y[b])))
        else:
            r = b // L
            big = _flat((X[r * L:(r + 1) * L], Y[r * L:(r + 1) * L]))
            if task == "calc_grad_big_batch":
                opt.update_gradient(_grad(torch.from_numpy(at), big))
            elif task == "calc_hess_vec":
                opt.update_hess_vec(_hess_vec(torch.from_numpy(at[0]),
                                              torch.from_numpy(at[1]), big))
            else:
                opt.update_function(_obj(torch.from_numpy(at), big))
        req = opt.run_optimizer(x, eta)


@pytest.mark.parametrize("kind,kw", [
    ("SQN", dict()),
    ("SQN", dict(use_grad_diff=True)),
    ("adaQN", dict(fisher_size=10, max_incr=1.01)),
    ("adaQN", dict(fisher_size=10, max_incr=None)),
    ("adaQN", dict(fisher_size=None, max_incr=1.01, use_grad_diff=True)),
], ids=["sqn_hessvec", "sqn_grad_diff", "adaqn_fisher", "adaqn_no_guard",
        "adaqn_grad_diff"])
def test_free_mode_reproduces_the_fused_engine(kind, kw):
    """``SQN_free`` / ``adaQN_free`` fed with the port's own losses take
    the steps of the port's ``FusedTrainer`` on the same batches: ``x``
    within rtol 1e-5 (atol 1e-6) after 3 rounds in float32, the two tiers
    summing the same float32 terms in slightly different op orders."""
    X, Y, x0 = _multinomial()
    eta = 0.05
    kw = dict(mem_size=3, bfgs_upd_freq=L, min_curvature=1e-8, **kw)
    if kind == "SQN":
        trainer = FusedTrainer("SQN", SQNConfig.create(**kw), _grad,
                               hess_vec_fn=_hess_vec)
        opt = SQN_free(**kw, use_float=True, device=CPU)
    else:
        trainer = FusedTrainer("adaQN", AdaQNConfig.create(**kw), _grad,
                               obj_fn=_obj)
        opt = adaQN_free(**kw, use_float=True, device=CPU)
    state, infos = trainer.epochs(trainer.init(torch.from_numpy(x0)), (X, Y),
                                  eta, nepochs=1)
    x_free = _free_run(opt, X, Y, x0, eta)
    assert opt.niter == ROUNDS * L == int(state.niter)
    assert int(state.mem.count) == int(opt.state.mem.count)
    # a later boundary committed a pair, so steps ran on the two-loop
    assert (infos.flatten()[2 * L - 1::L] == 200).any()
    np.testing.assert_allclose(x_free, state.x.numpy(), rtol=1e-5, atol=1e-6)
