"""A bfloat16 iterate in the torch port against the JAX package.

``dtype=bfloat16`` in free mode, a bfloat16 ``x0`` in ``FusedTrainer`` and
the guided ``fit``: ``x``, the pair rows and every ``[n]`` field are
bfloat16, the memories' small math float32.  SQN's collapsed direction
takes ``direction_streamed`` on the gradient's exact float32 upcast (the
TPU kernel's own contract), and the direction comes back in bfloat16.

Both packages round every elementwise op to bfloat16, and both round a
Python number to bfloat16 before it meets a bfloat16 array (JAX's weak
typing; the port's ``cast_scalar``), but they sum products in their own
orders and, in the fused engine, evaluate the loss's softmax with other
roundings, so the same bits are not expected.  The rule (PERF.md section
2's for bfloat16): the info codes exact throughout, and the port's final
loss within twice the JAX bfloat16 run's distance to the JAX float32
run.  The gate's new route is held to the float32-gradient route bit for
bit (the upcast is exact), and the kernel wrapper to the Pallas kernel in
interpret mode at ``tests/test_torch_direction_kernel.py``'s tolerance.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu import free as jax_free  # noqa: E402
from stochqn_tpu import guided as jg  # noqa: E402
from stochqn_tpu.core import config as jcfg  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu_torch import (FusedTrainer, SQNConfig,  # noqa: E402
                               sqn_state_from_numpy, sqn_state_to_numpy)
from stochqn_tpu_torch import free as tfree  # noqa: E402
from stochqn_tpu_torch import guided as tg  # noqa: E402
from stochqn_tpu_torch.models import losses as tl  # noqa: E402
from stochqn_tpu_torch.ops import two_loop as ttwo_loop  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402
from test_torch_free import QuadProblem  # noqa: E402

F, C, BS, NB, M, L, REG, ETA = 12, 5, 4, 16, 3, 4, 0.1, 0.05
BF16 = torch.bfloat16
# tests/test_torch_direction_kernel.py's kernel tolerance
KRTOL, KATOL = 3e-5, 1e-4


def _within_rule(port, jax_bf16, jax_f32):
    """The port's loss within twice the JAX bfloat16 run's distance to
    its float32 run."""
    return abs(port - jax_bf16) <= 2 * abs(jax_bf16 - jax_f32)


def _bf16_values(a):
    """``a`` (float32) holds bfloat16 values exactly."""
    a = np.asarray(a, np.float32)
    return np.array_equal(torch.from_numpy(a).to(BF16).float().numpy(), a)


# ---------------------------------------------------------------------- #
# free mode
# ---------------------------------------------------------------------- #
def _answer(opt, req, prob, b):
    task, at = req["task"], req["requested_on"]
    if task in ("calc_grad", "calc_grad_same_batch"):
        opt.update_gradient(prob.grad(np.asarray(at, np.float64), b, -1))
    elif task == "calc_grad_big_batch":
        opt.update_gradient(prob.big_grad(np.asarray(at, np.float64)))
    elif task == "calc_hess_vec":
        opt.update_hess_vec(prob.hess_vec(np.asarray(at[1], np.float64)))
    else:
        opt.update_function(prob.fval(np.asarray(at, np.float64), -1))


def _run_free(opt, prob, nsteps):
    """``nsteps`` requests answered from ``prob``; returns ``x`` (float32),
    the request codes and the points asked for."""
    x = prob.x0.astype(np.float32)
    req = opt.run_optimizer(x, 0.05)
    b, codes, points = 0, [], []
    for _ in range(nsteps):
        codes.append((req["task"], req["info"]["iteration_info"]))
        at = req["requested_on"]
        points.append(np.asarray(at[0] if isinstance(at, tuple) else at,
                                 np.float32))
        if req["task"] == "calc_grad":
            b += 1
        _answer(opt, req, prob, b)
        req = opt.run_optimizer(x, 0.05)
    return x, codes, points


FREE_CASES = {
    "sqn_hessvec": ("SQN_free", dict(mem_size=4, bfgs_upd_freq=5)),
    "sqn_grad_diff": ("SQN_free", dict(mem_size=4, bfgs_upd_freq=5,
                                       use_grad_diff=True, y_reg=1e-2)),
    "olbfgs": ("oLBFGS_free", dict(mem_size=4)),
    "adaqn_fisher": ("adaQN_free", dict(mem_size=4, fisher_size=12,
                                        bfgs_upd_freq=5, max_incr=1.01)),
    "adaqn_grad_diff_rmsprop": ("adaQN_free", dict(
        mem_size=4, fisher_size=None, bfgs_upd_freq=5, max_incr=1.01,
        rmsprop_weight=0.9, use_grad_diff=True)),
}


@pytest.mark.parametrize("case", sorted(FREE_CASES))
def test_free_mode_matches_jax(case):
    """150 requests on a quadratic: every task and info code the JAX
    package's (the curvature and function-value decisions included), the
    points before the first boundary the same bits, and the final f by
    the rule."""
    name, kw = FREE_CASES[case]
    prob = QuadProblem(3, 10)
    cmean = prob.centers.mean(axis=0)

    def f(x):
        r = np.asarray(x, np.float64) - cmean
        return 0.5 * r @ prob.a @ r
    xj, cj, pj = _run_free(getattr(jax_free, name)(dtype=jnp.bfloat16, **kw),
                           prob, 150)
    xj32, _, _ = _run_free(getattr(jax_free, name)(dtype=jnp.float32, **kw),
                           prob, 150)
    topt = getattr(tfree, name)(dtype=BF16, device="cpu", **kw)
    xt, ct, pt = _run_free(topt, prob, 150)
    assert topt.state.x.dtype == BF16
    assert topt.state.mem.bwd_inv.dtype == torch.float32
    assert ct == cj
    upd = kw.get("bfgs_upd_freq", 1)
    for i in range(upd):
        np.testing.assert_array_equal(pt[i], pj[i], err_msg=f"request {i}")
    assert all(_bf16_values(p) for p in pt) and _bf16_values(xt)
    assert _within_rule(f(xt), f(xj), f(xj32)), (f(xt), f(xj), f(xj32))


def test_requested_on_is_float32_holding_bfloat16_values():
    """numpy has no bfloat16: the points come back as float32 arrays (the
    JAX package's are ml_dtypes bfloat16) with the same values, and a
    float32 ``x`` gets the iterate written back."""
    prob = QuadProblem(5, 6)
    kw = dict(mem_size=2, bfgs_upd_freq=2)
    topt = tfree.SQN_free(dtype="bfloat16", device="cpu", **kw)
    jopt = jax_free.SQN_free(dtype=jnp.bfloat16, **kw)
    xt, xj = prob.x0.astype(np.float32), prob.x0.astype(np.float32)
    rt, rj = topt.run_optimizer(xt, 0.1), jopt.run_optimizer(xj, 0.1)
    seen = set()
    for _ in range(12):
        seen.add(rt["task"])
        pts_t = rt["requested_on"] if isinstance(rt["requested_on"],
                                                 tuple) else (
            rt["requested_on"],)
        pts_j = rj["requested_on"] if isinstance(rj["requested_on"],
                                                 tuple) else (
            rj["requested_on"],)
        for a, b in zip(pts_t, pts_j):
            assert isinstance(a, np.ndarray) and a.dtype == np.float32
            assert b.dtype.name == "bfloat16"
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
        np.testing.assert_array_equal(xt, xj)
        _answer(topt, rt, prob, 0)
        _answer(jopt, rj, prob, 0)
        rt, rj = topt.run_optimizer(xt, 0.1), jopt.run_optimizer(xj, 0.1)
    assert "calc_hess_vec" in seen
    np.testing.assert_array_equal(xt, topt.state.x.float().numpy())


# ---------------------------------------------------------------------- #
# the fused engine
# ---------------------------------------------------------------------- #
def _data():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((NB, BS, F)).astype(np.float32)
    Y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (NB, BS))]
    x0 = (0.1 * rng.standard_normal((F + 1) * C)).astype(np.float32)
    return X, Y, x0


def _jgrad(x, b):
    return jl.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _tgrad(x, b):
    return tl.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _full_loss(x, X, Y):
    return float(jl.multinomial_logistic_loss(
        jnp.asarray(np.asarray(x, np.float32)), X.reshape(-1, F),
        Y.reshape(-1, C), None, REG))


def _jax_fused(x_dtype, data_dtype, interleaved, nepochs=3):
    X, Y, x0 = _data()
    tr = JaxTrainer("SQN", jcfg.SQNConfig.create(
        mem_size=M, bfgs_upd_freq=L, pairs_interleaved=interleaved), _jgrad)
    epoch = jax.jit(tr.epoch, static_argnames=("aligned",))
    st, infos = tr.init(jnp.asarray(x0, x_dtype)), []
    data = (jnp.asarray(X, data_dtype), jnp.asarray(Y, data_dtype))
    for _ in range(nepochs):
        st, inf = epoch(st, data, ETA)
        infos.append(np.asarray(inf))
    return st, np.concatenate(infos)


@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["block", "interleaved"])
@pytest.mark.parametrize("data_dtype", ["bfloat16", "float32"])
def test_fused_sqn_matches_jax(monkeypatch, interleaved, data_dtype):
    """Three epochs of fused SQN from a bfloat16 ``x0``: bfloat16 state
    with a float32 Gram, every collapsed direction on
    ``direction_streamed`` (its plain version here), the JAX package's
    codes and 10 live pairs, and the loss by the rule.  float32 data gives
    the bfloat16 data's steps bit for bit, as in the JAX package (both
    cast the data to the parameters' dtype inside each product)."""
    calls = []
    real = tlk.direction_streamed

    def spy(*args):
        calls.append(args[2].dtype)
        return real(*args)
    monkeypatch.setattr(ttwo_loop, "direction_streamed", spy)
    X, Y, x0 = _data()
    jst, jinfos = _jax_fused(jnp.bfloat16, getattr(jnp, data_dtype),
                             interleaved)
    jst32, _ = _jax_fused(jnp.float32, jnp.float32, interleaved)
    tr = FusedTrainer("SQN", SQNConfig.create(
        mem_size=M, bfgs_upd_freq=L, pairs_interleaved=interleaved), _tgrad)
    dt = getattr(torch, data_dtype)
    data = (torch.from_numpy(X).to(dt), torch.from_numpy(Y).to(dt))
    tst, tinfos = tr.epochs(tr.init(torch.from_numpy(x0).to(BF16)), data,
                            ETA, nepochs=3)
    rows = tst.mem.sy if interleaved else tst.mem.s
    assert tst.x.dtype == tst.x_sum.dtype == rows.dtype == BF16
    assert tst.mem.gram.dtype == tst.mem.gamma.dtype == torch.float32
    assert calls == [BF16] * (3 * NB)          # one per base step
    np.testing.assert_array_equal(tinfos.numpy().reshape(-1), jinfos)
    assert int(tst.mem.count) == int(jst.mem.count) == M
    loss = _full_loss(tst.x.float().numpy(), X, Y)
    want, f32 = (_full_loss(np.asarray(s.x, np.float32), X, Y)
                 for s in (jst, jst32))
    assert _within_rule(loss, want, f32), (loss, want, f32)
    if data_dtype == "float32":
        rounded = (data[0].to(BF16), data[1].to(BF16))
        again, _ = tr.epochs(tr.init(torch.from_numpy(x0).to(BF16)),
                             rounded, ETA, nepochs=3)
        assert torch.equal(again.x, tst.x)


def test_float32_step_tensor_is_refused():
    """A float32 step array with a bfloat16 iterate: the JAX package's
    epoch fails (its carry turns float32), the port raises a TypeError
    naming both dtypes; a Python float and a bfloat16 step are taken."""
    X, Y, x0 = _data()
    jtr = JaxTrainer("SQN", jcfg.SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                     _jgrad)
    jdata = (jnp.asarray(X), jnp.asarray(Y))
    with pytest.raises(TypeError):
        jax.jit(jtr.epoch)(jtr.init(jnp.asarray(x0, jnp.bfloat16)), jdata,
                           jnp.float32(ETA))
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                      _tgrad)
    data = (torch.from_numpy(X), torch.from_numpy(Y))
    x0_t = torch.from_numpy(x0).to(BF16)
    for step in (torch.tensor(ETA), torch.full((2,), ETA),
                 np.full(2, ETA, np.float32)):
        with pytest.raises(TypeError, match="float32.*bfloat16"):
            tr.epochs(tr.init(x0_t), data, step, nepochs=2)
    with pytest.raises(TypeError, match="bfloat16"):
        tr.epoch(tr.init(x0_t), data, torch.tensor(ETA, dtype=torch.float64))
    for step in (ETA, torch.tensor(ETA, dtype=BF16)):
        st, _ = tr.epoch(tr.init(x0_t), data, step)
        assert st.x.dtype == BF16
    st, _ = tr.epoch(tr.init(torch.from_numpy(x0)), data, torch.tensor(ETA))
    assert st.x.dtype == torch.float32         # a float32 iterate: taken


def test_converted_bf16_state_continues_like_jax():
    """A JAX bfloat16-iterate state after one epoch comes across through
    ``sqn_state_from_numpy`` (bfloat16 fields as their bits), goes back
    unchanged, and two more epochs on each side keep the codes and the
    loss rule at the horizon of ``test_fused_sqn_matches_jax``."""
    X, Y, x0 = _data()
    jtr = JaxTrainer("SQN", jcfg.SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                     _jgrad)
    epoch = jax.jit(jtr.epoch, static_argnames=("aligned",))
    jdata = (jnp.asarray(X), jnp.asarray(Y))
    jst, _ = epoch(jtr.init(jnp.asarray(x0, jnp.bfloat16)), jdata, ETA)

    def fields(obj):
        return {f.name: (fields(getattr(obj, f.name))
                         if dataclasses.is_dataclass(getattr(obj, f.name))
                         else np.asarray(getattr(obj, f.name)))
                for f in dataclasses.fields(obj)}
    d = fields(jst)
    tst = sqn_state_from_numpy(d, device="cpu")
    assert tst.x.dtype == tst.mem.s.dtype == BF16
    back = sqn_state_to_numpy(tst)
    np.testing.assert_array_equal(back["x"], d["x"].view(np.uint16))
    np.testing.assert_array_equal(back["mem"]["gram"], d["mem"]["gram"])
    jinfos = []
    for _ in range(2):
        jst, info = epoch(jst, jdata, ETA)
        jinfos.append(np.asarray(info))
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                      _tgrad)
    tst2, tinfos = tr.epochs(tst, (torch.from_numpy(X), torch.from_numpy(Y)),
                             ETA, nepochs=2)
    np.testing.assert_array_equal(tinfos.numpy(), np.stack(jinfos))
    jst2 = jst
    jst32, _ = _jax_fused(jnp.float32, jnp.float32, False, nepochs=3)
    loss, want, f32 = (_full_loss(np.asarray(x, np.float32), X, Y) for x in (
        tst2.x.float().numpy(), jst2.x, jst32.x))
    assert _within_rule(loss, want, f32), (loss, want, f32)


# ---------------------------------------------------------------------- #
# the front ends
# ---------------------------------------------------------------------- #
def _lsq():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((400, 8))
    y = X @ rng.standard_normal(8) + 0.01 * rng.standard_normal(400)

    def obj(w, X, y, sample_weight=None, **kw):
        r = X @ w - y
        return 0.5 * (r ** 2).mean()

    def grad(w, X, y, sample_weight=None, **kw):
        return X.T @ (X @ w - y) / X.shape[0]

    def hessvec(w, v, X, y, sample_weight=None, **kw):
        return X.T @ (X @ v) / X.shape[0]
    return X, y, obj, grad, hessvec


def test_guided_sqn_bf16_fit_matches_jax():
    """The guided ``SQN(dtype=bfloat16)`` on the protocol engine: the
    callables get float32 arrays holding the bfloat16 iterate (the JAX
    package's get bfloat16 arrays of the same values), and the fit keeps
    the JAX package's iterate, iteration count and last request."""
    X, y, obj, grad, hessvec = _lsq()
    x0 = np.zeros(8)

    def make(m, dtype, **kw):
        return m.SQN(x0, grad, obj_fun=obj, hess_vec_fun=hessvec,
                     step_size=0.1, batches_per_epoch=10, bfgs_upd_freq=5,
                     nepochs=6, verbose=False, dtype=dtype, **kw)
    port = make(tg, BF16, device="cpu").fit(X, y)
    ref = make(jg, jnp.bfloat16).fit(X, y)
    ref32 = make(jg, jnp.float32).fit(X, y)
    assert port.x.dtype == np.float32 and _bf16_values(port.x)
    assert port.optimizer.state.x.dtype == BF16
    assert port.niter == ref.niter
    assert port.req["task"] == ref.req["task"]
    loss, want, f32 = (float(obj(np.asarray(m.x, np.float64), X, y))
                       for m in (port, ref, ref32))
    assert _within_rule(loss, want, f32), (loss, want, f32)
    np.testing.assert_array_equal(port.x, np.asarray(ref.x, np.float32))


def test_guided_fused_and_logistic_bf16():
    """``engine="fused"`` with a bfloat16 optimizer (data in bfloat16 on
    the device) lowers the objective; ``StochasticLogisticRegression(
    dtype=bfloat16)`` on both engines keeps bfloat16 weights and predicts
    as the JAX package's bfloat16 model does."""
    X, y, obj, grad, hessvec = _lsq()
    opt = tg.SQN(np.zeros(8), grad, obj_fun=obj, hess_vec_fun=hessvec,
                 step_size=0.1, batches_per_epoch=10, bfgs_upd_freq=5,
                 nepochs=4, verbose=False, dtype=BF16, device="cpu")
    opt.fit(X, y, engine="fused")
    assert opt.optimizer.state.x.dtype == BF16 and _bf16_values(opt.x)
    assert obj(opt.x, X, y) < 0.1 * obj(np.zeros(8), X, y)
    from stochqn_tpu.models.logistic import StochasticLogisticRegression as J
    from stochqn_tpu_torch.models.logistic import StochasticLogisticRegression
    yb = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(float)
    kw = dict(nepochs=3, batches_per_epoch=8, valset_frac=None,
              optimizer="SQN")
    for engine in ("protocol", "fused"):
        clf = StochasticLogisticRegression(dtype=BF16, engine=engine,
                                           device="cpu", **kw).fit(X, yb)
        ref = J(dtype=jnp.bfloat16, engine=engine, **kw).fit(X, yb)
        got = clf.predict(X)
        assert got.shape == yb.shape
        np.testing.assert_array_equal(got, ref.predict(X), err_msg=engine)


# ---------------------------------------------------------------------- #
# the kernel route
# ---------------------------------------------------------------------- #
def _direction_inputs(n=700, m=M, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((m, n)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal((2 * m, 2 * m)) / n).astype(np.float32)
    return s, y, g, c, np.float32(0.7)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_bf16_gradient_route_matches_the_upcast_route(storage):
    """``direction_streamed`` on a bfloat16 gradient is the same function
    as on its float32 upcast (the same bits), and agrees with the Pallas
    kernel in interpret mode, whose wrapper upcasts the gradient itself."""
    from stochqn_tpu.ops.pallas.two_loop_kernel import (
        direction_streamed as pallas_direction)
    s, y, g, c, gamma = _direction_inputs()
    st = getattr(torch, storage)
    ts, ty = torch.from_numpy(s).to(st), torch.from_numpy(y).to(st)
    g16 = torch.from_numpy(g).to(BF16)
    tc, tgam = torch.from_numpy(c), torch.tensor(gamma)
    launches = tlk.LAUNCHES
    got = tlk.direction_streamed(ts, ty, g16, tc, tgam)
    assert tlk.LAUNCHES == launches and got.dtype == torch.float32
    assert torch.equal(got, tlk.direction_streamed(ts, ty, g16.float(), tc,
                                                   tgam))
    jst = getattr(jnp, storage)
    want = np.asarray(pallas_direction(
        jnp.asarray(s).astype(jst), jnp.asarray(y).astype(jst),
        jnp.asarray(g16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(c), jnp.asarray(gamma), tile_n=256, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=KRTOL, atol=KATOL)


def test_sqn_step_takes_the_bf16_route(monkeypatch):
    """One SQN base step on a bfloat16 state: the collapsed direction goes
    to ``direction_streamed`` with the bfloat16 gradient, and comes back
    bfloat16, the plain three products' result rounded."""
    routes = []
    for name in ("direction", "direction_streamed"):
        def spy(*args, _name=name, _fn=getattr(tlk, name)):
            routes.append(_name)
            return _fn(*args)
        monkeypatch.setattr(ttwo_loop, name, spy)
    X, Y, x0 = _data()
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                      _tgrad)
    st, _ = tr.epoch(tr.init(torch.from_numpy(x0).to(BF16)),
                     (torch.from_numpy(X), torch.from_numpy(Y)), ETA)
    routes.clear()
    g = _tgrad(st.x, (torch.from_numpy(X[0]), torch.from_numpy(Y[0])))
    assert g.dtype == BF16
    d = ttwo_loop.two_loop_cached(g, st.mem, collapsed=True)
    assert routes == ["direction_streamed"] and d.dtype == BF16
    w = torch.cat([st.mem.s, st.mem.y]).float()
    gam = st.mem.gamma
    c = st.mem.c0 + gam * st.mem.cg
    plain = (gam * g.float() + (c @ (w @ g.float())) @ w).to(BF16)
    assert torch.equal(d, plain)
