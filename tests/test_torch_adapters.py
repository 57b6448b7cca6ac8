"""The torch port's adapters against the JAX package's: the
``torch.optim`` oLBFGS against optax ``olbfgs``, ``PytreeTrainer``, the
MLP, and the ``.npz`` checkpoints.

Counterpart of ``test_adapters.py``.  ``OLBFGS`` and optax ``olbfgs`` are
fed the same gradients (the same quadratic, the same start); the MLPs
start from the same weights, drawn by the JAX package and carried over
with ``convert.mlp_params_from_numpy``; checkpoints are written by one
package and read by the other.  Tolerances: float64 on both sides, rtol
1e-9 and atol 1e-12 (``test_torch_fused_sqn.py``'s float64 pair); a
restored or carried state, and a module's parameters against the same
parameters in a dict, bit for bit (the same tensors and the same ops).
"""
import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core import adaqn as jadaqn  # noqa: E402
from stochqn_tpu.core import config as jcfg  # noqa: E402
from stochqn_tpu.core import olbfgs as jolbfgs  # noqa: E402
from stochqn_tpu.core import sqn as jsqn  # noqa: E402
from stochqn_tpu.models import mlp as jmlp  # noqa: E402
from stochqn_tpu.optax_adapter import PytreeTrainer as JaxPytree  # noqa: E402
from stochqn_tpu.optax_adapter import olbfgs as optax_olbfgs  # noqa: E402
from stochqn_tpu.utils import checkpoint as jck  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               OLBFGSConfig, SQN_free, SQNConfig, convert)
from stochqn_tpu_torch.core import adaqn, olbfgs, sqn  # noqa: E402
from stochqn_tpu_torch.models import mlp  # noqa: E402
from stochqn_tpu_torch.optim_adapter import (OLBFGS,  # noqa: E402
                                             PytreeTrainer)
from stochqn_tpu_torch.optim_adapter import olbfgs as torch_olbfgs  # noqa: E402
from stochqn_tpu_torch.utils.checkpoint import (  # noqa: E402
    _leaves_with_paths, load_state, save_state)

RTOL, ATOL = 1e-9, 1e-12


def _quad(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T


# --------------------------------------------------------------------------
# torch.optim oLBFGS against optax olbfgs
# --------------------------------------------------------------------------
def _optax_run(a, target, params, lr, steps, grads=None, mem_size=6):
    import optax
    opt = optax_olbfgs(learning_rate=lr, mem_size=mem_size)
    state = opt.init(params)
    ja, jt = jnp.asarray(a), jnp.asarray(target)

    def loss(p):
        r = jnp.concatenate([p["b"], p["w"]]) - jt
        return 0.5 * r @ ja @ r
    out = []
    for k in range(steps):
        g = jax.grad(loss)(params) if grads is None else grads[k]
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append(np.concatenate([np.asarray(params["b"]),
                                   np.asarray(params["w"])]))
    return out, state


def test_olbfgs_optimizer_matches_optax(rng):
    """60 steps on a quadratic over two parameter tensors: the same
    iterates as optax ``olbfgs``, and the minimum."""
    n = 12
    a, target = _quad(rng, n), rng.standard_normal(n)
    ta, tt = torch.from_numpy(a), torch.from_numpy(target)
    b = torch.zeros(n - n // 2, dtype=torch.float64, requires_grad=True)
    w = torch.zeros(n // 2, dtype=torch.float64, requires_grad=True)
    opt = torch_olbfgs([b, w], learning_rate=0.2, mem_size=6)
    assert isinstance(opt, OLBFGS) and isinstance(opt,
                                                  torch.optim.Optimizer)

    def closure():
        opt.zero_grad()
        r = torch.cat([b, w]) - tt
        loss = 0.5 * r @ ta @ r
        loss.backward()
        return loss
    ref, _ = _optax_run(a, target, {"w": jnp.zeros(n // 2),
                                    "b": jnp.zeros(n - n // 2)}, 0.2, 60)
    for k in range(60):
        loss = opt.step(closure)
        np.testing.assert_allclose(torch.cat([b, w]).detach().numpy(),
                                   ref[k], rtol=RTOL, atol=ATOL)
    assert float(loss) < 1e-6
    np.testing.assert_allclose(torch.cat([b, w]).detach().numpy(), target,
                               atol=1e-3)


def test_olbfgs_schedule_and_nan_guard_match_optax(rng):
    """A step-count schedule and a NaN gradient (direction zeroed, memory
    flushed): the same updates as optax on the same gradients."""
    n = 5
    grads = [rng.standard_normal(n), rng.standard_normal(n),
             np.full(n, np.nan), rng.standard_normal(n)]
    p = torch.ones(n, dtype=torch.float64, requires_grad=True)
    opt = OLBFGS([p], lr=lambda c: 0.1 / math.sqrt(c + 1.0), mem_size=4)
    ref, jstate = _optax_run(np.eye(n), np.zeros(n),
                             {"b": jnp.ones(n), "w": jnp.zeros(0)},
                             lambda c: 0.1 / jnp.sqrt(c + 1.0), 4,
                             grads=[{"b": jnp.asarray(g), "w": jnp.zeros(0)}
                                    for g in grads], mem_size=4)
    for k, g in enumerate(grads):
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=RTOL,
                                   atol=ATOL)
        if k == 2:
            st = opt.state[p]
            assert int(st["mem"].count) == 0
            assert bool(torch.all(st["upd_prev"] == 0))
    assert opt.state[p]["count"] == int(jstate.count) == 4


# --------------------------------------------------------------------------
# PytreeTrainer
# --------------------------------------------------------------------------
def test_pytree_trainer_matches_flat_and_jax(rng):
    """A dict of parameters trains as its flat vector does (bits), and as
    the JAX package's PytreeTrainer (float64 tolerance)."""
    n1, n2, B, bs = 3, 4, 8, 4
    a = rng.standard_normal((n1 + n2, n1 + n2))
    a = a @ a.T + 0.5 * np.eye(n1 + n2)
    data = rng.standard_normal((B, bs, n1 + n2))
    ta, td = torch.from_numpy(a), torch.from_numpy(data)

    def loss_tree(p, batch):
        r = torch.cat([p["u"], p["v"]]) - batch.mean(0)
        return 0.5 * r @ ta @ r

    def grad_flat(x, batch):
        return ta @ (x - batch.mean(0))

    cfg = SQNConfig.create(mem_size=3, bfgs_upd_freq=4)
    tmpl = {"u": torch.zeros(n1, dtype=torch.float64),
            "v": torch.zeros(n2, dtype=torch.float64)}
    pt = PytreeTrainer("SQN", cfg, loss_tree, tmpl)
    st_t, _ = pt.epoch(pt.init(), td, 0.05)
    ft = FusedTrainer("SQN", cfg, grad_flat)
    st_f, _ = ft.epoch(ft.init(torch.zeros(n1 + n2, dtype=torch.float64)),
                       td, 0.05)
    got = torch.cat([pt.params(st_t)["u"], pt.params(st_t)["v"]])
    np.testing.assert_allclose(got.numpy(), st_f.x.numpy(), rtol=RTOL,
                               atol=ATOL)

    ja = jnp.asarray(a)

    def jloss(p, batch):
        r = jnp.concatenate([p["u"], p["v"]]) - jnp.mean(batch, axis=0)
        return 0.5 * r @ ja @ r
    jt = JaxPytree("SQN", jcfg.SQNConfig.create(mem_size=3, bfgs_upd_freq=4),
                   jloss, {"u": jnp.zeros(n1), "v": jnp.zeros(n2)})
    st_j, _ = jax.jit(jt.epoch)(jt.init(), jnp.asarray(data), 0.05)
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x),
                               rtol=RTOL, atol=ATOL)


def test_pytree_trainer_over_a_module(rng):
    """An ``nn.Module``'s parameters as the template: the loss calls
    ``torch.func.functional_call``; the same steps as the same parameters
    in a dict."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3).double()
    X = torch.from_numpy(rng.standard_normal((6, 5, 4)))
    Y = torch.from_numpy(rng.standard_normal((6, 5, 3)))

    def module_loss(params, batch):
        out = torch.func.functional_call(lin, params, (batch[0],))
        return ((out - batch[1]) ** 2).mean()

    def dict_loss(params, batch):
        out = batch[0] @ params["weight"].T + params["bias"]
        return ((out - batch[1]) ** 2).mean()

    cfg = AdaQNConfig.create(mem_size=3, fisher_size=6, bfgs_upd_freq=3)
    pm = PytreeTrainer("adaQN", cfg, module_loss, lin)
    sm, _ = pm.epoch(pm.init(lin), (X, Y), 0.1)
    tmpl = {k: v.detach().clone() for k, v in lin.named_parameters()}
    pd = PytreeTrainer("adaQN", cfg, dict_loss, tmpl)
    sd, _ = pd.epoch(pd.init(), (X, Y), 0.1)
    assert torch.equal(sm.x, sd.x)
    assert set(pm.params(sm)) == {"weight", "bias"}
    assert pm.params(sm)["weight"].shape == (3, 4)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def test_mlp_matches_jax_from_carried_weights(rng):
    """The JAX package draws the weights; the port starts from the same
    ones (``convert.mlp_params_from_numpy``): the same logits and loss, and
    two adaQN epochs of ``PytreeTrainer`` land on the JAX package's
    parameters."""
    sizes = [5, 7, 3]
    jparams = jmlp.init_mlp_params(jax.random.PRNGKey(3), sizes,
                                   jnp.float64)
    np_params = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in jparams]
    tparams = convert.mlp_params_from_numpy(np_params, device="cpu")
    back = convert.mlp_params_to_numpy(tparams)
    for la, lb in zip(back, np_params):
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])
    X = rng.standard_normal((4, 10, 5))
    Y = np.eye(3)[rng.integers(0, 3, (4, 10))]
    tb = (torch.from_numpy(X), torch.from_numpy(Y))
    jb = (jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(
        mlp.mlp_logits(tparams, tb[0][0]).numpy(),
        np.asarray(jmlp.mlp_logits(jparams, jb[0][0])), rtol=1e-12)
    np.testing.assert_allclose(
        float(mlp.mlp_loss(tparams, (tb[0][0], tb[1][0]), 1e-3)),
        float(jmlp.mlp_loss(jparams, (jb[0][0], jb[1][0]), 1e-3)),
        rtol=1e-12)

    kw = dict(mem_size=3, fisher_size=8, bfgs_upd_freq=2,
              rmsprop_weight=0.9)
    pt = PytreeTrainer("adaQN", AdaQNConfig.create(**kw),
                       lambda p, b: mlp.mlp_loss(p, b, 1e-3), tparams)
    st, _ = pt.run_epochs(pt.init(tparams), tb, 2, 0.1)
    jt = JaxPytree("adaQN", jcfg.AdaQNConfig.create(**kw),
                   lambda p, b: jmlp.mlp_loss(p, b, 1e-3), jparams)
    jst, _ = jt.run_epochs(jt.init(jparams), jb, 2, 0.1)
    got = pt.params(st)
    want = jt.params(jst)
    for lg, lw in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(lg[k].numpy(), np.asarray(lw[k]),
                                       rtol=RTOL, atol=ATOL)


def test_mlp_classifier_learns_xorish(rng):
    n = 400
    theta = rng.uniform(0, 2 * np.pi, n)
    labels = (theta > np.pi).astype(int)
    X = np.stack([np.cos(theta), np.sin(2 * theta)], axis=1)
    X += 0.05 * rng.standard_normal(X.shape)
    clf = mlp.MLPClassifier(hidden=(16,), optimizer="adaQN", step_size=0.2,
                            batch_size=50, nepochs=30, bfgs_upd_freq=4,
                            fisher_size=20, random_state=0, device="cpu")
    clf.fit(X, labels)
    assert clf.score(X, labels) > 0.95
    proba = clf.predict_proba(X[:3])
    assert proba.shape == (3, 2) and np.allclose(proba.sum(1), 1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mlp.MLPClassifier()


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------
def _answer(opt, req, a):
    on = req["requested_on"]
    if req["task"] == "calc_hess_vec":
        opt.update_hess_vec(a @ on[1])
    else:
        opt.update_gradient(a @ on)


def _requests(opt, req, x, a, count):
    """Answer ``req`` and the next ``count - 1`` requests of a quadratic's
    request loop; returns the last request and each request's task and
    iterate."""
    seen = []
    for _ in range(count):
        _answer(opt, req, a)
        req = opt.run_optimizer(x, 0.05)
        seen.append((req["task"], x.copy()))
    return req, seen


def test_checkpoint_mid_protocol_into_a_fresh_optimizer(rng, tmp_path):
    """save_state mid-protocol (a Hessian-vector request pending after the
    second boundary), load_state into a fresh SQN_free's template and
    adopt_state: the pending request answered again and 10 more give the
    same bits as the uninterrupted run."""
    n = 8
    a = _quad(rng, n)
    x = rng.standard_normal(n)
    run = SQN_free(mem_size=3, bfgs_upd_freq=4, device="cpu")
    req = run.run_optimizer(x, 0.05)
    while not (req["task"] == "calc_hess_vec" and run.niter > 8):
        req, _ = _requests(run, req, x, a, 1)
    path = str(tmp_path / "ck.npz")
    save_state(path, run.state)
    x_saved, req_saved, niter = x.copy(), req, run.niter
    _, tail = _requests(run, req, x, a, 10)

    fresh = SQN_free(mem_size=3, bfgs_upd_freq=4, device="cpu")
    template = sqn.init(torch.zeros(n, dtype=torch.float64), fresh._cfg)
    fresh.adopt_state(load_state(path, template))
    assert fresh.niter == niter
    x2 = x_saved.copy()
    _, tail2 = _requests(fresh, req_saved, x2, a, 10)
    assert [t for t, _ in tail2] == [t for t, _ in tail]
    for (_, xa), (_, xb) in zip(tail, tail2):
        np.testing.assert_array_equal(xa, xb)
    assert torch.equal(fresh.state.x, run.state.x)
    assert {t for t, _ in tail} >= {"calc_grad", "calc_hess_vec"}


def test_checkpoint_roundtrip_adaqn_advance(rng, tmp_path):
    """Save mid-run, restore into a fresh template, continue: identical
    (``test_adapters.py``'s round trip, in the port)."""
    n = 8
    cfg = AdaQNConfig.create(mem_size=3, fisher_size=6, bfgs_upd_freq=4)
    state = adaqn.init(torch.from_numpy(rng.standard_normal(n)), cfg)
    g = torch.from_numpy(rng.standard_normal(n))
    for _ in range(6):
        state, _ = adaqn.advance(cfg, state, g, 1.0, 0.05)
    path = str(tmp_path / "ck.npz")
    save_state(path, state)
    restored = load_state(path, adaqn.init(torch.zeros(n,
                                                       dtype=torch.float64),
                                           cfg))
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(restored, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.dtype == b.dtype, f.name
    s1, r1 = adaqn.advance(cfg, state, g, 1.0, 0.05)
    s2, r2 = adaqn.advance(cfg, restored, g, 1.0, 0.05)
    assert torch.equal(s1.x, s2.x) and int(r1.task) == int(r2.task)
    # any nesting of dicts, lists and tuples of tensors: the MLP's params
    params = mlp.init_mlp_params(torch.Generator().manual_seed(0), [3, 4, 2])
    save_state(path, params)
    back = load_state(path, [{k: torch.zeros_like(v) for k, v in layer.items()}
                             for layer in params])
    for la, lb in zip(params, back):
        assert la.keys() == lb.keys()
        assert all(torch.equal(la[k], lb[k]) for k in la)


def _jax_state(kind, dtype, n, rng):
    """A JAX state a few ``advance`` calls in, so every field is live."""
    x0 = jnp.asarray(rng.standard_normal(n), dtype)
    g = jnp.asarray(rng.standard_normal(n), dtype)
    if kind == "oLBFGS":
        cfg = jcfg.OLBFGSConfig.create(mem_size=3)
        st, adv, extra = jolbfgs.init(x0, cfg), jolbfgs.advance, ()
    elif kind == "SQN":
        cfg = jcfg.SQNConfig.create(mem_size=3, bfgs_upd_freq=2)
        st, adv, extra = jsqn.init(x0, cfg), jsqn.advance, (g * 0.5,)
    else:
        cfg = jcfg.AdaQNConfig.create(mem_size=3, fisher_size=4,
                                      bfgs_upd_freq=2)
        st, adv = jadaqn.init(x0, cfg), jadaqn.advance
        extra = (jnp.asarray(1.0, dtype),)
    adv = jax.jit(adv, static_argnums=0)
    for k in range(9):
        st, _ = adv(cfg, st, g * (1.0 + 0.1 * k), *extra,
                    jnp.asarray(0.05, dtype))
    return st


def _port_template(kind, dtype, n):
    x0 = torch.zeros(n, dtype=dtype)
    if kind == "oLBFGS":
        return olbfgs.init(x0, OLBFGSConfig.create(mem_size=3))
    if kind == "SQN":
        return sqn.init(x0, SQNConfig.create(mem_size=3, bfgs_upd_freq=2))
    return adaqn.init(x0, AdaQNConfig.create(mem_size=3, fisher_size=4,
                                             bfgs_upd_freq=2))


def _jax_leaves(state):
    return {jck._path_key(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.mark.parametrize("kind", ["oLBFGS", "SQN", "adaQN"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_checkpoint_across_packages(rng, tmp_path, kind, dtype):
    """A state written by the JAX package loads in the port, and one
    written by the port loads in the JAX package: every field, bit for
    bit."""
    n = 6
    jstate = _jax_state(kind, getattr(jnp, dtype), n, rng)
    want = _jax_leaves(jstate)
    jpath = str(tmp_path / "jax.npz")
    jck.save_state(jpath, jstate)
    port = load_state(jpath, _port_template(kind, getattr(torch, dtype), n))
    got = dict(_leaves_with_paths(port))
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    tpath = str(tmp_path / "torch.npz")
    save_state(tpath, port)
    back = jck.load_state(tpath, jax.tree_util.tree_map(jnp.zeros_like,
                                                        jstate))
    for key, arr in _jax_leaves(back).items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
        assert arr.dtype == want[key].dtype, key


def test_checkpoint_structure_and_shape_mismatch(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_state(path, olbfgs.init(torch.zeros(5, dtype=torch.float64),
                                 OLBFGSConfig.create()))
    with pytest.raises(ValueError, match="structure"):
        load_state(path, sqn.init(torch.zeros(5, dtype=torch.float64),
                                  SQNConfig.create()))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, olbfgs.init(torch.zeros(6, dtype=torch.float64),
                                     OLBFGSConfig.create()))
