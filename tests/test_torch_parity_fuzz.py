"""The config sweep of ``test_parity_fuzz.py``, held between the torch port
and the JAX package.

``test_parity_fuzz.py`` drives the JAX package against the reference C
core over its fixed configs (``OLBFGS_CONFIGS``, ``SQN_CONFIGS``,
``ADAQN_CONFIGS``: memory sizes, update frequencies, H0 modes,
y-regularization, RMSProp weights, curvature gates, both pair layouts)
and skips where the reference is absent.  Here the same configs and the
same quadratic (``_problem`` / ``_eval``) drive the two packages against
each other, in float64:

* free mode: both packages' request loops in lockstep, each fed
  ``_eval`` at the point it asked for; the tasks, the whole ``info``
  record (``iteration_info`` included) exactly and ``x`` within the
  sweep's rtol 1e-7 (atol 1e-9) at every call.  Both sides are this
  repository's own, so no config stops at its first curvature rejection;
* the fused engine: two epochs of ``epoch`` with ``aligned=False`` over
  11 batches (``11 % upd_freq != 0`` for every config: the generic
  layout, every epoch from another phase), the JAX package's jitted
  ``epoch`` against the port's; the infos and ``niter`` exactly, ``x``,
  the pair rows and ``x_sum`` within 1e-9 (rtol; atol 1e-12).

The configs are the file's fixed ones, not random draws: a random sweep
also meets unstable runs whose float64 roundings grow from 1e-16
(``fisher_size=1``, ``x`` reaching 294), which part two correct
implementations.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu import free as jax_free  # noqa: E402
from stochqn_tpu.core import config as jcfg  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               OLBFGSConfig, SQN_free, SQNConfig, adaQN_free,
                               oLBFGS_free)
from test_parity_fuzz import (ADAQN_CONFIGS, OLBFGS_CONFIGS,  # noqa: E402
                              SQN_CONFIGS, _eval, _problem)

X_RTOL, X_ATOL = 1e-7, 1e-9          # test_parity_fuzz._lockstep's
FUSED_RTOL, FUSED_ATOL = 1e-9, 1e-12
N = 6


def _kwargs(kind, config):
    """The sweep's config tuple as keyword arguments (free and fused
    alike), with the sweep's problem seed, length and step."""
    if kind == "oLBFGS":
        mem, h0, mc, yreg, ilv = config
        return (dict(mem_size=mem, hess_init=h0, min_curvature=mc,
                     y_reg=yreg, pairs_interleaved=ilv), 100 + mem, 60)
    if kind == "SQN":
        mem, L, ugd, mc, yreg, ilv = config
        return (dict(mem_size=mem, bfgs_upd_freq=L, use_grad_diff=ugd,
                     min_curvature=mc, y_reg=yreg, pairs_interleaved=ilv),
                200 + mem * 10 + L, 70)
    mem, fisher, L, mi, mc, sreg, rms, ugd, yreg = config
    return (dict(mem_size=mem, fisher_size=fisher, bfgs_upd_freq=L,
                 max_incr=mi, min_curvature=mc, scal_reg=sreg,
                 rmsprop_weight=rms, use_grad_diff=ugd, y_reg=yreg),
            300 + mem * 10 + fisher, 80)


CASES = ([("oLBFGS", c) for c in OLBFGS_CONFIGS]
         + [("SQN", c) for c in SQN_CONFIGS]
         + [("adaQN", c) for c in ADAQN_CONFIGS])
IDS = [f"{kind}-{'-'.join(map(str, c))}" for kind, c in CASES]


def _feed(opt, req, a, centers, b):
    task, on = req["task"], req["requested_on"]
    if task == "calc_fun_val_batch":
        opt.update_function(float(_eval(task, np.asarray(on), a, centers, b)))
    elif task == "calc_hess_vec":
        opt.update_hess_vec(_eval(task, np.asarray(on[0]), a, centers, b,
                                  vec=np.asarray(on[1])))
    else:
        opt.update_gradient(_eval(task, np.asarray(on), a, centers, b))


@pytest.mark.parametrize("kind,config", CASES, ids=IDS)
def test_free_lockstep(kind, config):
    kw, seed, steps = _kwargs(kind, config)
    a, centers, x0 = _problem(seed=seed, n=N)
    tcls, jcls = {"oLBFGS": (oLBFGS_free, jax_free.oLBFGS_free),
                  "SQN": (SQN_free, jax_free.SQN_free),
                  "adaQN": (adaQN_free, jax_free.adaQN_free)}[kind]
    topt, jopt = tcls(**kw, device="cpu"), jcls(**kw)
    x_t, x_j, eta = x0.copy(), x0.copy(), 0.05
    treq, jreq = topt.run_optimizer(x_t, eta), jopt.run_optimizer(x_j, eta)
    b, infos = 0, set()
    for it in range(steps):
        assert treq["task"] == jreq["task"], f"call {it}"
        assert treq["info"] == jreq["info"], f"call {it}"
        np.testing.assert_allclose(x_t, x_j, rtol=X_RTOL, atol=X_ATOL,
                                   err_msg=f"call {it}: x")
        infos.add(treq["info"]["iteration_info"])
        if treq["task"] == "calc_grad":
            b += 1
        _feed(topt, treq, a, centers, b)
        _feed(jopt, jreq, a, centers, b)
        treq = topt.run_optimizer(x_t, eta)
        jreq = jopt.run_optimizer(x_j, eta)
    assert b >= 10        # the two-loop ran on pairs


def _fused(kind, kw, a):
    ja, ta = jnp.asarray(a), torch.from_numpy(a)

    def jgrad(x, batch):
        return ja @ (x - jnp.mean(batch, axis=0))

    def jobj(x, batch):
        r = x - jnp.mean(batch, axis=0)
        return 0.5 * r @ ja @ r

    def tgrad(x, batch):
        return ta @ (x - torch.mean(batch, dim=0))

    def tobj(x, batch):
        r = x - torch.mean(batch, dim=0)
        return 0.5 * r @ ta @ r
    jc = {"oLBFGS": jcfg.OLBFGSConfig, "SQN": jcfg.SQNConfig,
          "adaQN": jcfg.AdaQNConfig}[kind].create(**kw)
    tc = {"oLBFGS": OLBFGSConfig, "SQN": SQNConfig,
          "adaQN": AdaQNConfig}[kind].create(**kw)
    obj = kind == "adaQN"
    return (JaxTrainer(kind, jc, jgrad, obj_fn=jobj if obj else None),
            FusedTrainer(kind, tc, tgrad, obj_fn=tobj if obj else None))


@pytest.mark.parametrize("kind,config", CASES, ids=IDS)
def test_fused_generic_epochs(kind, config):
    kw, seed, _ = _kwargs(kind, config)
    B = 11
    a, centers, x0 = _problem(seed=seed, n=N, nb=2 * B)
    data = centers.reshape(B, 2, N)
    jtr, ttr = _fused(kind, kw, a)
    jepoch = jax.jit(jtr.epoch, static_argnames=("aligned",))
    jst, tst = jtr.init(jnp.asarray(x0)), ttr.init(torch.from_numpy(x0))
    for eta in (0.05, 0.03):
        jst, jinfos = jepoch(jst, jnp.asarray(data), eta, aligned=False)
        tst, tinfos = ttr.epoch(tst, torch.from_numpy(data), eta,
                                aligned=False)
        np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
        assert int(tst.niter) == int(jst.niter)
        for what in ("x", "x_sum"):
            if hasattr(jst, what):
                np.testing.assert_allclose(
                    getattr(tst, what).numpy(), np.asarray(getattr(jst, what)),
                    rtol=FUSED_RTOL, atol=FUSED_ATOL, err_msg=what)
        for what in ("s", "y"):
            np.testing.assert_allclose(
                getattr(tst.mem, what).numpy(),
                np.asarray(getattr(jst.mem, what)), rtol=FUSED_RTOL,
                atol=FUSED_ATOL, err_msg=f"mem.{what}")
        assert int(tst.mem.count) == int(jst.mem.count)
