#!/usr/bin/env python3
"""The JAX package's references for ``chip_smoke.py`` phase 18 (the front
ends).

Runs the JAX package (``stochqn_tpu``) on the CPU on phase 18's data
(``chip_smoke.bench_data``'s recipe, ``numpy.random.default_rng(1)`` at
the BibTeX shape, flattened to 6,000 rows of 1,836 features with one-hot
labels of 159 classes) and prints one JSON line per run:

* ``logistic_*``: ``StochasticLogisticRegression(engine="fused",
  valset_frac=None, batches_per_epoch=120, nepochs=2, shuffle_data=False,
  decr_step_size=None, mem_size=10)`` with SQN (``bfgs_upd_freq=20``),
  oLBFGS, and adaQN (``fisher_size=100, rmsprop_weight=0.9,
  bfgs_upd_freq=20``; in float32 with ``coupling="gram"``, the math of the
  port's kernel route, since Pallas needs interpret mode on the CPU); the
  model's objective on all rows (the mean log-loss, sample weights 1/6000,
  plus ``0.5 * 1e-3 * ||coef||^2``);
* ``guided_*``: the guided ``SQN(x0, grad, obj, hess_vec,
  batches_per_epoch=120, step_size=1e-2, mem_size=10, bfgs_upd_freq=20)``
  with the default shuffle and "auto" decay, from bench.py's ``x0``, the
  callables the closed-form losses (summed, reg 0.1): ``fit`` for one
  epoch on the protocol engine and for two on the fused engine (the
  scheduled single dispatch); the summed loss (reg 0.1) on all rows.

``--f64`` runs everything in float64 (``jax_enable_x64``, float64 data),
to see how far float32 rounding moves each loss.

    JAX_PLATFORMS=cpu python tools/jax_front_end_references.py [--f64]

About two minutes on 4 cores; each run holds under 2 GB.  Needs JAX (and
scikit-learn, for the JAX package's validation split, unused here), so it
runs here and not on the machine with the card.
"""
import json
import os
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
F64 = "--f64" in sys.argv[1:]
if F64:
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from stochqn_tpu.guided import SQN  # noqa: E402
from stochqn_tpu.models import losses  # noqa: E402
from stochqn_tpu.models.logistic import (  # noqa: E402
    StochasticLogisticRegression)

N_FEATURES, N_CLASSES, BATCH_SIZE, NUM_BATCHES = 1836, 159, 50, 120
REG, STEP = 0.1, 1e-2
DTYPE = jnp.float64 if F64 else jnp.float32


def front_end_data():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((NUM_BATCHES, BATCH_SIZE, N_FEATURES)).astype(
        np.float32)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = np.eye(N_CLASSES, dtype=np.float32)[labels]
    x0 = rng.standard_normal((N_FEATURES + 1) * N_CLASSES).astype(np.float32)
    dt = np.float64 if F64 else np.float32
    return (X.reshape(-1, N_FEATURES).astype(dt),
            Y.reshape(-1, N_CLASSES).astype(dt), x0.astype(dt))


def report(run, loss, **more):
    print(json.dumps(dict(run=run, dtype="float64" if F64 else "float32",
                          loss=float(loss), **more)), flush=True)


def main():
    X, Y, x0 = front_end_data()
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    n = X.shape[0]

    def model_loss(x, reg_param=1e-3):
        return losses.multinomial_logistic_loss(
            jnp.asarray(x, DTYPE), jX, jY, jnp.full((n,), 1.0 / n, DTYPE),
            reg_param)

    common = dict(engine="fused", valset_frac=None, batches_per_epoch=120,
                  nepochs=2, shuffle_data=False, decr_step_size=None,
                  mem_size=10, dtype=DTYPE)
    runs = {
        "logistic_sqn": dict(optimizer="SQN", bfgs_upd_freq=20),
        "logistic_olbfgs": dict(optimizer="oLBFGS"),
        "logistic_adaqn": dict(optimizer="adaQN", fisher_size=100,
                               rmsprop_weight=0.9, step_size=0.1,
                               bfgs_upd_freq=20,
                               **({} if F64 else {"coupling": "gram"})),
    }
    for name, kw in runs.items():
        clf = StochasticLogisticRegression(**common, **kw).fit(X, Y)
        state = clf._fused_state
        report(name, model_loss(clf.x_), live_pairs=int(state.mem.count),
               niter=int(state.niter))

    grad_j = jax.jit(lambda x, a, b: losses.multinomial_logistic_grad(
        x, a, b, None, REG))
    loss_j = jax.jit(lambda x, a, b: losses.multinomial_logistic_loss(
        x, a, b, None, REG))
    hv_j = jax.jit(lambda x, v, a, b: losses.multinomial_logistic_hessvec(
        x, v, a, b, None, REG))

    def c(a):
        return jnp.asarray(a, DTYPE)

    def grad(x, Xb, Yb, sample_weight=None):
        return grad_j(c(x), c(Xb), c(Yb))

    def obj(x, Xb, Yb, sample_weight=None):
        return loss_j(c(x), c(Xb), c(Yb))

    def hess_vec(x, v, Xb, Yb, sample_weight=None):
        return hv_j(c(x), c(v), c(Xb), c(Yb))

    def guided(nepochs):
        return SQN(x0, grad, obj_fun=obj, hess_vec_fun=hess_vec,
                   batches_per_epoch=NUM_BATCHES, step_size=STEP,
                   nepochs=nepochs, mem_size=10, bfgs_upd_freq=20,
                   use_float=not F64, verbose=False)

    for name, nepochs, engine in (("guided_protocol_sqn_1_epoch", 1,
                                   "protocol"),
                                  ("guided_fused_sqn_2_epochs", 2, "fused")):
        opt = guided(nepochs).fit(X, Y, engine=engine)
        report(name, loss_j(c(opt.x), jX, jY), niter=opt.niter,
               live_pairs=int(opt.optimizer.state.mem.count),
               dispatch=opt._fused_dispatch_mode)


if __name__ == "__main__":
    main()
