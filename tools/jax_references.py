#!/usr/bin/env python3
"""The JAX package's references for ``chip_smoke.py`` phases 15-17 and 20.

Runs the JAX package (``stochqn_tpu``) on the CPU on the smoke's data
(``chip_smoke.bench_data``'s recipe: ``numpy.random.default_rng(1)``, the
BibTeX shape) and prints one JSON line per run: the full-data loss (reg
0.1), the info-code histogram, the live pairs and, for adaQN, the codes at
the boundaries.  ``--f64`` runs the float32-independent ones, and the
oLBFGS ones, in float64 (``jax_enable_x64``, float64 data and x0), to see
how far float32 rounding moves each loss; bfloat16 pairs stay bfloat16
there.

    JAX_PLATFORMS=cpu python tools/jax_references.py [--f64]

``--bf16-iterate`` runs phase 20's instead: fused SQN from a bfloat16
``x0`` for 2 epochs on bfloat16 data and on float32 data (a Python-float
step), and ``SQN_free(dtype=jnp.bfloat16)`` for one epoch in the smoke's
request loop (minibatch b for the b-th ``calc_grad``, the round's 20
minibatches merged example-axis-major for ``calc_hess_vec``; every point
handed to the jitted losses in the optimizer's bfloat16), each loss taken
in float32 at the bfloat16 ``x``; beside them the same runs in float32.

About a minute on 4 cores; each run holds ~1.7 GB.  Needs JAX, so it
runs here and not on the machine with the card.
"""
import json
import os
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
F64 = "--f64" in sys.argv[1:]
BF16_ITERATE = "--bf16-iterate" in sys.argv[1:]
if F64:
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from stochqn_tpu.core.config import (AdaQNConfig, OLBFGSConfig,  # noqa: E402
                                     SQNConfig)
from stochqn_tpu.free import SQN_free  # noqa: E402
from stochqn_tpu.fused import FusedTrainer  # noqa: E402
from stochqn_tpu.models import losses  # noqa: E402
from stochqn_tpu.utils.schedules import step_size_sqrt  # noqa: E402

N_FEATURES, N_CLASSES, BATCH_SIZE, NUM_BATCHES = 1836, 159, 50, 120
REG, STEP, ADAQN_STEP = 0.1, 1e-2, 1e-1


def bench_data(dtype):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((NUM_BATCHES, BATCH_SIZE, N_FEATURES)).astype(
        np.float32)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = np.eye(N_CLASSES, dtype=np.float32)[labels]
    x0 = rng.standard_normal((N_FEATURES + 1) * N_CLASSES).astype(np.float32)
    return tuple(jnp.asarray(a, dtype) for a in (X, Y, x0))


def free_sqn_epoch(opt, X, Y, x0, grad_j, hessvec_j):
    """One epoch of ``opt`` in the smoke's request loop
    (``chip_smoke.FreeLoop``); returns ``x`` and the request and info
    histograms."""
    x = np.array(x0, dtype=np.float32)
    req = opt.run_optimizer(x, STEP)
    b, tasks, infos = -1, {}, {}
    while not (req["task"] == "calc_grad" and opt.niter >= NUM_BATCHES):
        task, at = req["task"], req["requested_on"]
        if task == "calc_grad":
            b += 1
            bb = b % NUM_BATCHES
            opt.update_gradient(grad_j(jnp.asarray(at), X[bb], Y[bb]))
        else:
            r = (b % NUM_BATCHES) // 20
            rows = slice(r * 20, (r + 1) * 20)
            Xb = X[rows].transpose(1, 0, 2).reshape(-1, N_FEATURES)
            Yb = Y[rows].transpose(1, 0, 2).reshape(-1, N_CLASSES)
            opt.update_hess_vec(hessvec_j(jnp.asarray(at[0]),
                                          jnp.asarray(at[1]), Xb, Yb))
        req = opt.run_optimizer(x, STEP)
        tasks[req["task"]] = tasks.get(req["task"], 0) + 1
        name = req["info"]["iteration_info"]
        infos[name] = infos.get(name, 0) + 1
    return x, tasks, infos


def bf16_iterate():
    """Phase 20's runs: a bfloat16 iterate, and the same runs in float32."""
    X, Y, x0 = bench_data(jnp.float32)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    full_loss = jax.jit(lambda x: losses.multinomial_logistic_loss(
        x.astype(jnp.float32), Xf, Yf, None, REG))

    def grad_fn(x, b):
        return losses.multinomial_logistic_grad(x, b[0], b[1], None, REG)
    grad_j = jax.jit(lambda x, Xb, Yb: grad_fn(x, (Xb, Yb)))
    hessvec_j = jax.jit(lambda x, v, Xb, Yb: losses.multinomial_logistic_hessvec(
        x, v, Xb, Yb, None, REG))

    for it in (jnp.bfloat16, jnp.float32):
        for data_t in (jnp.bfloat16, jnp.float32):
            if it == jnp.float32 and data_t == jnp.bfloat16:
                continue
            trainer = FusedTrainer("SQN", SQNConfig.create(
                mem_size=10, bfgs_upd_freq=20), grad_fn)
            epoch = jax.jit(trainer.epoch, static_argnames=("aligned",))
            state, infos = trainer.init(x0.astype(it)), []
            data = (X.astype(data_t), Y.astype(data_t))
            for _ in range(2):
                state, info = epoch(state, data, STEP, aligned=True)
                infos.append(np.asarray(info))
            flat = np.concatenate(infos)
            codes, counts = np.unique(flat, return_counts=True)
            print(json.dumps(dict(
                run=f"fused_sqn_x_{jnp.dtype(it).name}_data_"
                    f"{jnp.dtype(data_t).name}",
                loss=float(full_loss(state.x)), x_dtype=str(state.x.dtype),
                pair_dtype=str(state.mem.s.dtype),
                gram_dtype=str(state.mem.gram.dtype),
                infos={int(c): int(k) for c, k in zip(codes, counts)},
                live_pairs=int(state.mem.count))), flush=True)
        opt = SQN_free(mem_size=10, bfgs_upd_freq=20, dtype=it)
        x, tasks, infos = free_sqn_epoch(opt, X, Y, x0, grad_j, hessvec_j)
        print(json.dumps(dict(
            run=f"free_sqn_1_epoch_{jnp.dtype(it).name}",
            loss=float(full_loss(jnp.asarray(x))), tasks=tasks, infos=infos,
            live_pairs=int(opt.state.mem.count))), flush=True)


def main():
    if BF16_ITERATE:
        return bf16_iterate()
    X, Y, x0 = bench_data(jnp.float64 if F64 else jnp.float32)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    data = (X, Y)

    def grad_fn(x, b):
        return losses.multinomial_logistic_grad(x, b[0], b[1], None, REG)

    def obj_fn(x, b):
        return losses.multinomial_logistic_loss(x, b[0], b[1], None, REG)
    full_loss = jax.jit(lambda x: obj_fn(x, (Xf, Yf)))

    def report(name, state, infos):
        flat = np.asarray(infos).reshape(-1)
        codes, counts = np.unique(flat, return_counts=True)
        out = dict(run=name, dtype="float64" if F64 else "float32",
                   loss=float(full_loss(state.x)),
                   infos={int(c): int(k) for c, k in zip(codes, counts)},
                   live_pairs=int(state.mem.count), niter=int(state.niter))
        if hasattr(state, "fisher"):
            out.update(boundary_codes=[int(v) for v in flat[19::20]],
                       fisher_rows=int(state.fisher.count))
        print(json.dumps(out), flush=True)

    def epochs(name, trainer, epoch_data, eta, aligned=None):
        epoch = jax.jit(trainer.epoch, static_argnames=("aligned",))
        state, infos = trainer.init(x0), []
        for d in epoch_data:
            state, info = epoch(state, d, eta, aligned=aligned)
            infos.append(np.asarray(info))
        report(name, state, np.concatenate(infos))

    def sqn(**kw):
        return FusedTrainer("SQN", SQNConfig.create(
            mem_size=10, bfgs_upd_freq=20, **kw), grad_fn)

    d110, d10 = (X[:110], Y[:110]), (X[:10], Y[:10])
    epochs("sqn_aligned", sqn(), [data, data], STEP, aligned=True)
    epochs("sqn_generic_110", sqn(), [d110, d110], STEP, aligned=False)
    epochs("sqn_resume_10_then_1_epoch", sqn(), [d10, data], STEP,
           aligned=False)
    rng = np.random.default_rng(2)
    orders = np.stack([rng.permutation(NUM_BATCHES * BATCH_SIZE)
                       for _ in range(3)]).astype(np.int32)
    steps = jnp.asarray([step_size_sqrt(STEP, e) for e in range(3)],
                        X.dtype)
    trainer = sqn()
    state, infos = trainer.jit_epochs_scheduled()(
        trainer.init(x0), (Xf, Yf), steps, jnp.asarray(orders),
        batch_size=BATCH_SIZE, aligned=True)
    report("sqn_scheduled_3", state, infos)
    for bf16 in (False, True):
        epochs(f"olbfgs_interleaved_bf16={bf16}", FusedTrainer(
            "oLBFGS", OLBFGSConfig.create(mem_size=10, pairs_bf16=bf16,
                                          pairs_interleaved=True), grad_fn),
            [data, data], STEP)
    # The same 240 bfloat16 steps as 240 one-batch epochs: another XLA
    # program, whose float32 sums round differently.  In float32 that
    # flips bfloat16 roundings of the stored rows and the two runs fork;
    # in float64 they agree.
    epochs("olbfgs_interleaved_bf16=True_one_batch_epochs", FusedTrainer(
        "oLBFGS", OLBFGSConfig.create(mem_size=10, pairs_bf16=True,
                                      pairs_interleaved=True), grad_fn),
        [(X[i:i + 1], Y[i:i + 1]) for _ in range(2)
         for i in range(NUM_BATCHES)], STEP)
    if F64:
        return
    epochs("sqn_bf16_block", sqn(pairs_bf16=True), [data, data], STEP,
           aligned=True)
    epochs("sqn_bf16_interleaved", sqn(pairs_bf16=True,
                                       pairs_interleaved=True),
           [data, data], STEP, aligned=True)
    for coupling in ("gram", "matvec"):
        for bf16 in (False, True):
            epochs(f"adaqn_{coupling}_fisher_bf16={bf16}", FusedTrainer(
                "adaQN", AdaQNConfig.create(
                    mem_size=10, fisher_size=100, bfgs_upd_freq=20,
                    rmsprop_weight=0.9, coupling=coupling,
                    fisher_bf16=bf16), grad_fn, obj_fn=obj_fn),
                [data, data], ADAQN_STEP, aligned=True)


if __name__ == "__main__":
    main()
