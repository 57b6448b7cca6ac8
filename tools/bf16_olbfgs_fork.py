#!/usr/bin/env python3
"""Why bfloat16 oLBFGS in float32 cannot be held to the JAX package step
for step, and why float64 can.

Runs fused oLBFGS (``mem_size=10``, ``pairs_interleaved=True``, eta 1e-2)
on ``chip_smoke.bench_data``'s data (the BibTeX shape) on the CPU, in the
JAX package and in the PyTorch port, one minibatch per call, and prints:

* float32, bfloat16 pairs: after the first commit, how many stored
  bfloat16 entries differ between the two packages, and how far apart
  rho and gamma are after three steps; then the relative distance of x
  after 10, 20 and 40 steps between the port and the JAX package, between
  the JAX package's one-batch calls and its scanned epoch of the same
  batches (two XLA programs of one package), and between the JAX
  package's float32 and bfloat16 pairs;
* float64 (data, x0 and math), bfloat16 pairs, 2 epochs: the port's loss
  against the JAX package's, and the JAX float64-pair run's.

    JAX_PLATFORMS=cpu python tools/bf16_olbfgs_fork.py

About a minute on 4 cores, ~2 GB.  Needs JAX and the port.
"""
import os
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from stochqn_tpu.core.config import OLBFGSConfig as JaxConfig  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu_torch import FusedTrainer, OLBFGSConfig  # noqa: E402
from stochqn_tpu_torch.models import losses as tl  # noqa: E402

N_FEATURES, N_CLASSES, BATCH_SIZE, NUM_BATCHES = 1836, 159, 50, 120
REG, STEP, MEM = 0.1, 1e-2, 10


def bench_data():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((NUM_BATCHES, BATCH_SIZE, N_FEATURES)).astype(
        np.float32)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = np.eye(N_CLASSES, dtype=np.float32)[labels]
    x0 = rng.standard_normal((N_FEATURES + 1) * N_CLASSES).astype(np.float32)
    return X, Y, x0


def trainers(bf16):
    jtr = JaxTrainer("oLBFGS", JaxConfig.create(
        mem_size=MEM, pairs_bf16=bf16, pairs_interleaved=True),
        lambda x, b: jl.multinomial_logistic_grad(x, b[0], b[1], None, REG))
    ttr = FusedTrainer("oLBFGS", OLBFGSConfig.create(
        mem_size=MEM, pairs_bf16=bf16, pairs_interleaved=True),
        lambda x, b: tl.multinomial_logistic_grad(x, b[0], b[1], None, REG))
    return jtr, ttr


def as_np(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float64))


def rel(a, b):
    a, b = as_np(a), as_np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def float32_fork(X, Y, x0, steps=40):
    xs = {}
    for bf16 in (False, True):
        jtr, ttr = trainers(bf16)
        epoch = jax.jit(jtr.epoch)
        js = jtr.init(jnp.asarray(x0))
        ts = ttr.init(torch.from_numpy(x0), device="cpu")
        jx, tx = [], []
        for k in range(steps):
            js, _ = epoch(js, (jnp.asarray(X[k:k + 1]),
                               jnp.asarray(Y[k:k + 1])), STEP)
            ts, _ = ttr.epoch(ts, (torch.from_numpy(X[k:k + 1]),
                                   torch.from_numpy(Y[k:k + 1])), STEP)
            jx.append(np.asarray(js.x))
            tx.append(ts.x.clone())
            if bf16 and k == 0:
                diff = int((as_np(js.mem.sy) != as_np(ts.mem.sy)).sum())
                print(f"float32, bf16 pairs, after the first commit: "
                      f"{diff} of {ts.mem.sy.numel()} stored entries differ "
                      "between the packages", flush=True)
            if bf16 and k == 2:
                print(f"  after 3 steps: rho {rel(ts.mem.rho, js.mem.rho):.3e}"
                      f", gamma {rel(ts.mem.gamma, js.mem.gamma):.3e} apart",
                      flush=True)
        scan = {k: np.asarray(epoch(jtr.init(jnp.asarray(x0)), (
            jnp.asarray(X[:k]), jnp.asarray(Y[:k])), STEP)[0].x)
            for k in (10, 20, 40)}
        xs[bf16] = jx, tx, scan
    (j32, _, _), (j16, t16, s16) = xs[False], xs[True]
    for k in (10, 20, 40):
        print(f"  x after {k} steps, relative to the JAX bf16 one-batch run: "
              f"port bf16 {rel(t16[k - 1], j16[k - 1]):.3e}, JAX bf16 "
              f"scanned epoch {rel(s16[k], j16[k - 1]):.3e}, JAX float32 "
              f"pairs {rel(j32[k - 1], j16[k - 1]):.3e}", flush=True)


def float64_runs(X, Y, x0):
    X, Y, x0 = (a.astype(np.float64) for a in (X, Y, x0))
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    loss = {}
    for bf16 in (False, True):
        jtr, ttr = trainers(bf16)
        epoch = jax.jit(jtr.epoch)
        js = jtr.init(jnp.asarray(x0))
        for _ in range(2):
            js, _ = epoch(js, (jnp.asarray(X), jnp.asarray(Y)), STEP)
        loss["jax", bf16] = float(jl.multinomial_logistic_loss(
            js.x, jnp.asarray(Xf), jnp.asarray(Yf), None, REG))
    ts = ttr.init(torch.from_numpy(x0), device="cpu")
    ts, _ = ttr.epochs(ts, (torch.from_numpy(X), torch.from_numpy(Y)), STEP,
                       nepochs=2)
    port = float(tl.multinomial_logistic_loss(
        ts.x, torch.from_numpy(Xf), torch.from_numpy(Yf), None, REG))
    want = loss["jax", True]
    print(f"float64, bf16 pairs, 2 epochs: JAX {want!r}, port {port!r} "
          f"({abs(port - want) / want:.3e} apart); JAX float64 pairs "
          f"{loss['jax', False]!r} ({abs(loss['jax', False] - want) / want:.3e}"
          " apart)", flush=True)


def main():
    X, Y, x0 = bench_data()
    float32_fork(X, Y, x0)
    float64_runs(X, Y, x0)


if __name__ == "__main__":
    main()
