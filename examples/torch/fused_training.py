"""Fused training with the PyTorch port: multinomial logistic regression
at BibTeX scale.

The counterpart of ``examples/fused_tpu_training.py``.  ``FusedTrainer``
runs each epoch's minibatch gradients, collapsed two-loop directions (the
hand-written direction kernel on the card), big-batch Hessian-vector
products and pair commits with no read of the device between steps.  The
configuration behind the repository's benchmark (``bench.py``).

Run: python examples/torch/fused_training.py [--device cpu]

(``--features`` and ``--num-batches`` shrink the problem for a quick run
on the CPU.)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu_torch import FusedTrainer, SQNConfig  # noqa: E402
from stochqn_tpu_torch.models import losses  # noqa: E402

N_CLASSES, BATCH = 159, 50


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--features", type=int, default=1836)
    ap.add_argument("--num-batches", type=int, default=120)
    args = ap.parse_args()
    dev = torch.device(args.device)
    nf, nb = args.features, args.num_batches

    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal(
        (nb, BATCH, nf)).astype(np.float32)).to(dev)
    labels = rng.integers(0, N_CLASSES, (nb, BATCH))
    Y = torch.from_numpy(np.eye(N_CLASSES, dtype=np.float32)[labels]).to(dev)
    x0 = rng.standard_normal((nf + 1) * N_CLASSES).astype(np.float32)

    def grad_fn(x, batch):
        Xb, Yb = batch
        return losses.multinomial_logistic_grad(x, Xb, Yb, None, 1e-1)

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(
            x, X.reshape(-1, nf), Y.reshape(-1, N_CLASSES), None,
            1e-1))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    trainer = FusedTrainer(
        "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=20), grad_fn)
    state = trainer.init(x0, device=dev)
    print(f"device: {dev}  initial loss: {full_loss(state.x):.1f}")
    for e in range(args.epochs):
        t0 = time.perf_counter()
        state, infos = trainer.epoch(state, (X, Y), 1e-2, aligned=True)
        sync()
        dt = time.perf_counter() - t0
        print(f"epoch {e}: loss {full_loss(state.x):12.1f}   "
              f"{nb / dt:8.0f} iters/s")

    # more epochs in one call, with a per-epoch step-size schedule: the
    # host count of iterations carries the round boundaries, so nothing is
    # read from the device between them
    steps = torch.tensor([1e-2 / np.sqrt(e + 1) for e in range(5)],
                         device=dev)
    t0 = time.perf_counter()
    state, infos = trainer.epochs(state, (X, Y), steps, nepochs=5,
                                  aligned=True)
    sync()
    dt = time.perf_counter() - t0
    print(f"5 more epochs in one call: loss {full_loss(state.x):12.1f}   "
          f"{5 * nb / dt:8.0f} iters/s   infos shape "
          f"{tuple(infos.shape)}")


if __name__ == "__main__":
    main()
