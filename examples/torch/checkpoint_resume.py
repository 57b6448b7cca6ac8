"""Checkpoint and resume through the fused engine, mid-protocol, with the
PyTorch port.

The counterpart of ``examples/checkpoint_resume.py``.  The whole
optimizer state (pair ring, Fisher memory, averages, accumulators and the
``section`` resume point) is a dataclass of tensors, so a snapshot taken
at any iteration restores exactly: the resumed run reproduces the
uninterrupted trajectory bit for bit on the same device
(``utils/checkpoint.py``: ``.npz`` files, no extra dependency).

Run: python examples/torch/checkpoint_resume.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               batchify, load_state, save_state)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    n, rows, bs = 32, 240, 8
    w_true = rng.standard_normal(n)
    X = torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32,
                     device=dev)
    y = X @ torch.tensor(w_true, dtype=torch.float32, device=dev) + 0.05 * (
        torch.tensor(rng.standard_normal(rows), dtype=torch.float32,
                     device=dev))
    data = batchify((X, y), bs)

    def grad_fn(w, batch):
        Xb, yb = batch
        return Xb.T @ (Xb @ w - yb) / Xb.shape[0]

    def obj_fn(w, batch):
        Xb, yb = batch
        return 0.5 * torch.mean((Xb @ w - yb) ** 2)

    trainer = FusedTrainer(
        "adaQN", AdaQNConfig.create(mem_size=5, bfgs_upd_freq=4,
                                    fisher_size=16, max_incr=1.01),
        grad_fn, obj_fn=obj_fn)
    zeros = torch.zeros(n, device=dev)
    print(f"initial full-data loss = {float(obj_fn(zeros, (X, y))):.6f}")

    # uninterrupted run: 4 epochs
    state = trainer.init(zeros)
    state, _ = trainer.epochs(state, data, 0.1, nepochs=4, aligned=True)
    x_full = state.x.cpu().numpy()

    # interrupted run: 2 epochs, checkpoint, restart, 2 more
    state = trainer.init(zeros)
    state, _ = trainer.epochs(state, data, 0.1, nepochs=2, aligned=True)
    with tempfile.TemporaryDirectory(prefix="sqn_ckpt_") as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        save_state(ckpt, state)
        print(f"checkpointed at iteration {int(state.niter)} -> {ckpt}")
        resumed = load_state(ckpt, trainer.init(zeros))   # fresh template
    assert int(resumed.niter) == int(state.niter)
    resumed, _ = trainer.epochs(resumed, data, 0.1, nepochs=2, aligned=True)
    x_resumed = resumed.x.cpu().numpy()

    diff = float(np.max(np.abs(x_full - x_resumed)))
    loss = float(obj_fn(resumed.x, (X, y)))
    print(f"max |x_full - x_resumed| = {diff:.2e}  (bitwise resume)")
    print(f"final full-data loss = {loss:.6f}")
    assert diff == 0.0, "resume diverged from the uninterrupted run"
    print("OK")


if __name__ == "__main__":
    main()
