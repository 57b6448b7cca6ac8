"""Data-parallel SQN on a Criteo-style click-through-rate logistic
regression, with the PyTorch port.

The counterpart of ``examples/data_parallel_sqn.py``: large sparse CTR
data hashed into a dense feature space, every minibatch split over the
``data`` axis of a ``(data, param)`` mesh, one process per rank.  Each
rank evaluates its rows, and the gradients and Hessian-vector products
are summed over the ranks in one all-reduce each; every rank then takes
the same step.

The script starts its own ranks: ``--device cpu`` spawns ``--ranks``
processes (4 by default) joined over gloo; on the card (the default) one
process per visible GPU, joined over NCCL.  The ranks meet through a file
in a temporary directory.

Run: python examples/torch/data_parallel_sqn.py [--device cpu] [--ranks 4]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

HASH_DIM = 4096          # hashed feature space (the Criteo-style trick)
FIELDS = 39              # raw categorical fields per example
BATCH = 512
NUM_BATCHES = 64


def make_stream(rng, num_batches):
    """A synthetic CTR stream: FIELDS hashed indices per example, and its
    labels in {-1, +1}."""
    idx = rng.integers(0, HASH_DIM, (num_batches, BATCH, FIELDS))
    w_true = rng.standard_normal(HASH_DIM) * 0.3
    logits = w_true[idx].sum(axis=-1)            # X @ w_true, X the counts
    y = (rng.random(logits.shape) < 1 / (1 + np.exp(-logits))).astype(
        np.float32)
    return idx, 2 * y - 1


def counts(idx):
    """The dense hashed features of ``idx [B, rows, FIELDS]``."""
    X = np.zeros(idx.shape[:2] + (HASH_DIM,), np.float32)
    b, r = np.indices(idx.shape[:2])
    for f in range(FIELDS):
        np.add.at(X, (b, r, idx[..., f]), 1.0)
    return X


def rank_main(rank, world, device, rdv):
    from stochqn_tpu_torch import FusedTrainer, SQNConfig
    from stochqn_tpu_torch.models import losses
    from stochqn_tpu_torch.parallel import make_mesh

    if device == "cuda":
        torch.cuda.set_device(rank)
    else:       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{rdv}", world_size=world,
                            rank=rank)
    try:
        dev = torch.device(device, rank) if device == "cuda" else \
            torch.device(device)
        idx, y = make_stream(np.random.default_rng(0), NUM_BATCHES)
        # every rank makes the same stream and keeps its rows of each batch
        # (what shard_batches takes from full batches)
        rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
        X = torch.from_numpy(counts(idx[:, rows])).to(dev)
        y = torch.from_numpy(y[:, rows]).to(dev)

        def grad_fn(x, batch):      # a sum over the rows it is given
            Xb, yb = batch
            return losses.binary_logistic_grad(x, Xb, yb, None, 1e-6)

        mesh = make_mesh(n_data=world, n_param=1, device_type=device)
        trainer = FusedTrainer(
            "SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=8), grad_fn,
            mesh=mesh, reduction="sum")
        state = trainer.init(torch.zeros(HASH_DIM + 1, device=dev))
        if rank == 0:
            print(f"mesh: data={world} x param=1 over {device} "
                  f"({'nccl' if device == 'cuda' else 'gloo'})", flush=True)
        for e in range(3):
            t0 = time.perf_counter()
            state, _ = trainer.epoch(state, (X, y), 0.5, aligned=True)
            loss = losses.binary_logistic_loss(
                state.x, X.reshape(-1, HASH_DIM), y.reshape(-1), None, 0.0)
            dist.all_reduce(loss)          # the rows of every rank
            loss = float(loss) + 0.5e-6 * float(state.x[:-1] @ state.x[:-1])
            if rank == 0:
                print(f"epoch {e}: loss/row {loss / (NUM_BATCHES * BATCH):.4f}"
                      f"  ({NUM_BATCHES / (time.perf_counter() - t0):.0f} "
                      "iters/s)", flush=True)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (default: 4 on the CPU, every GPU)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    world = args.ranks or (4 if args.device == "cpu"
                           else torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            rank_main, args=(world, args.device, os.path.join(tmp, "rdv")),
            nprocs=world, join=True)


if __name__ == "__main__":
    main()
