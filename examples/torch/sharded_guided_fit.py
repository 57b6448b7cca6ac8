"""Sharded guided fit with the PyTorch port: ``fit(engine="fused",
mesh=...)`` on a ``(data, param)`` mesh.

The counterpart of ``examples/sharded_guided_fit.py``.  The guided driver
(the reference's ``fit`` loop, ``stochqn/_optimizers.py:199-286``) runs
its epochs on the fused engine; with a mesh, every rank holds its slice
of the optimizer state's parameter axis (``param``) and evaluates its
rows of every minibatch (``data``), and the ranks sum what they computed
in all-reduces.  With per-epoch shuffling the whole fit is still one call
of the engine: the row orders are worked out on the host beforehand and
each epoch gathers its rows on the device.

The script starts its own ranks, a 2 x 2 mesh: ``--device cpu`` spawns 4
processes joined over gloo; on the card (the default) one process per
GPU over NCCL, which needs 4.  The ranks meet through a file in a
temporary directory.  float64, so that the sharded fit can be held to the
unsharded one closely.

Run: python examples/torch/sharded_guided_fit.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

N_DATA, N_PARAM = 2, 2


def rank_main(rank, world, device, rdv):
    from stochqn_tpu_torch.guided import SQN
    from stochqn_tpu_torch.parallel import make_mesh

    if device == "cuda":
        torch.cuda.set_device(rank)
    else:       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{rdv}", world_size=world,
                            rank=rank)
    try:
        rng = np.random.default_rng(0)
        n_rows, n_features = 4000, 64
        X = rng.standard_normal((n_rows, n_features))
        w_true = rng.standard_normal(n_features)
        y = X @ w_true + 0.05 * rng.standard_normal(n_rows)

        # written with operators numpy arrays and tensors share, so the
        # fused engine can run them on the device; each averages over the
        # rows it is given (reduction="mean")
        def obj(w, Xb, yb, sample_weight=None, **kw):
            return 0.5 * ((Xb @ w - yb) ** 2).mean()

        def grad(w, Xb, yb, sample_weight=None, **kw):
            return Xb.T @ (Xb @ w - yb) / Xb.shape[0]

        mesh = make_mesh(n_data=N_DATA, n_param=N_PARAM, device_type=device)
        if rank == 0:
            print(f"mesh: data={N_DATA} x param={N_PARAM} over {world} "
                  f"{device} ranks", flush=True)

        def make():
            return SQN(np.zeros(n_features), grad, obj_fun=obj,
                       use_grad_diff=True, step_size=0.2,
                       batches_per_epoch=20, bfgs_upd_freq=5, nepochs=10,
                       verbose=False, dtype=torch.float64,
                       device=torch.device(device, rank)
                       if device == "cuda" else device)

        opt = make()
        opt.fit(X, y, engine="fused", mesh=mesh, reduction="mean")
        ref = make()
        ref.fit(X, y, engine="fused")           # the same fit, unsharded

        final = obj(opt.x, X, y)
        drift = np.max(np.abs(opt.x - ref.x))
        if rank == 0:
            one = opt._fused_single_dispatch
            print(f"dispatch mode: {opt._fused_dispatch_mode} (whole fit = "
                  f"{'ONE engine call' if one else 'per-epoch calls'})")
            print(f"iterations: {opt.niter}, final loss {final:.6f}, "
                  f"w error {np.linalg.norm(opt.x - w_true):.4f}")
            print(f"sharded vs unsharded max |dx|: {drift:.2e} "
                  "(float summation order only)", flush=True)
        assert drift < 1e-8 and final < 0.05
        dist.barrier()
        if rank == 0:
            print("ok", flush=True)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    world = N_DATA * N_PARAM
    if args.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"the {N_DATA} x {N_PARAM} mesh needs {world} GPUs "
                         "(NCCL takes one rank per GPU): pass --device cpu")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            rank_main, args=(world, args.device, os.path.join(tmp, "rdv")),
            nprocs=world, join=True)


if __name__ == "__main__":
    main()
