"""Free-mode request loop on the Rosenbrock function, with the PyTorch
port.

The counterpart of ``examples/rosenbrock_free_mode.py``: the user owns the
evaluation loop, the optimizer answers with requests.  ``--backend torch``
keeps the optimizer's state on ``--device`` (the card by default; ``cpu``
for the CPU), ``--backend native`` runs the C++ core of ``native/`` on the
CPU (built with ``g++`` at first use).  float64, as the reference.

Run: python examples/torch/rosenbrock_free_mode.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from stochqn_tpu_torch import SQN_free, oLBFGS_free  # noqa: E402


def rosen(x):
    return float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                        + (1.0 - x[:-1]) ** 2))


def rosen_grad(x):
    g = np.zeros_like(x)
    g[:-1] = -400 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
    g[1:] += 200 * (x[1:] - x[:-1] ** 2)
    return g


def rosen_hessvec(x, v, eps=1e-7):
    return (rosen_grad(x + eps * v) - rosen_grad(x - eps * v)) / (2 * eps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--optimizer", choices=["oLBFGS", "SQN"],
                    default="oLBFGS")
    ap.add_argument("--backend", choices=["torch", "native"], default="torch")
    ap.add_argument("--device", default="cuda",
                    help="where the torch backend's state lives")
    ap.add_argument("--step-size", type=float, default=2.5e-3)
    ap.add_argument("--max-evals", type=int, default=50000)
    args = ap.parse_args()

    where = {} if args.backend == "native" else {"device": args.device}
    x = np.array([-1.2, 1.0])
    if args.optimizer == "oLBFGS":
        opt = oLBFGS_free(mem_size=7, backend=args.backend, **where)
    else:
        opt = SQN_free(mem_size=7, bfgs_upd_freq=4, backend=args.backend,
                       **where)

    req = opt.run_optimizer(x, args.step_size)
    for _ in range(args.max_evals):
        task = req["task"]
        if task in ("calc_grad", "calc_grad_same_batch",
                    "calc_grad_big_batch"):
            opt.update_gradient(rosen_grad(np.asarray(req["requested_on"])))
        elif task == "calc_hess_vec":
            xr, vr = req["requested_on"]
            opt.update_hess_vec(rosen_hessvec(np.asarray(xr), np.asarray(vr)))
        req = opt.run_optimizer(x, args.step_size)
        if np.abs(rosen_grad(x)).max() < 1e-6:
            break

    print(f"{args.optimizer} ({args.backend}, {opt.device}): "
          f"x = ({x[0]:.6f}, {x[1]:.6f}), f = {rosen(x):.3e}, "
          f"{req['info']['iteration_number']} iterations")


if __name__ == "__main__":
    main()
