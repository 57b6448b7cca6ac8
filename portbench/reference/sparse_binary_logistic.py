"""The plain reference's sparse binary model on the benchmark's data: the
gradient on iteration ``t``'s minibatch (batch ``t mod num_batches``), the
Hessian-vector product on round ``r``'s big batch (its ``bfgs_upd_freq``
minibatches merged) and the full-data loss in float64."""
from __future__ import annotations

from portbench.reference import losses


def bind(cfg: dict, data: dict, dtype):
    idx, val, y = data["idx"], data["val"].to(dtype), data["y"].to(dtype)
    B, L, reg = cfg["num_batches"], cfg["bfgs_upd_freq"], cfg["reg_param"]
    rounds = B // L
    k = idx.shape[2]

    def grad(x, t):
        b = t % B
        return losses.sparse_binary_grad(x, idx[b], val[b], y[b], reg)

    def hessvec(x, v, r):
        r %= rounds
        part = slice(r * L, (r + 1) * L)
        return losses.sparse_binary_hessvec(
            x, v, idx[part].reshape(-1, k), val[part].reshape(-1, k),
            y[part].reshape(-1), reg)

    def loss(x):
        dev = idx.device
        return float(losses.sparse_binary_loss(
            x.to(dev).double(), idx.reshape(-1, k),
            data["val"].reshape(-1, k).double(),
            data["y"].reshape(-1).double(), reg))
    return grad, hessvec, loss
