"""The plain reference's multinomial model on the benchmark's data: the
gradient on iteration ``t``'s minibatch (batch ``t mod num_batches``), the
Hessian-vector product on round ``r``'s big batch (its ``bfgs_upd_freq``
minibatches merged) and the full-data loss in float64."""
from __future__ import annotations

from portbench.reference import losses


def bind(cfg: dict, data: dict, dtype):
    X, Y = data["X"].to(dtype), data["Y"].to(dtype)
    B, L, reg = cfg["num_batches"], cfg["bfgs_upd_freq"], cfg["reg_param"]
    rounds = B // L
    F, K = X.shape[2], Y.shape[2]

    def grad(x, t):
        return losses.multinomial_grad(x, X[t % B], Y[t % B], None, reg)

    def hessvec(x, v, r):
        r %= rounds
        return losses.multinomial_hessvec(
            x, v, X[r * L:(r + 1) * L].reshape(-1, F),
            Y[r * L:(r + 1) * L].reshape(-1, K), None, reg)

    def loss(x):
        dev = data["X"].device
        return float(losses.multinomial_loss(
            x.to(dev).double(),
            data["X"].reshape(-1, F).double(),
            data["Y"].reshape(-1, K).double(), None, reg))
    return grad, hessvec, loss
