"""Multinomial logistic regression with an intercept, as the program
computes it: the gradient and the closed-form Hessian-vector product of
``stochqn_tpu_torch.models.losses`` on dense batches ``(X, Y)`` (one-hot
``Y``), the loss summed over the rows, ``reg_param`` on the coefficients.
The functions are looked up at each call, so a fault planted in the
program's module reaches them."""
from __future__ import annotations

import torch


def batches(data: dict) -> tuple:
    """The program's epoch data: leaves ``[num_batches, batch_size, ...]``."""
    return data["X"], data["Y"]


def program(cfg: dict):
    """``(grad_fn(x, batch), hess_vec_fn(x, v, batch))`` on the program's
    functions."""
    from stochqn_tpu_torch.models import losses
    reg = cfg["reg_param"]

    def grad_fn(x, batch):
        return losses.multinomial_logistic_grad(x, batch[0], batch[1], None,
                                                reg)

    def hess_vec_fn(x, v, batch):
        return losses.multinomial_logistic_hessvec(x, v, batch[0], batch[1],
                                                   None, reg)
    return grad_fn, hess_vec_fn


# the program's gradient, where a fault is planted
GRAD = ("stochqn_tpu_torch.models.losses", "multinomial_logistic_grad")


def half_batch(fn):
    """``fn`` on the first half of the batch's rows, each weighted 2: the
    rest left out and the mean taken over what is left."""
    def grad(x, X, Y, sample_weight=None, reg_param=0.0):
        h = X.shape[0] // 2
        w = 2.0 * (torch.ones(h, dtype=x.dtype, device=x.device)
                   if sample_weight is None else sample_weight[:h])
        return fn(x, X[:h], Y[:h], w, reg_param)
    return grad
