"""Binary logistic regression on padded-COO rows with no intercept, as
the program computes it: ``stochqn_tpu_torch.models.sparse``'s gradient
and Hessian-vector product on batches ``(idx, val, y)``, the loss summed
over the rows, ``reg_param`` on every weight.  The functions are looked
up at each call, so a fault planted in the program's module reaches
them."""
from __future__ import annotations

import torch


def batches(data: dict) -> tuple:
    """The program's epoch data: leaves ``[num_batches, batch_size, ...]``."""
    return data["idx"], data["val"], data["y"]


def program(cfg: dict):
    """``(grad_fn(x, batch), hess_vec_fn(x, v, batch))`` on the program's
    functions."""
    from stochqn_tpu_torch.models import sparse
    reg, n = cfg["reg_param"], cfg["n_features"]

    def grad_fn(x, batch):
        return sparse.sparse_binary_logistic_grad(x, *batch, n, None, reg)

    def hess_vec_fn(x, v, batch):
        return sparse.sparse_binary_logistic_hessvec(x, v, *batch, n, None,
                                                     reg)
    return grad_fn, hess_vec_fn


# the program's gradient, where a fault is planted
GRAD = ("stochqn_tpu_torch.models.sparse", "sparse_binary_logistic_grad")


def half_batch(fn):
    """``fn`` on the first half of the batch's rows, each weighted 2: the
    rest left out and the mean taken over what is left."""
    def grad(x, idx, val, y, n_features, sample_weight=None, reg_param=0.0):
        h = idx.shape[0] // 2
        w = 2.0 * (torch.ones(h, dtype=x.dtype, device=x.device)
                   if sample_weight is None else sample_weight[:h])
        return fn(x, idx[:h], val[:h], y[:h], n_features, w, reg_param)
    return grad
