"""Plain logistic losses, gradients and Hessian-vector products.

Written from the textbook formulas in plain PyTorch, for the benchmark's
check alone: no kernel, cache or batching of the program under test, and
no import of it.  Every function computes in the dtype of ``x``.

* multinomial: one-hot ``Y [B, K]``, parameters ``[K, F + 1]`` flattened
  row-major (the last column the intercept), per-row weights ``w [B]``,
  loss ``-sum_i w_i sum_c Y_ic log softmax(z_i)_c + reg/2 ||coef||^2``
  (the intercept unregularized);
* sparse binary: padded COO rows (``idx [B, k]`` feature ids, ``val [B,
  k]`` values, a pad slot being value 0), labels ``+1`` / ``-1``, no
  intercept, loss ``sum_i log(1 + exp(-y_i z_i)) + reg/2 ||x||^2``.
"""
from __future__ import annotations

import torch


# -- dense multinomial ------------------------------------------------------ #
def _split(x, n_features, n_classes):
    w = x.reshape(n_classes, n_features + 1)
    return w[:, :n_features], w[:, n_features]


def _logits(x, X, n_classes):
    coef, b = _split(x, X.shape[1], n_classes)
    return X.to(x.dtype) @ coef.T + b


def _weights(w, X, x):
    if w is None:
        return torch.ones(X.shape[0], dtype=x.dtype, device=x.device)
    return w.to(x.dtype)


def multinomial_loss(x, X, Y, w=None, reg=0.0):
    K = Y.shape[1]
    logp = torch.log_softmax(_logits(x, X, K), dim=1)
    coef, _ = _split(x, X.shape[1], K)
    data = -(_weights(w, X, x)[:, None] * Y.to(x.dtype) * logp).sum()
    return data + 0.5 * reg * (coef * coef).sum()


def multinomial_grad(x, X, Y, w=None, reg=0.0):
    K = Y.shape[1]
    Xc = X.to(x.dtype)
    r = _weights(w, X, x)[:, None] * (torch.softmax(_logits(x, X, K), dim=1)
                                      - Y.to(x.dtype))            # [B, K]
    coef, _ = _split(x, X.shape[1], K)
    g_coef = r.T @ Xc + reg * coef
    return torch.cat([g_coef, r.sum(0)[:, None]], dim=1).reshape(-1)


def multinomial_hessvec(x, v, X, Y, w=None, reg=0.0):
    """``H v`` of :func:`multinomial_loss`: per row the softmax Jacobian
    ``diag(p) - p p^T`` applied to ``X v``, mapped back by ``X^T``."""
    K = Y.shape[1]
    Xc = X.to(x.dtype)
    p = torch.softmax(_logits(x, X, K), dim=1)
    v_coef, v_b = _split(v, X.shape[1], K)
    u = Xc @ v_coef.T + v_b                                        # [B, K]
    r = _weights(w, X, x)[:, None] * p * (u - (p * u).sum(1, keepdim=True))
    h_coef = r.T @ Xc + reg * v_coef
    return torch.cat([h_coef, r.sum(0)[:, None]], dim=1).reshape(-1)


# -- sparse binary (padded COO) --------------------------------------------- #
def _margins(x, idx, val):
    return (x[idx] * val.to(x.dtype)).sum(1)


def _scatter(x, idx, val, t):
    out = torch.zeros_like(x)
    out.index_add_(0, idx.reshape(-1),
                   (val.to(x.dtype) * t[:, None]).reshape(-1))
    return out


def sparse_binary_loss(x, idx, val, y, reg=0.0):
    z = _margins(x, idx, val) * y.to(x.dtype)
    return torch.nn.functional.softplus(-z).sum() + 0.5 * reg * (x * x).sum()


def sparse_binary_grad(x, idx, val, y, reg=0.0):
    yy = y.to(x.dtype)
    t = -yy * torch.sigmoid(-yy * _margins(x, idx, val))
    return _scatter(x, idx, val, t) + reg * x


def sparse_binary_hessvec(x, v, idx, val, y, reg=0.0):
    p = torch.sigmoid(_margins(x, idx, val))
    t = p * (1 - p) * _margins(v, idx, val)
    return _scatter(x, idx, val, t) + reg * v
