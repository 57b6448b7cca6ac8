"""Closed-form logistic losses, gradients and Hessian-vector products.

Counterpart of :mod:`stochqn_tpu.models.losses`, with the same conventions:

* binary: labels in {-1, +1} (anything > 0 maps to +1), parameter vector
  ``[n_features (+ 1 intercept)]``, loss
  ``sum_i w_i log(1 + exp(-y_i z_i)) + 0.5 reg ||coef||^2`` (intercept
  unregularized);
* multinomial: one-hot ``Y [n, k]``, parameters ``[k, n_features (+1)]``
  flattened row-major, loss ``-sum_i w_i sum_c Y log softmax(z)_c
  + 0.5 reg ||coef||^2``.

:func:`hvp_from_grad` is forward-over-reverse: ``torch.func.jvp`` of a
gradient function, what the fused engine uses when no closed-form
Hessian-vector product is given.

Data of another floating dtype than the parameters (float32 features with
a bfloat16 iterate) is cast to the parameters' dtype inside each product,
as the JAX package's ``jnp.matmul(..., preferred_element_type=w.dtype)``
does on the CPU: a bfloat16 iterate gives the same steps on float32 data
as on the same data rounded to bfloat16.
"""
from __future__ import annotations

from typing import Callable

import torch


def hvp_from_grad(grad_fun: Callable) -> Callable:
    """``grad_fun(x, *args) -> [n]``; returns ``hvp(x, v, *args) -> [n]``."""
    def hvp(x, v, *args):
        return torch.func.jvp(lambda xx: grad_fun(xx, *args), (x,), (v,))[1]
    return hvp


def _mm(a, b, dtype):
    """``a @ b`` with operands of two dtypes cast to ``dtype`` first
    (torch refuses a mixed matmul)."""
    if a.dtype == b.dtype:
        return a @ b
    return a.to(dtype) @ b.to(dtype)


def _ensure_weights(sample_weight, n, dtype, device):
    if sample_weight is None:
        return torch.ones(n, dtype=dtype, device=device)
    return torch.as_tensor(sample_weight, dtype=dtype,
                           device=device).reshape(-1)


# --------------------------------------------------------------------------
# Binary logistic regression
# --------------------------------------------------------------------------
def _split_bin(w, n_features):
    if w.shape[0] == n_features + 1:
        return w[:n_features], w[n_features]
    return w, torch.zeros((), dtype=w.dtype, device=w.device)


def _bin_margins(w, X):
    coef, b = _split_bin(w, X.shape[1])
    return _mm(X, coef, w.dtype) + b


def _signs(y, w):
    y = torch.as_tensor(y, device=w.device).reshape(-1)
    return torch.where(y > 0, 1.0, -1.0).to(w.dtype)


def binary_logistic_loss(w, X, y, sample_weight=None, reg_param=0.0):
    y = _signs(y, w)
    sw = _ensure_weights(sample_weight, X.shape[0], w.dtype, w.device)
    z = _bin_margins(w, X) * y
    # log(1 + exp(-z)), stable
    loss = torch.sum(sw * torch.logaddexp(torch.zeros_like(z), -z))
    coef, _ = _split_bin(w, X.shape[1])
    return loss + 0.5 * reg_param * torch.dot(coef, coef)


def binary_logistic_grad(w, X, y, sample_weight=None, reg_param=0.0):
    y = _signs(y, w)
    sw = _ensure_weights(sample_weight, X.shape[0], w.dtype, w.device)
    z = _bin_margins(w, X)
    t = sw * (torch.sigmoid(y * z) - 1.0) * y     # [n]
    coef, _ = _split_bin(w, X.shape[1])
    g_coef = _mm(t, X, w.dtype) + reg_param * coef
    if w.shape[0] == X.shape[1] + 1:
        return torch.cat([g_coef, torch.sum(t)[None]])
    return g_coef


def binary_logistic_hessvec(w, v, X, y, sample_weight=None, reg_param=0.0):
    sw = _ensure_weights(sample_weight, X.shape[0], w.dtype, w.device)
    sig = torch.sigmoid(_bin_margins(w, X))
    dd = sw * sig * (1.0 - sig)                   # [n]
    nf = X.shape[1]
    v_coef, v_b = _split_bin(v, nf)
    t = dd * (_mm(X, v_coef, w.dtype) + v_b)
    h_coef = _mm(t, X, w.dtype) + reg_param * v_coef
    if w.shape[0] == nf + 1:
        return torch.cat([h_coef, torch.sum(t)[None]])
    return h_coef


def binary_logistic_predict_proba(w, X):
    return torch.sigmoid(_bin_margins(w, X))


# --------------------------------------------------------------------------
# Multinomial logistic regression
# --------------------------------------------------------------------------
def _split_mult(w, n_features, n_classes):
    w = w.reshape(n_classes, -1)
    if w.shape[1] == n_features + 1:
        return w[:, :n_features], w[:, n_features]
    return w, torch.zeros(n_classes, dtype=w.dtype, device=w.device)


def _mult_logits(w, X, n_classes):
    coef, b = _split_mult(w, X.shape[1], n_classes)
    return _mm(X, coef.T, w.dtype) + b[None, :]


def multinomial_logistic_loss(w, X, Y, sample_weight=None, reg_param=0.0):
    n_classes = Y.shape[1]
    Y = Y.to(w.dtype)
    sw = _ensure_weights(sample_weight, X.shape[0], w.dtype, w.device)
    logp = torch.log_softmax(_mult_logits(w, X, n_classes), dim=-1)
    loss = -torch.sum(sw[:, None] * Y * logp)
    coef, _ = _split_mult(w, X.shape[1], n_classes)
    return loss + 0.5 * reg_param * torch.sum(coef * coef)


def multinomial_logistic_grad(w, X, Y, sample_weight=None, reg_param=0.0):
    n_classes = Y.shape[1]
    Y = Y.to(w.dtype)
    sw = _ensure_weights(sample_weight, X.shape[0], w.dtype, w.device)
    p = torch.softmax(_mult_logits(w, X, n_classes), dim=-1)
    diff = sw[:, None] * (p - Y)                   # [n, k]
    coef, _ = _split_mult(w, X.shape[1], n_classes)
    g_coef = _mm(diff.T, X, w.dtype) + reg_param * coef     # [k, nf]
    if w.shape[0] == n_classes * (X.shape[1] + 1):
        g_b = torch.sum(diff, dim=0)               # [k]
        return torch.cat([g_coef, g_b[:, None]], dim=1).reshape(-1)
    return g_coef.reshape(-1)


def multinomial_logistic_hessvec(w, v, X, Y, sample_weight=None,
                                 reg_param=0.0):
    """Closed-form multinomial Hessian-vector product (the multinomial
    Hessian equals its GGN); same math as sklearn's
    ``_multinomial_grad_hess``."""
    n_classes = Y.shape[1]
    sw = _ensure_weights(sample_weight, X.shape[0], w.dtype, w.device)
    nf = X.shape[1]
    p = torch.softmax(_mult_logits(w, X, n_classes), dim=-1)   # [n, k]
    v_coef, v_b = _split_mult(v, nf, n_classes)
    zv = _mm(X, v_coef.T, w.dtype) + v_b[None, :]
    # r = p * zv - p * (sum_c p_c zv_c)
    inner = torch.sum(p * zv, dim=1, keepdim=True)
    r = sw[:, None] * p * (zv - inner)             # [n, k]
    h_coef = _mm(r.T, X, w.dtype) + reg_param * v_coef
    if w.shape[0] == n_classes * (nf + 1):
        h_b = torch.sum(r, dim=0)
        return torch.cat([h_coef, h_b[:, None]], dim=1).reshape(-1)
    return h_coef.reshape(-1)


def multinomial_logistic_predict_proba(w, X, n_classes):
    """Per-class sigmoid scores, matching the reference's prediction
    function (``stochqn/_logistic.py:14-20`` applies an elementwise sigmoid
    to the margins rather than a softmax)."""
    return torch.sigmoid(_mult_logits(w, X, n_classes))


def multinomial_logistic_predict_softmax(w, X, n_classes):
    """Softmax class probabilities (an extra of the JAX package)."""
    return torch.softmax(_mult_logits(w, X, n_classes), dim=-1)
