"""Sparse-feature logistic losses for CTR-style workloads (padded COO).

Counterpart of :mod:`stochqn_tpu.models.sparse`.  A CSR matrix has a
different number of entries per row; :func:`csr_to_padded` converts it once
on the host to **padded COO**: every row stores exactly ``k`` (a multiple
of 8) ``(index, value)`` slots, padding with ``(0, 0)``, which adds nothing
to any product.

Compute mapping:

* margins: a gather of the coefficient rows at ``indices``
  (``index_select``) and a ``[B, k]`` multiply-reduce;
* gradients and Hessian-vector products: one scatter-add
  (``index_add``) of ``values * residual`` into a zero ``[n_features]``
  (or ``[n_features, n_classes]``) buffer.  The out-of-place
  ``index_add`` keeps the functions ``torch.func``-transformable.

On CUDA ``index_add`` accumulates with atomics, so float32 sparse
gradients are not bit-reproducible from run to run: hold them against the
dense forms within a tolerance, never by bits.

Conventions match :mod:`stochqn_tpu_torch.models.losses`: binary labels in
{-1, +1} (anything > 0 maps to +1), multinomial one-hot ``Y [B,
n_classes]`` with parameters ``[n_classes, n_features (+1)]`` flattened
row-major, the intercept unregularized.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import issparse

from stochqn_tpu_torch.models.losses import _ensure_weights, _signs


# --------------------------------------------------------------------------
# Host-side conversion
# --------------------------------------------------------------------------
def csr_to_padded(X, max_nnz: int | None = None, pad_multiple: int = 8,
                  dtype=np.float32):
    """Convert a scipy CSR/CSC/COO matrix (or dense array) to padded COO.

    Returns numpy ``(indices [B, k] int32, values [B, k] dtype)`` with
    ``k = ceil(max-row-nnz / pad_multiple) * pad_multiple`` (or the given
    ``max_nnz``).  Rows with more than ``max_nnz`` entries keep their
    ``max_nnz`` largest-magnitude entries.  Padding slots are
    ``(index 0, value 0)``.
    """
    if not issparse(X):
        X = np.asarray(X)
        nz = [np.nonzero(row)[0] for row in X]
        rows = [(idx.astype(np.int64), X[i, idx]) for i, idx in enumerate(nz)]
    else:
        X = X.tocsr()
        rows = [(X.indices[s:e].astype(np.int64), X.data[s:e])
                for s, e in zip(X.indptr[:-1], X.indptr[1:])]

    row_nnz = max((len(i) for i, _ in rows), default=0)
    if max_nnz is None:
        k = max(pad_multiple,
                ((row_nnz + pad_multiple - 1) // pad_multiple) * pad_multiple)
    else:
        k = int(max_nnz)
        if k <= 0:
            raise ValueError("'max_nnz' must be positive")

    B = len(rows)
    indices = np.zeros((B, k), np.int32)
    values = np.zeros((B, k), dtype)
    for r, (idx, val) in enumerate(rows):
        if len(idx) > k:
            keep = np.argsort(-np.abs(val))[:k]
            idx, val = idx[keep], val[keep]
        indices[r, :len(idx)] = idx
        values[r, :len(val)] = val
    return indices, values


# --------------------------------------------------------------------------
# Binary logistic regression (CTR shape)
# --------------------------------------------------------------------------
def _bin_split(w, n_features):
    if w.shape[0] == n_features + 1:
        return w[:n_features], w[n_features], True
    return w, torch.zeros((), dtype=w.dtype, device=w.device), False


def _gather(table, idx):
    """``table[idx]`` for ``[B, k]`` indices: rows of ``table``."""
    rows = table.index_select(0, idx.long().reshape(-1))
    return rows.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def _bin_margins(w, idx, val, n_features):
    coef, b, _ = _bin_split(w, n_features)
    return torch.sum(_gather(coef, idx) * val, dim=-1) + b    # [B]


def _bin_scatter_grad(t, idx, val, n_features):
    """``X^T t`` for padded-COO ``X``: scatter-add of ``val * t`` rows."""
    upd = val * t[:, None]                                    # [B, k]
    return torch.zeros(n_features, dtype=t.dtype, device=t.device).index_add(
        0, idx.long().reshape(-1), upd.reshape(-1))


def sparse_binary_logistic_loss(w, idx, val, y, n_features,
                                sample_weight=None, reg_param=0.0):
    """Equals ``losses.binary_logistic_loss(w, X_dense, y, ...)`` for the
    padded-COO form of ``X``."""
    y = _signs(y, w)
    sw = _ensure_weights(sample_weight, idx.shape[0], w.dtype, w.device)
    z = _bin_margins(w, idx, val, n_features) * y
    loss = torch.sum(sw * torch.logaddexp(torch.zeros_like(z), -z))
    coef, _, _ = _bin_split(w, n_features)
    return loss + 0.5 * reg_param * torch.dot(coef, coef)


def sparse_binary_logistic_grad(w, idx, val, y, n_features,
                                sample_weight=None, reg_param=0.0):
    y = _signs(y, w)
    sw = _ensure_weights(sample_weight, idx.shape[0], w.dtype, w.device)
    z = _bin_margins(w, idx, val, n_features)
    t = sw * (torch.sigmoid(y * z) - 1.0) * y                 # [B]
    coef, _, has_b = _bin_split(w, n_features)
    g_coef = _bin_scatter_grad(t, idx, val, n_features) + reg_param * coef
    if has_b:
        return torch.cat([g_coef, torch.sum(t)[None]])
    return g_coef


def sparse_binary_logistic_hessvec(w, v, idx, val, y, n_features,
                                   sample_weight=None, reg_param=0.0):
    sw = _ensure_weights(sample_weight, idx.shape[0], w.dtype, w.device)
    sig = torch.sigmoid(_bin_margins(w, idx, val, n_features))
    dd = sw * sig * (1.0 - sig)                               # [B]
    v_coef, v_b, _ = _bin_split(v, n_features)
    xv = torch.sum(_gather(v_coef, idx) * val, dim=-1) + v_b
    t = dd * xv
    _, _, has_b = _bin_split(w, n_features)
    h_coef = _bin_scatter_grad(t, idx, val, n_features) + reg_param * v_coef
    if has_b:
        return torch.cat([h_coef, torch.sum(t)[None]])
    return h_coef


def sparse_binary_logistic_predict_proba(w, idx, val, n_features):
    return torch.sigmoid(_bin_margins(w, idx, val, n_features))


# --------------------------------------------------------------------------
# Multinomial logistic regression
# --------------------------------------------------------------------------
def _mult_split(w, n_features, n_classes):
    w = w.reshape(n_classes, -1)
    if w.shape[1] == n_features + 1:
        return w[:, :n_features], w[:, n_features], True
    return w, torch.zeros(n_classes, dtype=w.dtype, device=w.device), False


def _mult_logits(w, idx, val, n_features, n_classes):
    coef, b, _ = _mult_split(w, n_features, n_classes)
    rows = _gather(coef.T, idx)                               # [B, k, C]
    return torch.einsum("bk,bkc->bc", val, rows) + b[None, :]


def _mult_scatter_grad(diff, idx, val, n_features):
    """``X^T diff``: scatter-add of per-slot outer products into
    ``[n_features, n_classes]``, returned transposed to ``[C, nf]``."""
    n_classes = diff.shape[1]
    upd = val[:, :, None] * diff[:, None, :]                  # [B, k, C]
    g = torch.zeros(n_features, n_classes, dtype=diff.dtype,
                    device=diff.device).index_add(
        0, idx.long().reshape(-1), upd.reshape(-1, n_classes))
    return g.T                                                # [C, nf]


def sparse_multinomial_logistic_loss(w, idx, val, Y, n_features,
                                     sample_weight=None, reg_param=0.0):
    n_classes = Y.shape[1]
    Y = torch.as_tensor(Y, device=w.device).to(w.dtype)
    sw = _ensure_weights(sample_weight, idx.shape[0], w.dtype, w.device)
    logp = torch.log_softmax(
        _mult_logits(w, idx, val, n_features, n_classes), dim=-1)
    loss = -torch.sum(sw[:, None] * Y * logp)
    coef, _, _ = _mult_split(w, n_features, n_classes)
    return loss + 0.5 * reg_param * torch.sum(coef * coef)


def sparse_multinomial_logistic_grad(w, idx, val, Y, n_features,
                                     sample_weight=None, reg_param=0.0):
    n_classes = Y.shape[1]
    Y = torch.as_tensor(Y, device=w.device).to(w.dtype)
    sw = _ensure_weights(sample_weight, idx.shape[0], w.dtype, w.device)
    p = torch.softmax(_mult_logits(w, idx, val, n_features, n_classes),
                      dim=-1)
    diff = sw[:, None] * (p - Y)                              # [B, C]
    coef, _, has_b = _mult_split(w, n_features, n_classes)
    g_coef = _mult_scatter_grad(diff, idx, val, n_features) \
        + reg_param * coef
    if has_b:
        g_b = torch.sum(diff, dim=0)
        return torch.cat([g_coef, g_b[:, None]], dim=1).reshape(-1)
    return g_coef.reshape(-1)


def sparse_multinomial_logistic_hessvec(w, v, idx, val, Y, n_features,
                                        sample_weight=None, reg_param=0.0):
    n_classes = Y.shape[1]
    sw = _ensure_weights(sample_weight, idx.shape[0], w.dtype, w.device)
    p = torch.softmax(_mult_logits(w, idx, val, n_features, n_classes),
                      dim=-1)                                 # [B, C]
    v_coef, _, _ = _mult_split(v, n_features, n_classes)
    zv = _mult_logits(v, idx, val, n_features, n_classes)
    inner = torch.sum(p * zv, dim=1, keepdim=True)
    r = sw[:, None] * p * (zv - inner)                        # [B, C]
    _, _, has_b = _mult_split(w, n_features, n_classes)
    h_coef = _mult_scatter_grad(r, idx, val, n_features) \
        + reg_param * v_coef
    if has_b:
        h_b = torch.sum(r, dim=0)
        return torch.cat([h_coef, h_b[:, None]], dim=1).reshape(-1)
    return h_coef.reshape(-1)


def sparse_multinomial_logistic_predict_proba(w, idx, val, n_features,
                                              n_classes):
    """Per-class sigmoid scores (the reference's prediction quirk,
    ``stochqn/_logistic.py:14-20``)."""
    return torch.sigmoid(_mult_logits(w, idx, val, n_features, n_classes))
