"""The least work of one fused SQN iteration of the sparse binary model
on padded-COO rows, with its share of the boundary, counted as
``costs/multinomial_logistic.py`` counts it (each input read once, each
output written once; the gradient and the direction stay on the chip).

Every iteration, on ``b`` rows of ``k`` slots over ``n`` weights: the
gradient (the slots' ids (8 bytes) and values and the labels read, the
weights they name gathered from ``x``, which is read once, the margins
and the scatter of ``b k`` products: ``4 b k`` flops, ``reg x`` added: ``2 n``), the direction
(``costs/direction.py``), the guard's norm, ``x -= eta d`` and ``x_sum +=
x``: ``x`` read and written, ``x_sum`` read and written.  Every ``L``
iterations, on the round's ``L b`` rows: the Hessian-vector product (two
gathers and a scatter, ``8 L b k`` flops, ``reg v``), ``x_avg`` and ``s``,
the pair written, the commit's Gram columns (``W`` read, ``8 m n``
flops) and ``x_sum`` reset.
"""
from __future__ import annotations

from portbench.costs.direction import cost as direction


def size(cfg: dict) -> int:
    """The number of weights."""
    return cfg["n_features"]


def step(cfg: dict) -> tuple:
    """``(flops, bytes)`` per iteration, the boundary's share included."""
    b, k, n = cfg["batch_size"], cfg["pad_to"], cfg["n_features"]
    m, L = cfg["mem_size"], cfg["bfgs_upd_freq"]
    d_flops, d_bytes = direction(m, n)
    rows_bytes = lambda r: r * k * (8 + 4) + 4 * r    # noqa: E731
    # the gradient, its penalty, the direction, the guard, x and x_sum
    flops = 4 * b * k + 2 * n + d_flops + 2 * n + 2 * n + n
    nbytes = rows_bytes(b) + 4 * n + (d_bytes - 8 * n) + 4 * n + 8 * n
    rows = L * b
    # the product and its penalty, x_avg and s, the curvature, the Gram
    b_flops = 8 * rows * k + 2 * n + 2 * n + 4 * n + 8 * m * n
    b_bytes = rows_bytes(rows) + 8 * n + 4 * n + 8 * n + 8 * m * n + 4 * n
    return flops + b_flops / L, nbytes + b_bytes / L
