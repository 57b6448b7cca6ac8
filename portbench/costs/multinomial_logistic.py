"""The least work of one fused SQN iteration of the dense multinomial
model, with its share of the boundary: what the chip has to compute, read
and write whatever the program fuses (each input read once, each output
written once; the gradient and the direction need not leave the chip).

Every iteration, on a ``[b, F]`` minibatch with ``K`` classes and ``n =
K (F + 1)`` parameters: the gradient (the logits ``X W^T`` and ``(P -
Y)^T X``, ``4 b F K`` flops, the rows and ``x`` read), the direction
(``costs/direction.py``, whose ``g`` and ``d`` stay on the chip), the
guard's norm, ``x -= eta d`` (``x`` written) and ``x_sum += x`` (read and
written).  Every ``L`` iterations, on the round's ``L b`` rows: the
closed-form Hessian-vector product (``X W^T``, ``X V^T`` and ``R^T X``,
``6 L b F K`` flops, the rows read), ``x_avg`` and ``s`` from ``x_sum``
and ``x_avg_prev`` (read; ``x_avg_prev`` written), the pair written, the
commit's curvature dots and Gram columns (``W`` read, ``8 m n`` flops)
and ``x_sum`` reset.
"""
from __future__ import annotations

from portbench.costs.direction import cost as direction


def size(cfg: dict) -> int:
    """The number of weights."""
    return cfg["n_classes"] * (cfg["n_features"] + 1)


def step(cfg: dict) -> tuple:
    """``(flops, bytes)`` per iteration, the boundary's share included."""
    b, F, K = cfg["batch_size"], cfg["n_features"], cfg["n_classes"]
    m, L = cfg["mem_size"], cfg["bfgs_upd_freq"]
    n = K * (F + 1)
    d_flops, d_bytes = direction(m, n)
    # the gradient, its penalty, the direction, the guard, x and x_sum
    flops = 4 * b * F * K + 2 * n + d_flops + 2 * n + 2 * n + n
    nbytes = 4 * b * (F + K) + 4 * n + (d_bytes - 8 * n) + 4 * n + 8 * n
    rows = L * b
    # the product and its penalty, x_avg and s, the curvature, the Gram
    b_flops = 6 * rows * F * K + 2 * n + 2 * n + 4 * n + 8 * m * n
    b_bytes = 4 * rows * (F + K) + 8 * n + 4 * n + 8 * n + 8 * m * n \
        + 4 * n
    return flops + b_flops / L, nbytes + b_bytes / L
