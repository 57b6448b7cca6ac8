"""The least work of one fused SQN iteration of DeepSeek-V2-Lite's share
(``reference/deepseek_v2_lite.py``), with its share of the boundary.

Flops: a gradient is three forward passes' products over the batch's
tokens (the forward, and the backward's two products per weight), a
forward pass per token, with ``T`` the sequence length:

* MLA: ``q``, ``kv_a``, ``kv_b`` and ``o``, and the scores and their
  values counted causally, at half of ``T``: ``nh T (dn + dr + dv)``;
* the dense layer's SwiGLU (``6 H I``), each MoE layer's router (``2 H
  E``), shared experts (``6 H w n_shared``) and held experts at their
  expected load, ``k held / E`` assignments a token under uniform routing
  (``6 H w`` each);
* the head (``2 H V``).

The Hessian-vector product is counted as twice a gradient: the round's
``L`` of them, one a minibatch, add two gradients an iteration.  The
optimizer's own work is counted as ``costs/multinomial_logistic.py``
counts it: the direction over bfloat16 pairs (``costs/direction.py``),
the guard, ``x`` and ``x_sum``, and at the boundary ``x_avg``, ``s``, the
curvature and the Gram columns.  Bytes: each weight read three times and
its gradient written once a gradient, twice that a Hessian-vector
product, and the optimizer's vectors and pairs; the activations, which
need not leave the chip, are not counted.
"""
from __future__ import annotations

from portbench.costs.direction import cost as direction
from portbench.reference.deepseek_v2_lite import size  # noqa: F401


def forward_per_token(cfg: dict) -> float:
    """Flops of one token's forward pass."""
    H, nh, T = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["seq_len"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    r, V = cfg["kv_lora_rank"], cfg["vocab_size"]
    E, held, k = cfg["router_experts"], cfg["n_routed_experts"], \
        cfg["num_experts_per_tok"]
    w = cfg["moe_intermediate_size"]
    mla = 2 * H * nh * (dn + dr) + 2 * H * (r + dr) \
        + 2 * r * nh * (dn + dv) + 2 * nh * dv * H \
        + nh * T * (dn + dr + dv)
    dense = cfg["first_k_dense_replace"]
    moe = 2 * H * E + 6 * H * w * cfg["n_shared_experts"] \
        + k * held / E * 6 * H * w
    layers = cfg["num_hidden_layers"]
    return layers * mla + dense * 6 * H * cfg["intermediate_size"] \
        + (layers - dense) * moe + 2 * H * V


def step(cfg: dict) -> tuple:
    """``(flops, bytes)`` per iteration, the boundary's share included."""
    n = size(cfg)
    m, L = cfg["mem_size"], cfg["bfgs_upd_freq"]
    tokens = cfg["batch_size"] * cfg["seq_len"]
    grad_flops = 3 * forward_per_token(cfg) * tokens
    grad_bytes = 4 * (3 * n + n) + 8 * tokens
    d_flops, d_bytes = direction(m, n, pair_bytes=2)
    # the gradient, the direction, the guard, x and x_sum
    flops = grad_flops + d_flops + 2 * n + 2 * n + n
    nbytes = grad_bytes + (d_bytes - 8 * n) + 4 * n + 8 * n
    # the boundary: L products over L minibatches, x_avg and s, the
    # curvature and the Gram columns, the pair written
    b_flops = L * 2 * grad_flops + 2 * n + 4 * n + 8 * m * n
    b_bytes = L * 2 * grad_bytes + 8 * n + 4 * n + 8 * n + 2 * m * n \
        + 2 * 2 * n
    return flops + b_flops / L, nbytes + b_bytes / L
