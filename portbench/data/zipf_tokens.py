"""Token sequences for a language model's next-token loss, and its
starting weights, drawn on the device from the run's seed.

Each of ``num_batches`` minibatches holds ``batch_size`` sequences of
``seq_len + 1`` ids, each id drawn independently from a Zipf law of
exponent ``zipf_exponent`` over the ``vocab_size`` ids (rank ``r`` with
probability proportional to ``(r + 1)^-s``, the id the rank), by inverse
transform on the device; the model reads the first ``seq_len`` and is
scored on the last ``seq_len``.  The weights ``x0`` follow the reference's
flat layout (``reference/<model>.py``'s ``layout``): normal with standard
deviation ``init_std``, the RMSNorm weights (paths ending in ``norm``)
one.

``make(cfg, seed, device)`` returns ``ids`` and ``targets`` ``[num_batches,
batch_size, seq_len]`` int64 and ``x0 [n]`` float32.
"""
from __future__ import annotations

import importlib
import math

import torch


def make(cfg: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    B, bs, T, V = cfg["num_batches"], cfg["batch_size"], cfg["seq_len"], \
        cfg["vocab_size"]
    weights = torch.arange(1, V + 1, dtype=torch.float64, device=device) \
        .pow(-cfg["zipf_exponent"])
    cdf = torch.cumsum(weights / weights.sum(), 0)
    u = torch.rand((B, bs, T + 1), generator=g, device=device,
                   dtype=torch.float64)
    tokens = torch.searchsorted(cdf, u).clamp(max=V - 1)
    ref = importlib.import_module(f"portbench.reference.{cfg['model']}")
    x0 = torch.randn(ref.size(cfg), generator=g, device=device) \
        * cfg["init_std"]
    at = 0
    for path, shape in ref.layout(cfg):
        n = math.prod(shape)
        if path.endswith("norm"):
            x0[at:at + n] = 1.0
        at += n
    return {"ids": tokens[..., :-1].contiguous(),
            "targets": tokens[..., 1:].contiguous(), "x0": x0}
