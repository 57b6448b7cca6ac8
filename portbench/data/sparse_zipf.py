"""Sparse click-through rows in padded COO, drawn on the device from the
run's seed: each row has one entry per field, ``numeric_fields`` with
the value ``log(1 + c)`` of a count ``c`` and ``categorical_fields`` with
the value 1, every field's id a bucket of ``n_features`` hashed as the
Criteo sets hash them.  A field's bucket rank follows a Zipf law of
exponent 1 (drawn as ``floor(exp(u ln V)) - 1`` for ``V`` buckets, ``u``
uniform), and an odd multiplier and a per-field offset scatter the ranks
over the buckets, so that every field has its own head of popular ids.
Each row is padded with ``(id 0, value 0)`` slots to ``pad_to`` entries.
Labels are ``+1`` with probability ``positive_rate``, else ``-1``.

``make(cfg, seed, device)`` returns ``idx [num_batches, batch_size,
pad_to]`` int64, ``val`` float32 of the same shape, ``y [num_batches,
batch_size]`` float32 and ``x0 [n_features]``, zeros (a click model's
start).
"""
from __future__ import annotations

import math

import torch

_SCATTER = 2654435761        # odd and prime to 2 and 5: a bijection mod 10^k


def make(cfg: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    B, bs, V = cfg["num_batches"], cfg["batch_size"], cfg["n_features"]
    nnum, ncat = cfg["numeric_fields"], cfg["categorical_fields"]
    fields, k = nnum + ncat, cfg["pad_to"]
    u = torch.rand((B, bs, fields), generator=g, device=device,
                   dtype=torch.float64)
    rank = torch.clamp(torch.floor(torch.exp(u * math.log(V))) - 1, 0, V - 1)
    offset = torch.arange(fields, device=device, dtype=torch.int64) * 1000003
    ids = (rank.to(torch.int64) * _SCATTER + offset) % V
    counts = torch.floor(torch.exp(torch.rand(
        (B, bs, nnum), generator=g, device=device) * math.log(1000.0)))
    val = torch.cat([torch.log1p(counts), torch.ones(
        (B, bs, ncat), device=device)], dim=2)
    pad = k - fields
    idx = torch.cat([ids, torch.zeros((B, bs, pad), dtype=torch.int64,
                                      device=device)], dim=2)
    val = torch.cat([val, torch.zeros((B, bs, pad), device=device)], dim=2)
    pos = torch.rand((B, bs), generator=g, device=device) \
        < cfg["positive_rate"]
    y = torch.where(pos, 1.0, -1.0).to(torch.float32)
    return {"idx": idx, "val": val, "y": y,
            "x0": torch.zeros(V, device=device)}
