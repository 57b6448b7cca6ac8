"""Dense rows with standard normal features and uniform labels: the
BibTeX-shaped traffic of the repository's earlier benchmark, drawn on the
device from the run's seed in a few large calls.

``make(cfg, seed, device)`` returns ``X [num_batches, batch_size,
n_features]`` float32, one-hot ``Y [num_batches, batch_size, n_classes]``
float32 and the start ``x0 [n_classes * (n_features + 1)]`` float32, all
standard normal but ``Y``.
"""
from __future__ import annotations

import torch


def make(cfg: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    B, bs = cfg["num_batches"], cfg["batch_size"]
    F, K = cfg["n_features"], cfg["n_classes"]
    X = torch.randn((B, bs, F), generator=g, device=device)
    labels = torch.randint(0, K, (B, bs), generator=g, device=device)
    Y = torch.nn.functional.one_hot(labels, K).to(torch.float32)
    x0 = torch.randn(K * (F + 1), generator=g, device=device)
    return {"X": X, "Y": Y, "x0": x0}
