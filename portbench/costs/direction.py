"""The least work of the collapsed SQN direction ``d = gamma g + W^T (C (W
g))``, ``W = [S; Y]`` of ``[2m, n]``, whatever kernel computes it: ``W``
read once, ``g`` read, ``d`` written, ``C [2m, 2m]`` and ``gamma`` read;
``W g``, ``C u``, ``W^T u`` and the ``gamma g`` term as multiply-adds."""
from __future__ import annotations


def cost(m: int, n: int, pair_bytes: int = 4) -> tuple:
    """``(flops, bytes)`` of one direction over ``m`` pairs of size ``n``."""
    r = 2 * m
    flops = 2 * r * n + 2 * r * r + 2 * r * n + 2 * n
    nbytes = pair_bytes * r * n + 4 * (2 * n + r * r + 1)
    return flops, nbytes
