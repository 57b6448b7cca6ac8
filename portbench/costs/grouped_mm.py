"""The least work of one launch of the grouped product of a mixture of
experts (``stochqn_tpu_torch.ops.kernels.grouped_mm``): ``rows`` live rows
of width ``K`` against ``groups`` matrices ``[K, N]``, or the weight
gradient over the same rows.  Either way ``2 rows K N`` flops, the live
rows' ``K`` and ``N`` entries and the ``groups`` matrices read or written
once, float32 (``elem`` bytes); the rows of no group cost nothing."""
from __future__ import annotations


def cost(rows: float, K: int, N: int, groups: int, elem: int = 4) -> tuple:
    """``(flops, bytes)`` of one launch."""
    return 2.0 * rows * K * N, elem * (rows * (K + N) + groups * K * N)
