"""Static hyperparameter records for the three optimizers
(:mod:`stochqn_tpu.core.config`).

Defaults and validation match the JAX package, which follows the reference
Python free-mode constructor (``stochqn/_optimizers.py:1091-1092``) and its
``None -> 0`` sentinel normalization (``stochqn/_optimizers.py:883-908``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _check_coupling(value: str) -> str:
    if value not in ("matvec", "gram"):
        raise ValueError(f"'coupling' must be 'matvec' or 'gram', "
                         f"got {value!r}")
    return value


def _norm(value: Optional[float], name: str, positive: bool = True) -> float:
    """Reference semantics: ``None`` means "feature off" and maps to 0."""
    if value is None:
        return 0.0
    value = float(value)
    if positive and value <= 0:
        raise ValueError(f"'{name}' must be positive or None, got {value!r}")
    return value


@dataclasses.dataclass(frozen=True)
class OLBFGSConfig:
    """oLBFGS hyperparameters (Schraudolph et al., 2007).

    Reference: ``initialize_oLBFGS`` at ``src/stochqn.c:464-481`` and the
    Python wrapper ``oLBFGS_free`` at ``stochqn/_optimizers.py:929-973``.

    ``pairs_interleaved`` stores the pair memory as one ``[2m, n]`` buffer
    with rows ``[s_0, y_0, s_1, y_1, ...]``
    (:class:`~stochqn_tpu_torch.core.state.BFGSMemoryInterleaved`); it
    takes the same steps as the block layout to float tolerance.
    ``pairs_bf16`` stores the pair rows in bfloat16 (the math stays in
    the iterate's dtype): half the bytes every direction reads.
    """

    mem_size: int = 10
    hess_init: float = 0.0       # 0 -> gamma = s.y/y.y of the latest pair
    min_curvature: float = 1e-4  # 0 -> accept every pair
    y_reg: float = 0.0           # y += y_reg * s
    check_nan: bool = True
    pairs_bf16: bool = False
    pairs_interleaved: bool = False

    # oLBFGS produces one correction pair per iteration.
    upd_freq: int = 1

    @classmethod
    def create(cls, mem_size=10, hess_init=None, min_curvature=1e-4,
               y_reg=None, check_nan=True, pairs_bf16=False,
               pairs_interleaved=False) -> "OLBFGSConfig":
        if mem_size <= 0:
            raise ValueError("'mem_size' must be a positive integer")
        return cls(
            mem_size=int(mem_size),
            hess_init=_norm(hess_init, "hess_init"),
            min_curvature=_norm(min_curvature, "min_curvature"),
            y_reg=_norm(y_reg, "y_reg"),
            check_nan=bool(check_nan),
            pairs_bf16=bool(pairs_bf16),
            pairs_interleaved=bool(pairs_interleaved),
        )


@dataclasses.dataclass(frozen=True)
class SQNConfig:
    """SQN hyperparameters (Byrd et al., 2016).

    Reference: ``initialize_SQN`` at ``src/stochqn.c:483-506`` and
    ``SQN_free`` at ``stochqn/_optimizers.py:1048-1097``.

    ``pairs_interleaved`` and ``pairs_bf16``: see :class:`OLBFGSConfig`.
    With bfloat16 pairs the collapsed direction runs on the streamed
    direction kernel.
    """

    mem_size: int = 10
    upd_freq: int = 20           # "bfgs_upd_freq" L: pair every L iterations
    min_curvature: float = 1e-4
    y_reg: float = 0.0
    use_grad_diff: bool = False  # False -> Hessian-vector products
    check_nan: bool = True
    pairs_bf16: bool = False
    pairs_interleaved: bool = False

    @classmethod
    def create(cls, mem_size=10, bfgs_upd_freq=20, min_curvature=1e-4,
               y_reg=None, use_grad_diff=False, check_nan=True,
               pairs_bf16=False, pairs_interleaved=False) -> "SQNConfig":
        if mem_size <= 0 or bfgs_upd_freq <= 0:
            raise ValueError("'mem_size' and 'bfgs_upd_freq' must be positive")
        return cls(
            mem_size=int(mem_size),
            upd_freq=int(bfgs_upd_freq),
            min_curvature=_norm(min_curvature, "min_curvature"),
            y_reg=_norm(y_reg, "y_reg"),
            use_grad_diff=bool(use_grad_diff),
            check_nan=bool(check_nan),
            pairs_bf16=bool(pairs_bf16),
            pairs_interleaved=bool(pairs_interleaved),
        )


@dataclasses.dataclass(frozen=True)
class AdaQNConfig:
    """adaQN hyperparameters (Keskar & Berahas, 2016).

    Reference: ``initialize_adaQN`` at ``src/stochqn.c:508-547`` and
    ``adaQN_free`` at ``stochqn/_optimizers.py:1192-1277``.

    ``h0_exact_reference``: the reference's ``diag_rescal`` writes the
    *rescaled gradient* ``g / sqrt(acc + scal_reg)`` into the diagonal-H0
    buffer used by the two-loop recursion (``src/stochqn.c:762-782,818``),
    rather than the RMSProp/AdaGrad diagonal ``1 / sqrt(acc + scal_reg)``
    described in the adaQN paper.  ``True`` (the default) reproduces the
    reference exactly; ``False`` uses the paper's diagonal.

    ``use_pallas`` keeps the JAX package's name, so that one set of
    keyword arguments builds both packages' configs.  Here it means "use
    the hand-written projection kernel" (``csrc/project_adaqn.cu``) for
    the per-step diagonal-H0 two-loop, which then takes the ``gram``
    coupling's ``(Y*D) g`` / ``(Y*D) Y^T`` from the kernel.  ``None`` (the
    default) and ``False`` take the plain torch ``coupling`` route.

    ``pairs_bf16`` and ``fisher_bf16`` store the pair rows or the Fisher
    rows in bfloat16 (the math stays in the iterate's dtype).  The
    projection kernel takes float32 pairs only, so ``pairs_bf16`` takes
    the plain ``coupling`` route whatever ``use_pallas`` says, as in the
    JAX package; ``fisher_bf16`` alone keeps the kernel.
    """

    mem_size: int = 10
    fisher_size: int = 100
    upd_freq: int = 20
    max_incr: float = 1.01       # 0 -> no function-value guard
    min_curvature: float = 1e-4
    scal_reg: float = 1e-4
    rmsprop_weight: float = 0.0  # 0 -> AdaGrad accumulator
    y_reg: float = 0.0
    use_grad_diff: bool = False  # False -> empirical Fisher for y
    check_nan: bool = True
    h0_exact_reference: bool = True
    pairs_bf16: bool = False
    fisher_bf16: bool = False
    use_pallas: Optional[bool] = None
    coupling: str = "matvec"     # diagonal-H0 coupling: "matvec" or "gram"

    @classmethod
    def create(cls, mem_size=10, fisher_size=100, bfgs_upd_freq=20,
               max_incr=1.01, min_curvature=1e-4, scal_reg=1e-4,
               rmsprop_weight=None, y_reg=None, use_grad_diff=False,
               check_nan=True, h0_exact_reference=True,
               pairs_bf16=False, fisher_bf16=False,
               use_pallas=None, coupling="matvec") -> "AdaQNConfig":
        if mem_size <= 0 or bfgs_upd_freq <= 0:
            raise ValueError("'mem_size' and 'bfgs_upd_freq' must be positive")
        # Reference: fisher_size=None forces use_grad_diff
        # (stochqn/_optimizers.py:773-774,1255-1259).
        if fisher_size is None:
            use_grad_diff = True
            fisher_size = 0
        elif not use_grad_diff and fisher_size <= 0:
            raise ValueError("'fisher_size' must be positive (or None)")
        if use_grad_diff:
            fisher_size = 0
        rw = 0.0 if rmsprop_weight is None else float(rmsprop_weight)
        if rmsprop_weight is not None and not (0.0 < rw < 1.0):
            raise ValueError("'rmsprop_weight' must be in (0, 1) or None")
        scal_reg = float(scal_reg)
        if scal_reg <= 0:
            raise ValueError("'scal_reg' must be positive")
        return cls(
            mem_size=int(mem_size),
            fisher_size=int(fisher_size),
            upd_freq=int(bfgs_upd_freq),
            max_incr=_norm(max_incr, "max_incr"),
            min_curvature=_norm(min_curvature, "min_curvature"),
            scal_reg=scal_reg,
            rmsprop_weight=rw,
            y_reg=_norm(y_reg, "y_reg"),
            use_grad_diff=bool(use_grad_diff),
            check_nan=bool(check_nan),
            h0_exact_reference=bool(h0_exact_reference),
            pairs_bf16=bool(pairs_bf16),
            fisher_bf16=bool(fisher_bf16),
            use_pallas=None if use_pallas is None else bool(use_pallas),
            coupling=_check_coupling(coupling),
        )
