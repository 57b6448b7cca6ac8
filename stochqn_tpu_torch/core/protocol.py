"""Request record returned by every ``advance`` call.

Counterpart of :mod:`stochqn_tpu.core.protocol`.  The reference's ``run_*``
functions return a task enum, an info enum and an ``iter_status`` int
through out-pointers (``include/stochqn.h:381-383``).  Here they come back
as three scalar tensors on the state's device beside the new state; the
free-mode wrapper reads them once and turns them into the reference's
request dict (``stochqn/_optimizers.py:1004-1016``).
"""
from __future__ import annotations

import dataclasses
import numbers

import torch

from stochqn_tpu_torch.core.enums import Info, Task
from stochqn_tpu_torch.utils import metrics

NO_PROBLEMS = int(Info.NO_PROBLEMS_ENCOUNTERED)


@dataclasses.dataclass
class AdvanceResult:
    task: torch.Tensor       # int32 Task code
    info: torch.Tensor       # int32 Info code
    x_changed: torch.Tensor  # bool: did x move during this call


def result(task, info, x_changed, device=None) -> AdvanceResult:
    """Codes and flag as tensors on ``device``; a tensor passed in keeps
    its device (a Python number is made there, with no copy from the
    host)."""
    def scalar(v, dtype):
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        return torch.full((), int(v), dtype=dtype, device=device)
    return AdvanceResult(task=scalar(task, torch.int32),
                         info=scalar(info, torch.int32),
                         x_changed=scalar(x_changed, torch.bool))


def select(pred: torch.Tensor, if_true, if_false):
    """Elementwise select over two states of one kind: dataclasses are
    walked field by field, tensors selected with ``torch.where`` (both
    sides computed; use for cheap paths).  Fields that are not tensors
    (a memory's static append mode) must agree."""
    if isinstance(if_true, torch.Tensor):
        return torch.where(pred, if_true, if_false)
    if dataclasses.is_dataclass(if_true):
        return type(if_true)(**{
            f.name: select(pred, getattr(if_true, f.name),
                           getattr(if_false, f.name))
            for f in dataclasses.fields(if_true)})
    if if_true != if_false:
        raise ValueError(f"select: static fields differ: {if_true!r} and "
                         f"{if_false!r}")
    return if_true


def host_ints(*scalars: torch.Tensor) -> list:
    """The integer scalars as Python ints, in one read of the device
    (:func:`~stochqn_tpu_torch.utils.metrics.host_read`)."""
    with metrics.host_read():
        return torch.stack(scalars).tolist()


def scalar_like(value, x: torch.Tensor) -> torch.Tensor:
    """``value`` (a step size, a function value) as a tensor of ``x``'s
    dtype on ``x``'s device.  A Python number is filled on the device:
    copying it from the host would wait for the device."""
    if isinstance(value, numbers.Real):
        return torch.full((), float(value), dtype=x.dtype, device=x.device)
    return torch.as_tensor(value, dtype=x.dtype, device=x.device)


def cast_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` where torch would not round it: a
    Python number meeting a bfloat16 tensor is taken at float32 precision
    by torch, while the JAX package rounds it to bfloat16 first (weak
    typing).  float32 and float64 round alike in both, so ``value`` comes
    back as it is for them."""
    if dtype == torch.bfloat16:
        return float(torch.tensor(value, dtype=dtype))
    return value


def resolve_device(device, what: str = "free mode") -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card, and
    raises where there is none (``what`` names the caller in the message).
    ``device="cpu"`` is how a caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on an NVIDIA GPU by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def check_iterate_dtype(x0: torch.Tensor, what: str) -> None:
    """The iterate of every state is float32, float64 or bfloat16, as in
    the JAX package.  A bfloat16 iterate keeps ``x``, the pair rows and
    every other ``[n]`` field in bfloat16; the memories' small math (Gram,
    ``rho``, the caches, ``gamma``) stays float32."""
    if x0.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise NotImplementedError(
            f"{what} state is float32, float64 or bfloat16, got "
            f"{x0.dtype}")


def no_bad(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=x.device)


def step_info(bad: torch.Tensor) -> torch.Tensor:
    """The info code of a step whose direction was ``bad`` or not."""
    return torch.where(bad, int(Info.SEARCH_DIRECTION_WAS_NAN),
                       NO_PROBLEMS).to(torch.int32)


def commit_info(accepted: torch.Tensor, info=NO_PROBLEMS) -> torch.Tensor:
    """``info`` where the pair was accepted, else ``curvature_too_small``."""
    return torch.where(accepted, info,
                       int(Info.CURVATURE_TOO_SMALL)).to(torch.int32)


def goto(state, section: int, task: Task, info, x_changed):
    """``state`` at ``section`` with the request for ``task``."""
    return (state.replace(section=torch.full_like(state.section, section)),
            result(task, info, x_changed, state.x.device))


def resume(state, info, x_changed):
    """``resume_main_loop`` (``src/stochqn.c:1148-1152``)."""
    return goto(state, 1, Task.CALC_GRAD, info, x_changed)
