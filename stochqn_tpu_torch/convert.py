"""Move SQN state between the JAX package and this one, as numpy arrays.

``sqn_state_from_numpy`` takes a JAX ``SQNState`` pulled out field by
field (``mem`` as a nested dict) and builds this package's
:class:`~stochqn_tpu_torch.core.state.SQNState`; ``sqn_state_to_numpy``
goes back.  Both sides then compute the same thing from the same state:
``x``, the pair ring and its caches, ``x_sum``, ``x_avg_prev``,
``grad_prev``, ``niter``.

The JAX package keeps ``head``/``count``/``perm``/``niter``/``section`` in
``int32``; here they are ``int64`` (torch indexes with ``int64``), and the
conversion casts both ways.  Every tensor is a fresh copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stochqn_tpu_torch.core.state import BFGSMemory, SQNState

_INT_FIELDS = frozenset({"head", "count", "perm", "niter", "section"})


def _tensor(name, value, device):
    arr = np.array(value, copy=True)
    if name in _INT_FIELDS:
        return torch.from_numpy(arr.astype(np.int64)).to(device)
    return torch.from_numpy(arr).to(device)


def _array(name, t: torch.Tensor) -> np.ndarray:
    arr = t.detach().cpu().numpy().copy()
    return arr.astype(np.int32) if name in _INT_FIELDS else arr


def bfgs_memory_from_numpy(d: dict, device=None) -> BFGSMemory:
    return BFGSMemory(**{f.name: _tensor(f.name, d[f.name], device)
                         for f in dataclasses.fields(BFGSMemory)})


def bfgs_memory_to_numpy(mem: BFGSMemory) -> dict:
    return {f.name: _array(f.name, getattr(mem, f.name))
            for f in dataclasses.fields(BFGSMemory)}


def sqn_state_from_numpy(d: dict, device=None) -> SQNState:
    """``d``: the JAX state's fields as numpy arrays, ``d["mem"]`` a dict
    of the ``BFGSMemory`` fields."""
    fields = {f.name: _tensor(f.name, d[f.name], device)
              for f in dataclasses.fields(SQNState) if f.name != "mem"}
    return SQNState(mem=bfgs_memory_from_numpy(d["mem"], device), **fields)


def sqn_state_to_numpy(state: SQNState) -> dict:
    out = {f.name: _array(f.name, getattr(state, f.name))
           for f in dataclasses.fields(SQNState) if f.name != "mem"}
    out["mem"] = bfgs_memory_to_numpy(state.mem)
    return out
