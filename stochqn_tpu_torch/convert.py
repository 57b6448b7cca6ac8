"""Move SQN and adaQN state between the JAX package and this one, as
numpy arrays.

``sqn_state_from_numpy`` takes a JAX ``SQNState`` pulled out field by
field (``mem`` as a nested dict) and builds this package's
:class:`~stochqn_tpu_torch.core.state.SQNState`; ``sqn_state_to_numpy``
goes back.  ``adaqn_state_{from,to}_numpy`` do the same for
``AdaQNState`` (``mem`` and ``fisher`` nested), and carry the Fisher
ring's static append mode ``shift`` as a bool.  Both sides then compute
the same thing from the same state.

The JAX package keeps ``head``/``count``/``perm``/``niter``/``section`` in
``int32``; here they are ``int64`` (torch indexes with ``int64``), and the
conversion casts both ways.  Every tensor is a fresh copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stochqn_tpu_torch.core.state import (AdaQNState, BFGSMemory,
                                          FisherMemory, SQNState)

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


def fisher_memory_from_numpy(d: dict, device=None) -> FisherMemory:
    return FisherMemory(f=_tensor("f", d["f"], device),
                        head=_tensor("head", d["head"], device),
                        count=_tensor("count", d["count"], device),
                        shift=bool(d["shift"]))


def fisher_memory_to_numpy(fisher: FisherMemory) -> dict:
    return {"f": _array("f", fisher.f), "head": _array("head", fisher.head),
            "count": _array("count", fisher.count),
            "shift": bool(fisher.shift)}


def adaqn_state_from_numpy(d: dict, device=None) -> AdaQNState:
    """``d``: the JAX state's fields as numpy arrays, ``d["mem"]`` and
    ``d["fisher"]`` dicts of the memories' fields."""
    fields = {f.name: _tensor(f.name, d[f.name], device)
              for f in dataclasses.fields(AdaQNState)
              if f.name not in ("mem", "fisher")}
    return AdaQNState(mem=bfgs_memory_from_numpy(d["mem"], device),
                      fisher=fisher_memory_from_numpy(d["fisher"], device),
                      **fields)


def adaqn_state_to_numpy(state: AdaQNState) -> dict:
    out = {f.name: _array(f.name, getattr(state, f.name))
           for f in dataclasses.fields(AdaQNState)
           if f.name not in ("mem", "fisher")}
    out["mem"] = bfgs_memory_to_numpy(state.mem)
    out["fisher"] = fisher_memory_to_numpy(state.fisher)
    return out
