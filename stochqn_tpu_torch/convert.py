"""Move optimizer state between the JAX package and this one, as numpy
arrays.

``sqn_state_from_numpy`` takes a JAX ``SQNState`` pulled out field by
field (``mem`` as a nested dict) and builds this package's
:class:`~stochqn_tpu_torch.core.state.SQNState`; ``sqn_state_to_numpy``
goes back.  ``olbfgs_state_{from,to}_numpy`` do the same for
``OLBFGSState`` and ``adaqn_state_{from,to}_numpy`` for ``AdaQNState``
(``mem`` and ``fisher`` nested); ``mlp_params_{from,to}_numpy`` carry the
MLP's list of ``{"w", "b"}`` layers (``models/mlp.py``).  A ``mem`` dict with an ``sy`` entry is
an interleaved memory (``bfgs_memory_interleaved_{from,to}_numpy``); it
and the Fisher ring carry their static mode ``shift`` as a bool.  Both
sides then compute the same thing from the same state.

The JAX package keeps ``head``/``count``/``perm``/``niter``/``section`` in
``int32``; here they are ``int64`` (torch indexes with ``int64``), and the
conversion casts both ways.  Every tensor is a fresh copy.

bfloat16 rows (``pairs_bf16`` / ``fisher_bf16`` state) need no
``ml_dtypes``: a JAX bfloat16 array comes in through its bits
(``a.view(np.uint16)``), and a bfloat16 tensor goes out as its bit
pattern, a ``uint16`` array, which ``from_numpy`` reads back as bfloat16
and JAX as ``jax.lax.bitcast_convert_type(a, jnp.bfloat16)``: the round
trip is exact both ways.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stochqn_tpu_torch.core.state import (AdaQNState, BFGSMemory,
                                          BFGSMemoryInterleaved, FisherMemory,
                                          OLBFGSState, SQNState)

_INT_FIELDS = frozenset({"head", "count", "perm", "niter", "section"})


def _tensor(name, value, device):
    arr = np.array(value, copy=True)
    if name in _INT_FIELDS:
        return torch.from_numpy(arr.astype(np.int64)).to(device)
    if arr.dtype.name in ("bfloat16", "uint16"):     # bfloat16 bits
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _array(name, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    arr = t.numpy().copy()
    return arr.astype(np.int32) if name in _INT_FIELDS else arr


def bfgs_memory_from_numpy(d: dict, device=None) -> BFGSMemory:
    return BFGSMemory(**{f.name: _tensor(f.name, d[f.name], device)
                         for f in dataclasses.fields(BFGSMemory)})


def bfgs_memory_to_numpy(mem: BFGSMemory) -> dict:
    return {f.name: _array(f.name, getattr(mem, f.name))
            for f in dataclasses.fields(BFGSMemory)}


def bfgs_memory_interleaved_from_numpy(d: dict, device=None
                                       ) -> BFGSMemoryInterleaved:
    return BFGSMemoryInterleaved(
        shift=bool(d["shift"]),
        **{f.name: _tensor(f.name, d[f.name], device)
           for f in dataclasses.fields(BFGSMemoryInterleaved)
           if f.name != "shift"})


def bfgs_memory_interleaved_to_numpy(mem: BFGSMemoryInterleaved) -> dict:
    out = {f.name: _array(f.name, getattr(mem, f.name))
           for f in dataclasses.fields(BFGSMemoryInterleaved)
           if f.name != "shift"}
    out["shift"] = bool(mem.shift)
    return out


def _mem_from_numpy(d: dict, device):
    """Either layout, told apart by the interleaved buffer ``sy``."""
    return (bfgs_memory_interleaved_from_numpy(d, device) if "sy" in d
            else bfgs_memory_from_numpy(d, device))


def _mem_to_numpy(mem) -> dict:
    return (bfgs_memory_interleaved_to_numpy(mem)
            if isinstance(mem, BFGSMemoryInterleaved)
            else bfgs_memory_to_numpy(mem))


def _state_from_numpy(cls, d: dict, device):
    fields = {f.name: _tensor(f.name, d[f.name], device)
              for f in dataclasses.fields(cls) if f.name != "mem"}
    return cls(mem=_mem_from_numpy(d["mem"], device), **fields)


def _state_to_numpy(state) -> dict:
    out = {f.name: _array(f.name, getattr(state, f.name))
           for f in dataclasses.fields(state) if f.name != "mem"}
    out["mem"] = _mem_to_numpy(state.mem)
    return out


def olbfgs_state_from_numpy(d: dict, device=None) -> OLBFGSState:
    """``d``: the JAX state's fields as numpy arrays, ``d["mem"]`` a dict
    of the memory's fields (either layout)."""
    return _state_from_numpy(OLBFGSState, d, device)


def olbfgs_state_to_numpy(state: OLBFGSState) -> dict:
    return _state_to_numpy(state)


def sqn_state_from_numpy(d: dict, device=None) -> SQNState:
    """``d``: the JAX state's fields as numpy arrays, ``d["mem"]`` a dict
    of the memory's fields (either layout)."""
    return _state_from_numpy(SQNState, d, device)


def sqn_state_to_numpy(state: SQNState) -> dict:
    return _state_to_numpy(state)


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


def mlp_params_from_numpy(params, device=None) -> list:
    """The JAX package's MLP parameters (``models.mlp.init_mlp_params``'
    list of ``{"w", "b"}`` dicts, as numpy arrays) as this package's, on
    ``device``."""
    return [{k: _tensor(k, v, device) for k, v in layer.items()}
            for layer in params]


def mlp_params_to_numpy(params) -> list:
    return [{k: _array(k, v) for k, v in layer.items()} for layer in params]
