"""Faults planted in the program, for the check's own tests and readings:
the check has to read each as not correct.

* ``unchanged``: SQN's step returns its state unchanged;
* ``half_batch``: the program's gradient leaves half of the batch out and
  takes the mean over the rest (the model's ``half_batch``);
* ``altered``: the direction's answer altered where it is made, one
  entry moved by 1: the direction kernel's on one card, on a mesh's
  split route each rank's part of it (``ops.two_loop._collapsed``);
* ``no_param_sum``: the exchange between cards left out:
  ``MeshComm.sum_param`` returns the rank's own parts unsummed, so the
  two-loop, the guard and the commit see only this rank's slice of each
  product over the weights.

:data:`NAMES` are the faults every cell can have; :data:`ACROSS` those
only a cell on several cards can have (on one card ``sum_param`` sums
nothing).
"""
from __future__ import annotations

import contextlib
import importlib

NAMES = ("unchanged", "half_batch", "altered")
ACROSS = ("no_param_sum",)
ALL = NAMES + ACROSS


@contextlib.contextmanager
def _patched(module, name: str, value):
    """``module`` (a name, or any object) with ``name`` set to ``value``
    while the block runs."""
    mod = importlib.import_module(module) if isinstance(module, str) \
        else module
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)


def _altered(fn):
    def direction(*args):
        d = fn(*args).clone()
        d[0] += 1.0
        return d
    return direction


def _altered_split(fn, sharded):
    def collapsed(grad, mem, gamma, interleaved, comm=None):
        d = fn(grad, mem, gamma, interleaved, comm)
        if sharded(comm):
            d = d.clone()
            d[0] += 1.0
        return d
    return collapsed


@contextlib.contextmanager
def plant(name: str, model):
    """The fault ``name`` in the program while the block runs; ``model``
    is the cell's ``models/<model>.py``."""
    if name == "unchanged":
        from stochqn_tpu_torch.core.protocol import no_bad
        with _patched("stochqn_tpu_torch.core.sqn", "step",
                      lambda cfg, state, grad, eta, comm=None:
                      (state, no_bad(state.x))):
            yield
    elif name == "half_batch":
        module, attr = model.GRAD
        fn = getattr(importlib.import_module(module), attr)
        with _patched(module, attr, model.half_batch(fn)):
            yield
    elif name == "altered":
        from stochqn_tpu_torch.ops import two_loop
        with _patched(two_loop.__name__, "direction",
                      _altered(two_loop.direction)), \
                _patched(two_loop.__name__, "direction_streamed",
                         _altered(two_loop.direction_streamed)), \
                _patched(two_loop.__name__, "_collapsed",
                         _altered_split(two_loop._collapsed,
                                        two_loop._sharded)):
            yield
    elif name == "no_param_sum":
        from stochqn_tpu_torch.parallel.mesh import MeshComm
        with _patched(MeshComm, "sum_param",
                      lambda self, parts, label: tuple(parts)):
            yield
    else:
        raise KeyError(f"no fault {name!r}; the faults are {ALL}")
