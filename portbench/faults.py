"""Faults planted in the program, for the check's own tests and readings:
the check has to read each as not correct.

* ``unchanged``: SQN's step returns its state unchanged;
* ``half_batch``: the program's gradient leaves half of the batch out and
  takes the mean over the rest (the model's ``half_batch``);
* ``altered``: the direction kernel's answer altered where it is made,
  one entry moved by 1.

A one-chip cell has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib
import importlib

NAMES = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(module: str, name: str, value):
    mod = importlib.import_module(module)
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
                         _altered(two_loop.direction_streamed)):
            yield
    else:
        raise KeyError(f"no fault {name!r}; the faults are {NAMES}")
