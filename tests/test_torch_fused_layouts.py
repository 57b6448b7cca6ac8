"""The generic per-step layout against the round-chunked one, inside the
torch port, on the CPU and on the card.

Fed an aligned epoch (``B % upd_freq == 0``, a fresh state), the generic
layout (``aligned=False``) runs the chunked layout's ops in the same order,
so every tensor of the state and every info code must be the same bits.
This file imports no JAX, so the ``cuda`` case runs on the machine with
the card (``python -m pytest --noconftest -m cuda ...``); the comparison
with the JAX package is ``test_torch_fused_generic.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from stochqn_tpu_torch import AdaQNConfig, FusedTrainer, SQNConfig
from stochqn_tpu_torch.models import losses

F, C, BS, NB, M, L, REG, ETA = 12, 5, 4, 8, 3, 4, 0.1, 0.05


def _grad(x, b):
    return losses.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _obj(x, b):
    return losses.multinomial_logistic_loss(x, b[0], b[1], None, REG)


def assert_same_bits(a, b):
    """Every tensor of two states of one kind is the same bits."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            assert_same_bits(va, vb)
        elif isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _generic_vs_chunked(dev, optimizer, sync_free):
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal((NB, BS, F)).astype(np.float32))
    Y = torch.from_numpy(np.eye(C, dtype=np.float32)[
        rng.integers(0, C, (NB, BS))])
    x0 = torch.from_numpy((0.1 * rng.standard_normal((F + 1) * C)).astype(
        np.float32))
    if optimizer == "SQN":
        trainer = FusedTrainer("SQN", SQNConfig.create(
            mem_size=M, bfgs_upd_freq=L), _grad)
    else:
        trainer = FusedTrainer("adaQN", AdaQNConfig.create(
            mem_size=M, fisher_size=6, bfgs_upd_freq=L, use_pallas=True),
            _grad, obj_fn=_obj)
    data = (X.to(dev), Y.to(dev))
    runs = {}
    for aligned in (True, False):
        state = trainer.init(x0.to(dev))
        if aligned and sync_free:
            torch.cuda.set_sync_debug_mode("error")
        try:
            runs[aligned] = trainer.epochs(state, data, ETA, nepochs=2,
                                           aligned=aligned)
        finally:
            if sync_free:
                torch.cuda.set_sync_debug_mode(0)
    (sc, ic), (sg, ig) = runs[True], runs[False]
    assert torch.equal(ic, ig)
    assert_same_bits(sc, sg)
    assert int(sg.niter) == 2 * NB


@pytest.mark.parametrize("optimizer", ["SQN", "adaQN"])
def test_generic_equals_chunked_on_cpu(optimizer):
    """The plain versions of the kernels: the same bits."""
    _generic_vs_chunked(torch.device("cpu"), optimizer, False)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["SQN", "adaQN"])
def test_generic_equals_chunked_on_cuda(optimizer):
    """On the card (SQN's direction kernel, adaQN's projection kernel):
    the same bits; the chunked run, asserted aligned, reads nothing on the
    host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels; runs on the card "
                    "only)")
    _generic_vs_chunked(torch.device("cuda"), optimizer, True)
