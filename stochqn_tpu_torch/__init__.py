"""stochqn_tpu_torch — the PyTorch / CUDA port of ``stochqn_tpu``.

The JAX package ``stochqn_tpu`` is the reference; this package keeps its
module layout and function names and is held against it by the tests
(``tests/test_torch_*.py``).  It imports torch and numpy only.

Ported so far: the fused SQN engine's main path — SQN config and state,
the collapsed cached two-loop on a hand-written Hopper kernel
(``ops/kernels/two_loop_kernel.py``, ``csrc/direction_streamed.cu``), the
block-layout pair commit, the logistic losses and
``FusedTrainer("SQN")`` — and the fused adaQN engine: adaQN config and
state with the Fisher ring, the AdaGrad / RMSProp accumulators, the
empirical-Fisher ``y``, the diagonal-H0 two-loop with its projection on a
hand-written Hopper kernel (``csrc/project_adaqn.cu``) and
``FusedTrainer("adaQN")``; and the free-mode protocol tier:
``core/protocol.py``, ``core/sqn.advance``, ``core/adaqn.advance`` and the
request-loop classes ``SQN_free`` / ``adaQN_free``, with the uncached
oracles ``two_loop`` / ``two_loop_sequential`` and the last two kernels
(``csrc/project.cu``, ``csrc/direction.cu``); and oLBFGS in every mode:
``OLBFGSConfig``, ``OLBFGSState``, ``core/olbfgs``, ``oLBFGS_free`` and
``FusedTrainer("oLBFGS")`` on the uncollapsed cached two-loop, with the
interleaved pair layout (``BFGSMemoryInterleaved``, shift and ring
commits) for oLBFGS and SQN, whose collapsed direction takes the same two
kernels on the interleaved buffer; and the rest of the fused engine: the
generic per-step epoch layout (any epoch length, any start), the
scheduled, shuffled and streamed epoch drivers (``epochs_scheduled``,
``run_epochs``, ``shuffle_batched``, ``utils.data.stream_rounds``), paired
oLBFGS gradients, bfloat16 pair and Fisher storage in every optimizer
(the bfloat16 pairs on ``direction_streamed``), and ``utils`` (schedules,
streaming, metrics); and the front ends: the guided ``oLBFGS`` / ``SQN`` /
``adaQN`` (``fit`` on the protocol or the fused engine, ``partial_fit``),
``models.logistic.StochasticLogisticRegression`` (dense and CSR, through
``models.sparse``), ``minimize``, the ``torch.optim`` adapter
``optim_adapter.OLBFGS`` with ``PytreeTrainer``, ``models.mlp`` and the
``.npz`` checkpoints of ``utils.checkpoint``.  ROADMAP.md lists what comes
next.
"""
from stochqn_tpu_torch.api import MinimizeResult, minimize
from stochqn_tpu_torch.convert import (
    adaqn_state_from_numpy, adaqn_state_to_numpy,
    bfgs_memory_interleaved_from_numpy, bfgs_memory_interleaved_to_numpy,
    fisher_memory_from_numpy, fisher_memory_to_numpy,
    mlp_params_from_numpy, mlp_params_to_numpy,
    olbfgs_state_from_numpy, olbfgs_state_to_numpy, sqn_state_from_numpy,
    sqn_state_to_numpy)
from stochqn_tpu_torch.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu_torch.core.enums import Info, Task
from stochqn_tpu_torch.core.protocol import AdvanceResult
from stochqn_tpu_torch.core.state import (AdaQNState, BFGSMemory,
                                          BFGSMemoryInterleaved,
                                          FisherMemory, OLBFGSState, SQNState)
from stochqn_tpu_torch.free import SQN_free, adaQN_free, oLBFGS_free
from stochqn_tpu_torch.fused import (FusedTrainer, batchify,
                                     shuffle_batched)
from stochqn_tpu_torch.guided import SQN, adaQN, oLBFGS
from stochqn_tpu_torch.models import losses
from stochqn_tpu_torch.models.logistic import StochasticLogisticRegression
from stochqn_tpu_torch.optim_adapter import OLBFGS, PytreeTrainer, olbfgs
from stochqn_tpu_torch.ops.kernels.two_loop_kernel import (
    direction, direction_ref, direction_streamed, direction_streamed_ref,
    project, project_adaqn, project_adaqn_ref, project_ref)
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         direction_is_bad, fisher_y)
from stochqn_tpu_torch.ops.two_loop import (two_loop, two_loop_cached,
                                            two_loop_sequential)
from stochqn_tpu_torch.utils.checkpoint import load_state, save_state

__all__ = [
    "Task", "Info",
    "OLBFGSConfig", "SQNConfig", "AdaQNConfig",
    "BFGSMemory", "BFGSMemoryInterleaved", "OLBFGSState", "SQNState",
    "FisherMemory", "AdaQNState",
    "AdvanceResult", "oLBFGS_free", "SQN_free", "adaQN_free",
    "FusedTrainer", "batchify", "shuffle_batched",
    "oLBFGS", "SQN", "adaQN", "StochasticLogisticRegression",
    "minimize", "MinimizeResult", "OLBFGS", "olbfgs", "PytreeTrainer",
    "save_state", "load_state",
    "losses",
    "commit_pair", "conditional_flush", "direction_is_bad", "fisher_y",
    "two_loop", "two_loop_cached", "two_loop_sequential",
    "direction", "direction_ref",
    "direction_streamed", "direction_streamed_ref",
    "project", "project_ref", "project_adaqn", "project_adaqn_ref",
    "olbfgs_state_from_numpy", "olbfgs_state_to_numpy",
    "sqn_state_from_numpy", "sqn_state_to_numpy",
    "bfgs_memory_interleaved_from_numpy", "bfgs_memory_interleaved_to_numpy",
    "adaqn_state_from_numpy", "adaqn_state_to_numpy",
    "fisher_memory_from_numpy", "fisher_memory_to_numpy",
    "mlp_params_from_numpy", "mlp_params_to_numpy",
]
