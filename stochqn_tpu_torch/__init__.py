"""stochqn_tpu_torch — the PyTorch / CUDA port of ``stochqn_tpu``.

The JAX package ``stochqn_tpu`` is the reference; this package keeps its
module layout and function names and is held against it by the tests
(``tests/test_torch_*.py``).  It imports torch and numpy only.

Ported so far: the fused SQN engine's main path — SQN config and state,
the collapsed cached two-loop on a hand-written Hopper kernel
(``ops/kernels/two_loop_kernel.py``, ``csrc/direction_streamed.cu``), the
block-layout pair commit, the logistic losses and
``FusedTrainer("SQN")``.  ROADMAP.md lists what comes next.
"""
from stochqn_tpu_torch.convert import sqn_state_from_numpy, sqn_state_to_numpy
from stochqn_tpu_torch.core.config import SQNConfig
from stochqn_tpu_torch.core.enums import Info, Task
from stochqn_tpu_torch.core.state import BFGSMemory, SQNState
from stochqn_tpu_torch.fused import FusedTrainer, batchify
from stochqn_tpu_torch.models import losses
from stochqn_tpu_torch.ops.kernels.two_loop_kernel import (
    direction_streamed, direction_streamed_ref)
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         direction_is_bad)
from stochqn_tpu_torch.ops.two_loop import two_loop_cached

__all__ = [
    "Task", "Info",
    "SQNConfig",
    "BFGSMemory", "SQNState",
    "FusedTrainer", "batchify",
    "losses",
    "commit_pair", "conditional_flush", "direction_is_bad",
    "two_loop_cached",
    "direction_streamed", "direction_streamed_ref",
    "sqn_state_from_numpy", "sqn_state_to_numpy",
]
