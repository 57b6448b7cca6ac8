"""The torch port must import without JAX: the machine with the GPU has none."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHECK = """
import sys
import stochqn_tpu_torch
from stochqn_tpu_torch import convert, free, fused
from stochqn_tpu_torch.core import adaqn, olbfgs, protocol, sqn
from stochqn_tpu_torch.ops import two_loop
from stochqn_tpu_torch.ops.kernels import two_loop_kernel
from stochqn_tpu_torch.utils import data, metrics, schedules
for name in ("oLBFGS_free", "SQN_free", "adaQN_free", "AdvanceResult",
             "OLBFGSConfig", "OLBFGSState", "BFGSMemoryInterleaved", "two_loop",
             "two_loop_sequential", "direction", "project"):
    assert hasattr(stochqn_tpu_torch, name), name
assert callable(sqn.advance) and callable(adaqn.advance)
assert callable(olbfgs.advance) and callable(fused.olbfgs_step)
free.oLBFGS_free(device="cpu", pairs_interleaved=True).run_optimizer(
    [0.0, 1.0], 0.1)
free.SQN_free(device="cpu").run_optimizer([0.0, 1.0], 0.1)
free.adaQN_free(device="cpu").run_optimizer([0.0, 1.0], 0.1)
assert schedules.step_size_sqrt(1.0, 3) == 0.5
assert metrics.summarize_infos([200]) == {"no_problems_encountered": 1}
assert len(list(data.rounds_of([[0.0]] * 4, 2))) == 2
assert callable(data.stream_rounds) and callable(fused.shuffle_batched)
loaded = {m.split('.')[0] for m in sys.modules}
bad = sorted({'jax', 'jaxlib', 'flax', 'stochqn_tpu'} & loaded)
assert not bad, bad
"""


def test_import_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
