"""The torch port must import without JAX: the machine with the GPU has
none, and no scikit-learn either."""
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
import numpy as np
import stochqn_tpu_torch.guided, stochqn_tpu_torch.models.logistic
import stochqn_tpu_torch.models.sparse, stochqn_tpu_torch.models.mlp
import stochqn_tpu_torch.api, stochqn_tpu_torch.optim_adapter
import stochqn_tpu_torch.utils.checkpoint
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
for name in ("SQN", "StochasticLogisticRegression", "minimize", "OLBFGS",
             "PytreeTrainer", "save_state", "load_state"):
    assert hasattr(stochqn_tpu_torch, name), name
# a protocol fit with a validation split: the split is the port's own
rng = np.random.default_rng(0)
X = rng.standard_normal((60, 3))
clf = stochqn_tpu_torch.models.logistic.StochasticLogisticRegression(
    valset_frac=0.2, nepochs=2, batches_per_epoch=4, device="cpu")
clf.fit(X, (X[:, 0] > 0).astype(float))
assert clf.predict(X).shape == (60,)
loaded = {m.split('.')[0] for m in sys.modules}
bad = sorted({'jax', 'jaxlib', 'flax', 'sklearn', 'stochqn_tpu'} & loaded)
assert not bad, bad
"""


def test_import_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
