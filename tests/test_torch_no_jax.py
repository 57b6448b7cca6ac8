"""The torch port must import without JAX: the machine with the GPU has
none, and no scikit-learn either."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHECK = """
import sys
import stochqn_tpu_torch
from stochqn_tpu_torch import convert, free, fused, graphs
from stochqn_tpu_torch.core import adaqn, olbfgs, protocol, sqn
from stochqn_tpu_torch.ops import two_loop
from stochqn_tpu_torch.ops.kernels import two_loop_kernel
from stochqn_tpu_torch.utils import data, metrics, schedules
import numpy as np
import stochqn_tpu_torch.guided, stochqn_tpu_torch.models.logistic
import stochqn_tpu_torch.models.sparse, stochqn_tpu_torch.models.mlp
import stochqn_tpu_torch.api, stochqn_tpu_torch.optim_adapter
import stochqn_tpu_torch.utils.checkpoint
import stochqn_tpu_torch.parallel
from stochqn_tpu_torch.parallel import comm, distributed, evaluate, mesh
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
# the bfloat16 iterate, and the C++ core through the port's own bridge
import torch
from stochqn_tpu_torch import native_backend
x_bf16 = np.array([0.3, 1.7], np.float32)
opt = free.SQN_free(device="cpu", dtype=torch.bfloat16)
req = opt.run_optimizer(x_bf16, 0.1)
assert opt.state.x.dtype == torch.bfloat16
assert req["requested_on"].dtype == np.float32
assert stochqn_tpu_torch.__version__ == "0.1.0"
import shutil
if shutil.which("g++"):
    nat = free.SQN_free(backend="native")
    nat.run_optimizer(np.array([0.0, 1.0]), 0.1)
    nat.update_gradient(np.array([0.5, -0.5]))
    assert nat.run_optimizer(np.array([0.0, 1.0]), 0.1)["task"] == "calc_grad"
    assert native_backend.native_available()
assert schedules.step_size_sqrt(1.0, 3) == 0.5
assert metrics.summarize_infos([200]) == {"no_problems_encountered": 1}
assert len(list(data.rounds_of([[0.0]] * 4, 2))) == 2
assert callable(data.stream_rounds) and callable(fused.shuffle_batched)
for name in ("SQN", "StochasticLogisticRegression", "minimize", "OLBFGS",
             "PytreeTrainer", "save_state", "load_state", "save_sharded",
             "load_sharded"):
    assert hasattr(stochqn_tpu_torch, name), name
for name in ("make_mesh", "shard_state", "shard_batches", "gather_state",
             "data_parallel_grad", "data_parallel_value", "data_parallel_hvp",
             "record_collectives", "collective_ops", "collective_bytes",
             "DATA_AXIS", "PARAM_AXIS"):
    assert hasattr(stochqn_tpu_torch.parallel, name), name
for name in ("initialize", "global_mesh", "process_local_batch_slice",
             "global_batches", "shard_state_global", "replicate_global"):
    assert hasattr(distributed, name), name
# a one-process group over gloo: a sharded fused epoch and its recorder
import torch, tempfile, os
tmp = tempfile.mkdtemp()
distributed.initialize(world_size=1)          # one process: a no-op
assert not torch.distributed.is_initialized()
torch.distributed.init_process_group(
    "gloo", init_method="file://" + os.path.join(tmp, "rdv"), world_size=1,
    rank=0)
m = mesh.make_mesh(device_type="cpu")
tr = fused.FusedTrainer("SQN", stochqn_tpu_torch.SQNConfig.create(
    mem_size=2, bfgs_upd_freq=2), lambda x, b: x - b.mean(0), mesh=m)
with comm.record_collectives() as log:
    st, _ = tr.epoch(tr.init(torch.zeros(4)), torch.ones(2, 2, 4), 0.1)
assert [op.label for op in log] == ["grad", "grad", "hvp"], log
# a CPU mesh: the single-dispatch programs run the eager loop
st0 = tr.init(torch.zeros(4))
st, infos = tr.jit_epochs()(st0, torch.ones(2, 2, 4), 0.1, 2)
assert infos.shape == (2, 2) and int(st.niter) == 4 and int(st0.niter) == 0
assert not graphs.captures(st)
torch.distributed.destroy_process_group()
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
