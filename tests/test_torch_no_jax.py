"""The torch port must import without JAX: the machine with the GPU has none."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHECK = """
import sys
import stochqn_tpu_torch
from stochqn_tpu_torch import convert, fused
from stochqn_tpu_torch.ops.kernels import two_loop_kernel
loaded = {m.split('.')[0] for m in sys.modules}
bad = sorted({'jax', 'jaxlib', 'flax', 'stochqn_tpu'} & loaded)
assert not bad, bad
"""


def test_import_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
