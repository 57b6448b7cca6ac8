"""Run every example of the PyTorch port (``examples/torch/*.py``) end to
end on the CPU, and check what ``tests/test_examples.py`` checks of the
JAX package's examples: the Rosenbrock optimum, losses that fall, the
MLP's accuracy, the bitwise resume, the sharded fit against the unsharded
one.

Each example runs as a subprocess with ``--device cpu`` (their default is
the card); the two sharded ones start their own gloo ranks.  The fused
training example runs at a narrower width and fewer batches than its
BibTeX default (``--features 200 --num-batches 20``), to keep the run
short.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args, timeout=420):
    # one thread a process: the examples are small, and idle torch threads
    # spinning beside the other test workers slow every run down
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", name),
         "--device", "cpu", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    assert proc.returncode == 0, (
        f"{name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


@pytest.mark.parametrize("backend", ["torch", "native"])
@pytest.mark.parametrize("optimizer", ["oLBFGS", "SQN"])
def test_rosenbrock_free_mode(optimizer, backend):
    if backend == "native":
        import shutil
        if shutil.which("g++") is None:
            pytest.skip("no C++ compiler")
    out = _run("rosenbrock_free_mode.py", "--optimizer", optimizer,
               "--backend", backend)
    fval = float(out.split("f = ")[1].split(",")[0])
    assert fval < 1e-8, out    # at the (1, 1) optimum


def test_checkpoint_resume():
    out = _run("checkpoint_resume.py")
    assert "OK" in out, out


def test_fused_training():
    out = _run("fused_training.py", "--features", "200", "--num-batches",
               "20", "--epochs", "3")
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if "epoch" in line]
    assert len(losses) >= 3 and all(b < a for a, b in zip(losses,
                                                          losses[1:])), out


def test_pytree_mlp_adaqn():
    out = _run("pytree_mlp_adaqn.py")
    assert "done" in out, out
    accs = [float(line.rsplit("acc", 1)[1])
            for line in out.splitlines() if "acc" in line]
    assert accs and accs[-1] >= 0.9, out


def test_data_parallel_sqn():
    out = _run("data_parallel_sqn.py")
    losses = [float(line.split("loss/row")[1].split()[0])
              for line in out.splitlines() if "loss/row" in line]
    assert "data=4" in out and "gloo" in out, out
    assert len(losses) >= 2 and losses[-1] < losses[0], out


def test_sharded_guided_fit():
    out = _run("sharded_guided_fit.py")
    assert "ONE engine call" in out, out
    assert out.strip().endswith("ok"), out
