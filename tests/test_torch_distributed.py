"""Multi-process runs of the PyTorch port over gloo on the CPU: the
counterparts of ``tests/test_distributed.py``.

Two clusters of ``tests/torch_dist_worker.py`` (2 and 4 processes, one rank
each, file rendezvous) run ``tests/dist_common.py``'s global problem, each
process loading only its ``process_local_batch_slice`` of the example axis:

* 2 processes x the three optimizers x ``dp`` (mesh 2 x 1: the state
  replicated, the rows split) and ``param`` (mesh 1 x 2: every
  parameter-axis field split, the rows whole);
* 4 processes, SQN, on meshes 2 x 2 and 4 x 1.

Each cell asserts that every rank holds the identical iterate, and that it
matches the JAX package's single-process run of the same problem
(``dist_common.run_single_process``) at ``tests/test_distributed.py``'s
tolerance.  The 2-process cluster also round-trips a sharded checkpoint.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dist_common as dc
import torch_dist_worker as tw

from stochqn_tpu_torch.parallel import distributed, make_mesh


def _base(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER")
               else base)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tw.suite_results("dist2", 2, _base(tmp_path_factory))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return tw.suite_results("dist4", 4, _base(tmp_path_factory))


def _check_cell(results, optimizer):
    xs = [r["x"] for r in results]
    for x in xs[1:]:
        np.testing.assert_array_equal(xs[0], x)
    np.testing.assert_allclose(xs[0], dc.run_single_process(optimizer),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("topology", ("dp", "param"))
@pytest.mark.parametrize("optimizer", dc.OPTIMIZERS)
def test_two_process_epoch(two, optimizer, topology):
    results = tw.load_case(*two, f"{optimizer}_{topology}", 2)
    _check_cell(results, optimizer)
    rows = [tuple(r["rows"]) for r in results]
    assert rows == ([(0, 4), (4, 8)] if topology == "dp" else [(0, 8)] * 2)


@pytest.mark.parametrize("topology", ("2x2", "4x1"))
def test_four_process_epoch(four, topology):
    _check_cell(tw.load_case(*four, f"SQN_{topology}", 4), "SQN")


def test_process_local_batch_slice_by_rank(two):
    results = tw.load_case(*two, "slices", 2)
    for rank, r in enumerate(results):
        assert tuple(r["2x1"]) == (4 * rank, 4 * rank + 4)
        assert tuple(r["1x2"]) == (0, 8)       # one param group: all rows
        assert tuple(r["none"]) == (4 * rank, 4 * rank + 4)


def test_sharded_checkpoint_round_trip(two):
    """save_sharded after an epoch on a 1 x 2 mesh, load_sharded into a
    fresh sharded state: the same bits, one more epoch the same bits as
    the uninterrupted run, and the consolidated file (dcp_to_torch_save)
    equal to gather_state."""
    for r in tw.load_case(*two, "checkpoint", 2):
        assert bool(r["same_bits"])
        assert bool(r["consolidated"])
        assert {"x", "mem/s", "mem/y", "mem/gram", "niter"} <= set(r["keys"])
        np.testing.assert_array_equal(r["x_resumed"], r["x_continued"])


def test_initialize_raises_when_no_peer_comes(tmp_path):
    """The environment names 2 processes and the second never comes: the
    group does not form and initialize raises (the JAX package's falls
    back to one process)."""
    code = ("import datetime\n"
            "from stochqn_tpu_torch.parallel import distributed\n"
            f"distributed.initialize(init_method='file://{tmp_path}/rdv', "
            "device_type='cpu', timeout=datetime.timedelta(seconds=2))\n"
            "print('FORMED')\n")
    env = dict(os.environ, WORLD_SIZE="2", RANK="0", PYTHONPATH=tw.REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "FORMED" not in proc.stdout


def test_initialize_single_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize(device_type="cpu")
    distributed.initialize(world_size=1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")
    assert distributed.process_local_batch_slice(8) == slice(0, 8)

