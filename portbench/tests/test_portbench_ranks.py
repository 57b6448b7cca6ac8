"""A cell on several cards runs as that many ranks (``portbench/ranks.py``):
here four gloo ranks on the CPU, on the fixture's ``tiny_sparse.split4``
(the tiny sparse cell on a ``(1, 4)`` mesh)."""
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness, ranks
from portbench.tests.conftest import FIXTURE

SEED = 2**31 + 41


def _cpu_args(*extra):
    return [*extra, "--device", "cpu", "--bench",
            str(FIXTURE / "BENCHMARK.json"), "--search", str(FIXTURE)]


def _run(cell, *extra, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "0.5", *_cpu_args(*extra)],
        cwd=harness.REPO, capture_output=True, text=True, timeout=timeout,
        env=env)


def _dead(pid: int) -> bool:
    return not os.path.exists(f"/proc/{pid}")


@pytest.fixture(scope="module")
def four_ranks():
    """One traced run of the four-rank cell."""
    return _run("tiny_sparse.split4", "--trace", "1")


def test_four_ranks_print_one_result(four_ranks):
    out = four_ranks
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["correct"] and result["attempted"] > 0
    # the compared numbers are the last lines of standard error
    tail = out.stderr.strip().splitlines()[-len(result["compared"]) - 1:]
    assert tail[-1] == "correct: True"
    assert all(t.startswith("compared ") for t in tail[:-1])
    assert result["metrics"]["collective_bytes_per_iter"]["value"] > 0


def test_four_ranks_report_four_devices(four_ranks):
    result = json.loads(four_ranks.stdout.strip().splitlines()[-1])
    device = result["device"]
    assert device["count"] == 4 and device["platform"] == "cpu"
    assert len(device["memory_peak_bytes_per_card"]) == 4


def test_four_ranks_check_as_one_rank_does(tiny, four_ranks):
    result = json.loads(four_ranks.stdout.strip().splitlines()[-1])
    ctx = harness.Context(tiny, "tiny_sparse.graph", SEED,
                          torch.device("cpu"))
    one, _ = harness.run_cell(ctx, 0.2, False)
    assert one["correct"]
    for name, c in result["compared"].items():
        assert abs(c["value"] - one["compared"][name]["value"]) \
            <= ctx.limits[name], name


def test_a_rank_that_raises_ends_the_run(tmp_path):
    env = dict(os.environ, PORTBENCH_TEST_PIDS=str(tmp_path))
    t0 = time.monotonic()
    out = _run("tiny_sparse.raising", env=env)
    assert out.returncode == 1 and out.stdout.strip() == ""
    assert time.monotonic() - t0 < 120
    assert "rank 1 fails in its set-up" in out.stderr
    pids = [int(p.read_text()) for p in tmp_path.iterdir()]
    assert len(pids) == 4 and all(_dead(p) for p in pids)


def test_the_launcher_ends_hanging_ranks_at_its_deadline(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PIDS", str(tmp_path))
    hang = ("import os, pathlib, time; pathlib.Path(os.environ['PIDS'], "
            "os.environ['RANK']).write_text(str(os.getpid())); "
            "time.sleep(600)")
    t0 = time.monotonic()
    code, out, errors = ranks.launch([sys.executable, "-c", hang], 3, 5.0)
    assert code == 1 and out == "" and "deadline" in errors
    assert time.monotonic() - t0 < 60
    pids = [int(p.read_text()) for p in tmp_path.iterdir()]
    assert len(pids) == 3 and all(_dead(p) for p in pids)


@pytest.mark.parametrize("rank_code,code", [(2, 2), (3, 3), (7, 1)])
def test_the_launcher_exits_as_the_failing_rank(rank_code, code):
    fails = (f"import os, sys, time; "
             f"sys.exit({rank_code}) if os.environ['RANK'] == '1' "
             f"else time.sleep(600)")
    got, out, _ = ranks.launch([sys.executable, "-c", fails], 2, 60.0)
    assert (got, out) == (code, "")


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """The control and every fault of the four-rank cell, one seed each,
    through ``control.py``'s launcher."""
    path = tmp_path_factory.mktemp("readings") / "readings.json"
    out = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload",
         "tiny_sparse.split4", "--control-seeds", str(SEED + 1),
         "--fault-seeds", str(SEED + 2), "--faults",
         "unchanged,half_batch,altered,no_param_sum", "--window-seconds",
         "0.2", "--out", str(path), *_cpu_args()],
        cwd=harness.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("kind", ["control", "unchanged", "half_batch",
                                  "altered", "no_param_sum"])
def test_a_broken_program_on_four_ranks_is_not_correct(tiny, readings,
                                                       kind):
    ctx = harness.Context(tiny, "tiny_sparse.split4", 1, torch.device("cpu"))
    (numbers,) = readings[kind].values()
    assert numbers and not harness.judge(numbers, ctx.limits), numbers


class _Ranks:
    """A stand-in for a Group: each rank's report given."""
    rank, world = 0, 4

    def __init__(self, reports):
        self.reports = reports

    def gather(self, mine):
        return [dict(mine, ids=ids) for ids in self.reports]


def _ctx(reports, chips=4):
    return types.SimpleNamespace(
        device=torch.device("cpu"), cell={"chips": chips},
        cell_name="cell", ranks=_Ranks(reports))


def test_the_count_is_the_cards_the_ranks_used():
    dev = harness.devices(_ctx([["a"], ["b"], ["c"], ["d"]]), set(), 5)
    assert dev["count"] == 4 and dev["memory_peak_bytes_per_card"] == [5] * 4
    with pytest.raises(RuntimeError, match="asks for 4 devices"):
        harness.devices(_ctx([["a"], ["a"], ["c"], ["d"]]), set(), 5)
    one = types.SimpleNamespace(device=torch.device("cpu"),
                                cell={"chips": 1}, cell_name="cell",
                                ranks=None)
    dev = harness.devices(one, {torch.device("cpu")}, 7)
    assert dev == dict(platform="cpu", kind="cpu", count=1,
                       memory_peak_bytes=7)


@pytest.mark.parametrize("chips", [1, 4])
def test_step_mfu_counts_the_cells_cards(monkeypatch, chips):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    costs = types.SimpleNamespace(step=lambda cfg: (6.0e6, 1.0e6))
    run = types.SimpleNamespace(
        device=torch.device("cuda", 0), cfg={},
        end_to_end={"iters_per_s": 1000.0},
        ctx=types.SimpleNamespace(
            peaks={"card": {"float32_flop_per_s": 1e12, "bytes_per_s": 1e11}},
            cell={"chips": chips}, module=lambda kind: costs))
    mfu = harness.Bench().module("metrics", "step_mfu").read(run)
    # the bytes bound it: 1e6 B over chips x 1e11 B/s, 1,000 iterations
    assert mfu == pytest.approx(100.0 * 1e-5 / chips * 1000.0)


def test_a_four_card_cell_refuses_without_cards():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sqn_criteo.split4", "--seed", "1", "--seconds", "1"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
