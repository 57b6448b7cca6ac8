"""The check reads each fault the program can have as not correct, and
the control (the plain reference a precision below the configuration's,
in the program's place) as not correct."""
import pytest
import torch

from portbench import faults, harness

CELLS = ["tiny_dense.graph", "tiny_sparse.graph", "tiny_dense.free",
         "tiny_dense.fit"]


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(tiny, cell, fault):
    ctx = harness.Context(tiny, cell, 2**31 + 23, torch.device("cpu"))
    with faults.plant(fault, ctx.module("models")):
        result, _ = harness.run_cell(ctx, 0.2, False)
    assert not result["correct"], result["compared"]


def test_the_bfloat16_control_is_not_correct(tiny):
    from portbench.control import reading
    ctx = harness.Context(tiny, "tiny_sparse.graph", 1, torch.device("cpu"))
    numbers = reading(tiny, "tiny_sparse.graph", 2**31 + 29,
                      torch.device("cpu"), 0.2, "control")
    assert not harness.judge(numbers, ctx.limits), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.Bench()
                                  .spec["workloads"]])
def test_the_control_at_the_cells_size_is_not_correct(card, cell, tmp_path):
    # each cell's own control at its own size: seconds on the card; a cell
    # on several cards through control.py's launcher
    import json
    import subprocess
    import sys
    from portbench.control import reading
    bench = harness.Bench()
    ctx = harness.Context(bench, cell, 1, card)
    if ctx.cell["chips"] == 1:
        numbers = reading(bench, cell, 2**31 + 31, card, 3.0, "control")
    else:
        if torch.cuda.device_count() < ctx.cell["chips"]:
            pytest.skip(f"needs {ctx.cell['chips']} cards")
        out = subprocess.run(
            [sys.executable, "portbench/control.py", "--workload", cell,
             "--control-seeds", str(2**31 + 31), "--window-seconds", "3",
             "--out", str(tmp_path / "r.json")], cwd=harness.REPO,
            capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        (numbers,) = json.loads((tmp_path / "r.json").read_text())[
            "control"].values()
    assert not harness.judge(numbers, ctx.limits), numbers
