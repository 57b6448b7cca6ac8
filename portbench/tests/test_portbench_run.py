"""``run.py`` on a machine without a card, and the import isolation."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

HERE = harness.HERE


def _run(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sqn_bibtex.graph", "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("args", [
    ["run.py", "--seed", "1", "--seconds", "1"],
    ["control.py", "--seeds", "1", "--out", "{tmp}/readings.json"]])
def test_refuses_without_a_card(tmp_path, args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script, *extra = [a.format(tmp=tmp_path) for a in args]
    out = subprocess.run(
        [sys.executable, "portbench/" + script, "--workload",
         "sqn_bibtex.graph", *extra],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert not (tmp_path / "readings.json").exists()


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "stochqn_tpu_torch", (path, name)


def test_a_run_loads_nothing_forbidden():
    code = ("import sys, torch; sys.path.insert(0, {repo!r}); "
            "from portbench import harness; "
            "from portbench.tests.conftest import FIXTURE; "
            "b = harness.Bench(FIXTURE / 'BENCHMARK.json', [FIXTURE]); "
            "ctx = harness.Context(b, 'tiny_dense.free', 3, "
            "torch.device('cpu')); harness.run_cell(ctx, 0.1, False); "
            "print(harness.forbidden_modules())").format(
                repo=str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    import json
    out = _run(harness.REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
