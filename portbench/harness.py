"""The benchmark's core: find a cell's files by name, run it, print it.

``BENCHMARK.json`` names each part; the harness finds its file:

* a configuration: the ``file`` its entry gives, a JSON object of sizes
  whose ``model`` and ``data`` name the model's files below;
* a traffic mix: ``traffic/<name>.json``, whose ``driver`` names
  ``drivers/<driver>.py``, the code that drives the program's entry;
* a model: ``models/<model>.py`` (how the program computes its gradients),
  ``reference/<model>.py`` (the plain reference's), ``costs/<model>.py``
  (the operations and bytes an iteration needs);
* data: ``data/<kind>.py``, drawn from the run's seed;
* a cell's limits on the numbers its check compares:
  ``limits/<cell>.json``;
* a per-layer metric: ``metrics/<name>.py``, a reader ``read(run)`` that
  returns its value, or None where it finds nothing to read.

The search path lists directories that hold such files, this folder
last, so that a test can add a cell from a directory of its own.

A run (:func:`run_cell`): set-up (the program built, the data drawn, the
checked steps and the warm-up), the window of ``seconds``, with ``trace``
a profiled slice after it, the peak memory, the program's state freed,
then the check against the plain reference.  ``setup_s`` runs from the
start of the process to the window.

On several ranks (``Context.ranks``, :mod:`portbench.ranks`) every rank
makes the same run: set-up ends at a barrier, rank 0's clock ends the
window, rank 0 profiles its slice and runs the check while the others
wait, every rank runs the readers, and rank 0 reports the cards that
every rank's data and iterate were on.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "stochqn_tpu")


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, spec: Path = REPO / "BENCHMARK.json",
                 search: Sequence[Path] = ()):
        self.spec_path = Path(spec)
        self.spec = json.loads(self.spec_path.read_text())
        self.base = self.spec_path.parent
        self.search = [Path(p) for p in search] + [HERE]
        self._modules: Dict[Path, Any] = {}

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.spec[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"{self.spec_path.name} has no {kind} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.base / self._entry("configs", name)["file"])
                          .read_text())

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.search:
            p = d / kind / (name + suffix)
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.search]}")

    def data(self, kind: str, name: str) -> dict:
        return json.loads(self.find(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` loaded by its path (a name may hold dots)."""
        path = self.find(kind, name, ".py")
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (true): those whose ``workloads`` list the cell, and those
        without the key (for a per-layer metric, in every cell that
        reports the end-to-end metric it moves)."""
        if not trace:
            return [m for m in self.spec["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        moved = {m["name"] for m in self.metrics(cell, False)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]


class Context:
    """What a driver is given: the cell's parts, the seed, the device and
    the tables it reads."""

    def __init__(self, bench: Bench, cell: str, seed: int, device,
                 ranks=None):
        self.bench, self.cell_name, self.seed = bench, cell, int(seed)
        self.device = device
        self.ranks = ranks          # a portbench.ranks.Group, or None
        self.cell = bench.cell(cell)
        self.cfg = bench.config(self.cell["config"])
        self.traffic = bench.data("traffic", self.cell["traffic"])
        self.limits = bench.data("limits", cell)
        self.peaks = json.loads((HERE / "peaks.json").read_text())
        self.t_start = time.perf_counter()     # the process's, in a run
        self.marks: Dict[str, float] = {}      # set-up's steps, by the clock

    def module(self, kind: str, name: Optional[str] = None):
        return self.bench.module(kind, name or self.cfg["model"])

    def driver(self):
        return self.bench.module("drivers", self.traffic["driver"])

    def draw(self) -> dict:
        """The cell's data from the seed, on the device."""
        return self.bench.module("data", self.cfg["data"]).make(
            self.cfg, self.seed, self.device)

    def mesh(self, shape):
        """The port's ``(data, param)`` mesh of ``shape`` over the ranks."""
        if self.ranks is None:
            raise ValueError(f"{self.cell_name}: a mesh needs a cell of "
                             f"several chips, run as ranks")
        return self.ranks.mesh(shape)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared within its limit, and every limit given a
    number."""
    return set(numbers) == set(limits) and all(
        v <= limits[k] for k, v in numbers.items())


def forbidden_modules() -> List[str]:
    """The modules loaded in this process whose top-level name is one that
    no run may load (compared whole: the port's name starts with the JAX
    package's)."""
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def card_id(device) -> str:
    """What tells one device from another: a card's UUID; on the CPU (the
    tests' ranks) each process counts as a device of its own."""
    import torch
    if device.type == "cuda":
        return str(torch.cuda.get_device_properties(device).uuid)
    return f"cpu/{os.getpid()}"


def devices(ctx: Context, held, peak: int) -> dict:
    """The result's ``device``: every rank's cards (``held``, the devices
    its data and iterate were on) gathered, ``count`` the distinct ones,
    ``kind`` their common name, ``memory_peak_bytes`` the fullest card's
    peak and, on several ranks, each rank's.  Raises where the count is
    not the cell's ``chips``: a run has to use the devices it is given."""
    import torch
    cuda = ctx.device.type == "cuda"
    mine = dict(ids=sorted({card_id(d) for d in held}), peak=int(peak),
                kind=torch.cuda.get_device_name(ctx.device) if cuda
                else "cpu")
    every = [mine] if ctx.ranks is None else ctx.ranks.gather(mine)
    ids = {i for r in every for i in r["ids"]}
    kinds = {r["kind"] for r in every}
    if len(kinds) != 1:
        raise RuntimeError(f"the ranks ran on different devices: {kinds}")
    if len(ids) != ctx.cell["chips"]:
        raise RuntimeError(
            f"{ctx.cell_name} asks for {ctx.cell['chips']} devices, and "
            f"its data and iterates were on {len(ids)}: {sorted(ids)}")
    device = dict(platform="gpu" if cuda else "cpu", kind=kinds.pop(),
                  count=len(ids),
                  memory_peak_bytes=max(r["peak"] for r in every))
    if ctx.ranks is not None:
        device["memory_peak_bytes_per_card"] = [r["peak"] for r in every]
    return device


def run_cell(ctx: Context, seconds: float, trace: bool):
    """One run: the driver's set-up, window, optional profiled slice and
    check.  Returns the result (the ``compared`` numbers last) and the
    driver's notes, which the caller prints; on a rank other than 0, None
    and the line of its set-up's steps."""
    import torch
    from portbench import driving

    cuda = ctx.device.type == "cuda"
    ranks = ctx.ranks
    run = ctx.driver().Run(ctx)
    ctx.marks["driver"] = run.clock()
    run.setup()
    run.sync()
    ctx.marks["ready"] = run.clock()
    if ranks is not None:
        ranks.barrier()             # set-up ends once every rank's has
    run.setup_s = run.clock() - ctx.t_start
    before = driving.card_state() if cuda else "no card"
    run.window(seconds)
    after = driving.card_state() if cuda else "no card"
    if trace:
        run.trace()
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    held = run.held()
    notes = run.notes() + [
        f"card clocks (SM, memory), power and temperature before the "
        f"window: {before}; after it: {after}",
        "set-up, seconds from the run's start to each step: " + ", ".join(
            f"{k} {t - ctx.t_start:.3f}" for k, t in ctx.marks.items())
        + f", window {run.setup_s:.3f}"]
    run.release()
    numbers = run.check()
    if ranks is not None:
        ranks.barrier()             # the others wait for rank 0's check
    result = dict(correct=judge(numbers, ctx.limits),
                  attempted=int(run.attempted), failed=int(run.failed))
    if trace:
        wanted = ctx.bench.metrics(ctx.cell_name, True)
        values = {m["name"]: (m, ctx.bench.module("metrics", m["name"])
                              .read(run)) for m in wanted}
        metrics = {k: {"value": v, "unit": m["unit"]}
                   for k, (m, v) in values.items() if v is not None}
    else:
        wanted = ctx.bench.metrics(ctx.cell_name, False)
        values = dict(run.end_to_end, setup_s=run.setup_s)
        missing = [m["name"] for m in wanted if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in wanted}
    result["metrics"] = metrics
    device = devices(ctx, held, peak)
    if not run.leader:
        return None, notes[-1:]
    result["device"] = device
    if trace:
        device.update(busy_s=run.traced["busy_s"],
                      window_s=run.traced["window_s"])
        result["breakdown"] = run.traced["breakdown"]
    result["compared"] = {k: {"value": v, "limit": ctx.limits.get(k)}
                          for k, v in numbers.items()}
    return result, notes
