"""The port's spans, counters and kernel labels
(:mod:`stochqn_tpu_torch.utils.metrics`), and the benchmark's readers of
them (``portbench/metrics/``, ``portbench/labels.py``).

On the CPU: a ``jit_epochs`` call through the graph driver, with the
stand-in for the capture that ``test_torch_jit_epochs.py`` uses, records
its spans nested and in order, counts one host read per call unless
``aligned=True``, and counts the bytes copied into the buffers and back;
an SQN epoch "captured" with the node count stubbed by a count of the
non-view ops dispatched gets contiguous labels over every op, in the
order of its steps, rounds and write-back, in both epoch layouts; a fused
fit of the model records its spans once; each reader reads a synthetic
run.  On the card (``cuda``): a captured SQN epoch's labels cover the
graph's nodes, and a profiled replay runs as many device operations.

This file imports no JAX: run its card cases on the machine with the card,
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
"""
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import harness, labels
from stochqn_tpu_torch import (FusedTrainer, SQNConfig,
                               StochasticLogisticRegression, graphs)
from stochqn_tpu_torch.utils import metrics
import torch_dist_worker as tw

F64 = torch.float64
N, BS, M, L = 6, 2, 3, 4
STEP = ["gradient", "direction", "guard", "update"]


def _trainer(inner=False, **kw):
    """SQN on a quadratic; with ``inner``, its gradient's two products
    labelled ``mean`` and ``product`` inside the trainer's labels."""
    a = torch.from_numpy(np.diag(np.linspace(0.5, 3.0, N)))

    def grad(x, batch):
        if not inner:
            return a @ (x - batch.mean(0))
        with metrics.label("mean"):
            r = x - batch.mean(0)
        with metrics.label("product"):
            return a @ r

    def hess_vec(x, v, batch):
        return a @ v
    return FusedTrainer("SQN", SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                        grad, hess_vec_fn=hess_vec, **kw)


def _data(nb, dtype=F64):
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.standard_normal((nb, BS, N))).to(dtype)


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", tw.ReplayedGraph)
    monkeypatch.setattr(graphs, "captures", lambda state: True)
    metrics.reset()


def _spans(prof):
    """``(start, end, name)`` of the port's spans in the profile, in start
    order."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("stochqn."))


# -- spans and counters ------------------------------------------------------- #
def test_jit_epochs_spans_nest_in_order(replayed):
    tr = _trainer()
    program, data = tr.jit_epochs(), _data(8)
    state, _ = program(tr.init(torch.zeros(N, dtype=F64)), data, 0.05, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program(state, data, 0.05, 2)
    spans = _spans(prof)
    assert [s[2] for s in spans] == [
        "stochqn.jit_epochs", "stochqn.host_read", "stochqn.load",
        "stochqn.replay", "stochqn.load", "stochqn.replay"]
    (a, b, _), inner = spans[0], spans[1:]
    assert all(a <= c and d <= b for c, d, _ in inner)
    assert all(inner[i][1] <= inner[i + 1][0] for i in range(len(inner) - 1))
    counts = {k: v[0] for k, v in metrics.SPANS.items()}
    assert counts == {"stochqn.jit_epochs": 2, "stochqn.host_read": 2,
                      "stochqn.load": 3, "stochqn.replay": 3}
    assert all(v[1] >= v[2] > 0 for v in metrics.SPANS.values())


@pytest.mark.parametrize("aligned,reads", [(None, 1), (True, 0)])
def test_host_reads_per_call(replayed, aligned, reads):
    tr = _trainer(donate=True)
    program, data = tr.jit_epochs(), _data(8)
    state = tr.init(torch.zeros(N, dtype=F64))
    for _ in range(3):
        state, _ = program(state, data, 0.05, 2, aligned=aligned)
    assert metrics.COUNTERS["host_reads"] == 3 * reads
    assert metrics.SPANS["stochqn.jit_epochs"][0] == 3
    assert metrics.SPANS.get("stochqn.host_read", [0])[0] == 3 * reads


@pytest.mark.parametrize("donate", [False, True])
def test_copy_counters_are_the_buffers_bytes(replayed, donate):
    tr = _trainer(donate=donate)
    program, data = tr.jit_epochs(), _data(10)
    state = tr.init(torch.zeros(N, dtype=F64))
    for _ in range(2):
        state, _ = program(state, data, 0.05, 3)
    fams = list(tr._programs.families.values())
    assert metrics.COUNTERS["copy_in_bytes"] == sum(
        f.copy_in_bytes for f in fams) > 0
    copied = sum(g.replays * g.copy_bytes for g in tr._programs.graphs())
    assert metrics.COUNTERS["copy_back_bytes"] == copied > 0


def test_free_mode_host_reads_are_counted():
    from stochqn_tpu_torch.core.protocol import host_ints
    metrics.reset()
    assert host_ints(torch.tensor(3), torch.tensor(4)) == [3, 4]
    assert metrics.COUNTERS["host_reads"] == 1
    assert metrics.SPANS["stochqn.host_read"][0] == 1


def test_snapshot_is_a_copy_and_reset_clears():
    metrics.reset()
    with metrics.span("stochqn.x"):
        metrics.count("host_reads", 2)
    snap = metrics.snapshot()
    metrics.reset()
    assert snap["counters"]["host_reads"] == 2
    assert snap["spans"]["stochqn.x"][0] == 1
    assert metrics.SPANS == {} and set(metrics.COUNTERS.values()) == {0}


def test_fused_fit_records_its_spans_once():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((64, 5))
    y = np.eye(3)[rng.integers(0, 3, 64)]
    model = StochasticLogisticRegression(
        optimizer="SQN", engine="fused", device="cpu", dtype=F64,
        nepochs=2, batches_per_epoch=4, valset_frac=None, step_size=1e-2,
        mem_size=M, bfgs_upd_freq=2, random_state=1)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.fit(X, y)
    spans = _spans(prof)
    assert [s[2] for s in spans] == [
        "stochqn.fit", "stochqn.fit.prepare", "stochqn.fit.epochs",
        "stochqn.fit.finish"]
    assert {k: v[0] for k, v in metrics.SPANS.items()} == {
        "stochqn.fit": 1, "stochqn.fit.prepare": 1, "stochqn.fit.epochs": 1,
        "stochqn.fit.finish": 1}


# -- kernel labels ------------------------------------------------------------ #
class _Nodes(TorchDispatchMode):
    """A stand-in for a capture's node count: the ops dispatched that
    make or change a tensor's values (not views, not bare allocations)."""
    FREE = {torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default}

    def __init__(self):
        super().__init__()
        self.n = 0

    def mark(self):
        return self.n

    def resolve(self):
        return self.n, lambda mark: mark

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func not in self.FREE:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _captured_map(nb, generic, **kw):
    """One SQN epoch as ``graphs._Graph._capture`` records it, the node
    count stubbed by :class:`_Nodes`: ``(node_count, ranges)``."""
    tr = _trainer(**kw)
    data = _data(nb)
    state = tr.init(torch.zeros(N, dtype=F64))
    fam = graphs.EpochPrograms(tr).family("batched", state, data, F64, None)
    fam.load(state, data, torch.tensor(0.05, dtype=F64))
    with _Nodes() as nodes, metrics.capturing(nodes) as cap:
        out, _ = tr._epoch_at(fam.state_tree(), fam.inputs_tree(), fam.eta,
                              0, generic)
        fam.write_back(out)
        return cap.map()


def _expected(nb, generic):
    want = []
    for i in range(nb):
        want += STEP
        if generic:
            want.append("boundary" if (i + 1) % L == 0 else "infos")
        elif (i + 1) % L == 0:
            want += ["boundary", "infos"]
    return want + ["infos", "copy_back"]


@pytest.mark.parametrize("nb,generic", [(8, False), (8, True), (10, True)])
def test_labels_cover_every_node_in_order(nb, generic):
    count, ranges = _captured_map(nb, generic)
    assert [r[0] for r in ranges] == _expected(nb, generic)
    assert ranges[0][1] == 0 and ranges[-1][2] == count
    assert all(ranges[i][2] == ranges[i + 1][1]
               for i in range(len(ranges) - 1))
    assert all(first < end for _, first, end in ranges)


@pytest.mark.parametrize("nb,generic", [(8, False), (8, True), (10, True)])
def test_nested_labels_keep_the_outer_ranges(nb, generic):
    """Labels inside the gradient record ``gradient/mean`` and
    ``gradient/product`` inside each ``gradient`` range; the SQN epoch's
    own map is the one it has without them, entry for entry."""
    count, ranges = _captured_map(nb, generic)
    n_count, nested = _captured_map(nb, generic, inner=True)
    assert n_count == count
    assert [r for r in nested if "/" not in r[0]] == ranges
    grads = [r for r in ranges if r[0] == "gradient"]
    for inner in ("mean", "product"):
        mine = [r for r in nested if r[0] == f"gradient/{inner}"]
        assert len(mine) == len(grads)
        assert all(g[1] <= m[1] < m[2] <= g[2] for g, m in zip(grads, mine))


def test_device_counters_read_once_and_reset_in_place():
    metrics.reset()
    c = metrics.device_counter("expert_tokens", (2, 3), "cpu")
    assert metrics.device_counter("expert_tokens", (2, 3), "cpu") is c
    c[1].index_add_(0, torch.tensor([0, 2, 2]), torch.ones(3, dtype=c.dtype))
    snap = metrics.snapshot()
    assert snap["device_counters"]["expert_tokens"] == [[0, 0, 0], [1, 0, 2]]
    metrics.reset()
    assert metrics.DEVICE_COUNTERS["expert_tokens"] is c
    assert int(c.sum()) == 0


def test_label_outside_a_capture_records_nothing():
    before = list(graphs.STATS["labels"])
    assert metrics.label("gradient") is metrics.label("boundary")
    tr = _trainer()
    tr.epoch(tr.init(torch.zeros(N, dtype=F64)), _data(8), 0.05)
    assert graphs.STATS["labels"] == before
    with _Nodes() as nodes, metrics.capturing(nodes) as cap:
        with metrics.label("boundary"):
            torch.ones(2) + 1
            with metrics.label("gradient"):      # inside: a range of its own
                torch.ones(2) + 1
    assert cap.map() == (4, [("boundary/gradient", 2, 4), ("boundary", 0, 4)])
    with metrics.label("gradient"):
        pass
    assert len(cap.marks) == 2


def test_a_failing_label_keeps_its_error():
    """A body that raises inside a label (a host read voiding the capture)
    raises its own error: the label queries nothing more."""
    class Void:
        queried = 0

        def mark(self):
            if self.queried:
                raise RuntimeError("the capture is void")
            self.queried += 1
            return 0
    with pytest.raises(ValueError, match="the user's"):
        with metrics.capturing(Void()) as cap:
            with metrics.label("gradient"):
                raise ValueError("the user's error")
    assert cap.marks == []


# -- the benchmark's readers ---------------------------------------------------- #
def _read(name, run):
    return harness.Bench().module("metrics", name).read(run)


MAP = (4, [("gradient", 0, 1), ("direction", 1, 2), ("guard", 2, 3),
           ("update", 3, 4)])
OPS = [("k", 1.0), ("k", 2.0), ("k", 3.0), ("k", 4.0)]


@pytest.mark.parametrize("name,value", [
    ("gradient_share_pct", 10.0), ("update_share_pct", 70.0),
    ("boundary_share_pct", 0.0)])
def test_label_readers(name, value):
    run = types.SimpleNamespace(label_launches={
        "maps": [MAP, MAP], "launches": [OPS, OPS[:3], OPS]})
    assert _read(name, run) == pytest.approx(value)


@pytest.mark.parametrize("got", [
    None,
    {"maps": [MAP], "launches": [OPS[:3]]},                 # count differs
    {"maps": [MAP, (4, [("gradient", 0, 4)])], "launches": [OPS]},  # two
])
def test_label_readers_none_without_a_match(got):
    run = types.SimpleNamespace(label_launches=got)
    assert _read("gradient_share_pct", run) is None


def test_label_readers_none_on_the_cpu():
    run = types.SimpleNamespace(device=torch.device("cpu"))
    assert _read("boundary_share_pct", run) is None
    assert labels.profile_launches(lambda: torch.ones(3) + 1,
                                   lambda: None) == []


def test_span_and_counter_readers(monkeypatch):
    run = types.SimpleNamespace()
    metrics.reset()
    for name in ("host_reads_per_call", "replay_issue_ms",
                 "copy_bytes_per_replay", "prepare_s_per_fit"):
        assert _read(name, run) is None, name
    metrics.SPANS.update({"stochqn.jit_epochs": [4, 1.0, 0.5],
                          "stochqn.replay": [8, 0.02, 0.01],
                          "stochqn.fit": [2, 1.0, 0.6],
                          "stochqn.fit.prepare": [2, 0.5, 0.3]})
    metrics.COUNTERS.update(host_reads=4, copy_in_bytes=100,
                            copy_back_bytes=700)
    monkeypatch.setitem(graphs.STATS, "replays", 8)
    assert _read("host_reads_per_call", run) == 1.0
    assert _read("replay_issue_ms", run) == pytest.approx(2.5)
    assert _read("copy_bytes_per_replay", run) == 100.0
    assert _read("prepare_s_per_fit", run) == 0.25
    metrics.reset()


def test_fit_program_hit_reader(monkeypatch):
    """``fit_program_hit_pct``: the fits that reused a trainer over every
    fused fit; nothing before a fit, or where the program keeps no such
    counters (a program without them, as before they were added)."""
    run = types.SimpleNamespace()
    metrics.reset()
    assert _read("fit_program_hit_pct", run) is None
    metrics.COUNTERS.update(fit_programs_built=1, fit_programs_reused=199)
    assert _read("fit_program_hit_pct", run) == 99.5
    monkeypatch.setattr(metrics, "COUNTERS", {"host_reads": 3})
    assert _read("fit_program_hit_pct", run) is None
    monkeypatch.undo()
    metrics.reset()


# -- on the card ------------------------------------------------------------- #
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a captured CUDA graph's nodes; "
                    "runs on the card only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [None, False])
def test_captured_labels_cover_the_graph(dev, aligned):
    """The round-chunked (``aligned=None``) and generic (``False``) SQN
    epoch graphs: contiguous labels from node 0 to the graph's last, in
    the order of the steps, and one profiled replay runs as many device
    operations as the graph has nodes."""
    from stochqn_tpu_torch.models import losses
    rng = np.random.default_rng(1)
    nb, feats, classes = 8, 12, 5
    X = torch.from_numpy(rng.standard_normal((nb, BS * 2, feats))
                         .astype(np.float32)).to(dev)
    Y = torch.from_numpy(np.eye(classes, dtype=np.float32)[
        rng.integers(0, classes, (nb, BS * 2))]).to(dev)
    x0 = torch.zeros((feats + 1) * classes, device=dev)

    def grad(x, b):
        return losses.multinomial_logistic_grad(x, b[0], b[1], None, 0.1)
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                      grad)
    program = tr.jit_epochs()
    graphs.reset_stats()
    state, _ = program(tr.init(x0), (X, Y), 0.05, 1, aligned=aligned)
    ((count, ranges),) = graphs.STATS["labels"]
    assert [r[0] for r in ranges] == _expected(nb, aligned is False)
    assert ranges[0][1] == 0 and ranges[-1][2] == count
    assert all(ranges[i][2] == ranges[i + 1][1]
               for i in range(len(ranges) - 1))
    launches = labels.profile_launches(
        lambda: program(state, (X, Y), 0.05, 1, aligned=aligned),
        torch.cuda.synchronize)
    assert [len(ops) for ops in launches] == [count]
    # the replay's order is the labels': each direction launch in its label
    at = {i for i, (name, _) in enumerate(launches[0])
          if "direction_one_read" in name}
    labelled = {i for name, a, b in ranges if name == "direction"
                for i in range(a, b)}
    assert len(at) == nb and at <= labelled


@pytest.mark.cuda
def test_label_readers_read_a_traced_run(dev):
    """A traced run of the tiny dense graph cell: the label readers profile
    their own replays, match every one to the captured map and read shares
    that sum to 100%; the run's counters are as they were."""
    from portbench.tests.conftest import FIXTURE
    bench = harness.Bench(FIXTURE / "BENCHMARK.json", [FIXTURE])
    ctx = harness.Context(bench, "tiny_dense.graph", 2147483999, dev)
    run = ctx.driver().Run(ctx)
    run.setup()
    run.window(0.5)
    run.trace()
    run.release()
    before = metrics.snapshot()
    got = labels.launches(run)
    tr = run.traffic
    assert got["maps"] and \
        len(got["launches"]) == tr["trace_calls"] * tr["epochs_per_call"]
    by_label, total = labels.seconds_by_label(got)
    assert set(by_label) == {"gradient", "direction", "guard", "update",
                             "boundary", "infos", "copy_back"}
    assert sum(by_label.values()) == pytest.approx(total)
    shares = [_read(name, run) for name in (
        "gradient_share_pct", "update_share_pct", "boundary_share_pct")]
    assert all(0 < v < 100 for v in shares)
    assert metrics.snapshot() == before

