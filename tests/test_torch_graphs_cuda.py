"""The single-dispatch programs on the card: CUDA graphs against the eager
loop, bit for bit.

``FusedTrainer.jit_epochs`` / ``jit_epoch`` / ``jit_epochs_scheduled``
capture an epoch in a CUDA graph and replay it
(:mod:`stochqn_tpu_torch.graphs`); the eager ``epochs`` runs the same ops
one dispatch at a time.  On a small multinomial logistic problem (12
features, 5 classes, float32) each optimizer's graph must give the eager
loop's every bit and info code, and launch each kernel as often: SQN on
``direction`` in block and interleaved layout, adaQN on
``project_adaqn`` and on the matvec route, oLBFGS in block and interleaved
(shift) layout.  Then: a second call with another step on the cached
graph follows the step, the generic layout meets one graph per start
phase, the warm-up leaves the caller's state as it was, a host read in
the user's gradient raises at capture, naming the function, and a second
fused ``StochasticLogisticRegression`` fit of one shape replays the
first's graph with its own penalty.

This file imports no JAX: run it on the machine with the card,
``python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py``.
On the CPU every case skips (the CPU tests of the programs are
``test_torch_jit_epochs.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer, OLBFGSConfig,
                               SQNConfig, graphs)
from stochqn_tpu_torch.models import losses
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk

F, C, BS, M, L, REG, ETA = 12, 5, 4, 3, 4, 0.1, 0.05
CASES = {
    "sqn": ("SQN", dict(bfgs_upd_freq=L)),
    "sqn_interleaved": ("SQN", dict(bfgs_upd_freq=L, pairs_interleaved=True)),
    "adaqn_kernel": ("adaQN", dict(bfgs_upd_freq=L, fisher_size=6,
                                   use_pallas=True)),
    "adaqn_matvec": ("adaQN", dict(bfgs_upd_freq=L, fisher_size=6)),
    "olbfgs": ("oLBFGS", {}),
    "olbfgs_interleaved": ("oLBFGS", dict(pairs_interleaved=True)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs of the CUDA kernels; "
                    "runs on the card only)")
    return torch.device("cuda")


def _grad(x, b):
    return losses.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _obj(x, b):
    return losses.multinomial_logistic_loss(x, b[0], b[1], None, REG)


def _trainer(case, **kw):
    kind, cfg_kw = CASES[case]
    cfg = {"SQN": SQNConfig, "adaQN": AdaQNConfig,
           "oLBFGS": OLBFGSConfig}[kind].create(mem_size=M, **cfg_kw)
    return FusedTrainer(kind, cfg, _grad,
                        obj_fn=_obj if kind == "adaQN" else None, **kw)


def _problem(dev, nb):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((nb, BS, F)).astype(np.float32)
    Y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (nb, BS))]
    x0 = (0.1 * rng.standard_normal((F + 1) * C)).astype(np.float32)
    return (torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)), \
        torch.from_numpy(x0).to(dev)


def assert_same_bits(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            assert_same_bits(va, vb)
        elif isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _launches():
    torch.cuda.synchronize()
    return dict(tlk.read_launches())


def _diff(after, before):
    return {k: v - before[k] for k, v in after.items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("nb", [8, 10])
def test_graph_equals_eager(dev, case, nb):
    """Three epochs: the same bits and infos, and the kernels' launches of
    the eager run equal the launches the replays count (B = 10 meets
    start phases 0 and 2, one graph each)."""
    data, x0 = _problem(dev, nb)
    eager, graphed = _trainer(case), _trainer(case)
    before = _launches()
    ref, ref_infos = eager.epochs(eager.init(x0), data, ETA, 3)
    eager_launches = _diff(_launches(), before)
    graphs.reset_stats()
    state, infos = graphed.jit_epochs()(graphed.init(x0), data, ETA, 3)
    torch.cuda.synchronize()
    assert torch.equal(infos, ref_infos)
    assert_same_bits(state, ref)
    assert graphs.STATS["replays"] == 3
    assert graphs.STATS["replay_launches"] == eager_launches
    if CASES[case][0] == "SQN":
        assert eager_launches == {"DIRECTION_LAUNCHES": 3 * nb}
    if case == "adaqn_kernel":
        assert eager_launches == {"PROJECT_ADAQN_LAUNCHES": 3 * nb}
    phases = 2 if nb % L and CASES[case][0] != "oLBFGS" else 1
    assert graphs.STATS["captures"] == len(graphed._programs.graphs()) \
        == phases


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sqn", "adaqn_kernel", "olbfgs"])
def test_step_change_on_cached_graph(dev, case):
    """A second call with another step replays the cached graph (no new
    capture) and follows the step: the eager bits at 0.05 then 0.02."""
    data, x0 = _problem(dev, 8)
    eager, graphed = _trainer(case), _trainer(case)
    fn = graphed.jit_epoch()
    state, _ = fn(graphed.init(x0), data, 0.05)
    captures = len(graphed._programs.graphs())
    state, infos = fn(state, data, 0.02)
    ref, _ = eager.epoch(eager.init(x0), data, 0.05)
    ref, ref_infos = eager.epoch(ref, data, 0.02)
    torch.cuda.synchronize()
    assert len(graphed._programs.graphs()) == captures == 1
    assert torch.equal(infos, ref_infos)
    assert_same_bits(state, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [False, True])
def test_warm_up_leaves_the_callers_state(dev, donate):
    """The first call warms up and captures: with donate=False on a
    scratch copy, the state passed in is unchanged, and the result is one
    epoch from it, not two.  With donate=True the state passed in becomes
    the graph's buffers and the warm-up is the first call's epoch; the
    result is those buffers, which the next call takes without a copy."""
    data, x0 = _problem(dev, 8)
    eager, graphed = _trainer("sqn"), _trainer("sqn", donate=donate)
    s0 = graphed.init(x0)
    kept = graphs.copy_tree(s0)
    s1, _ = graphed.jit_epochs()(s0, data, ETA, 1)
    ref, _ = eager.epochs(eager.init(x0), data, ETA, 1)
    torch.cuda.synchronize()
    assert_same_bits(s1, ref)
    if not donate:
        assert_same_bits(s0, kept)
    (fam,) = graphed._programs.families.values()
    owned = all(a is b for a, b in zip(graphs.flatten(s1)[0], fam.state))
    assert owned == donate
    copied = fam.copy_in_bytes
    s2, _ = graphed.jit_epochs()(s1, data, ETA, 1)
    state_bytes = sum(t.nbytes for t in fam.state)
    assert fam.copy_in_bytes == copied + (0 if donate else state_bytes)
    ref, _ = eager.epochs(ref, data, ETA, 1)
    torch.cuda.synchronize()
    assert_same_bits(s2, ref)


@pytest.mark.cuda
def test_scheduled_equals_eager(dev):
    """``jit_epochs_scheduled``: the gather inside the graph, each epoch's
    order and step copied in; the eager ``epochs_scheduled``'s bits."""
    data, x0 = _problem(dev, 8)
    flat = tuple(a.reshape(8 * BS, -1) for a in data)
    gen = torch.Generator(device=dev).manual_seed(0)
    orders = torch.stack([torch.randperm(8 * BS, generator=gen, device=dev)
                          for _ in range(3)])
    steps = torch.tensor([0.05, 0.04, 0.03], device=dev)
    eager, graphed = _trainer("sqn"), _trainer("sqn")
    state, infos = graphed.jit_epochs_scheduled()(graphed.init(x0), flat,
                                                  steps, orders, BS)
    ref, ref_infos = eager.epochs_scheduled(eager.init(x0), flat, steps,
                                            orders, BS)
    torch.cuda.synchronize()
    assert torch.equal(infos, ref_infos)
    assert_same_bits(state, ref)


@pytest.mark.cuda
def test_host_read_raises_at_capture(dev):
    """A gradient that reads the device on the host cannot be captured: the
    call raises, naming the function, with no eager fallback; a capture
    after it works."""
    data, x0 = _problem(dev, 8)

    def grad_with_host_read(x, b):
        if float(x.abs().sum()) > 1e9:
            return torch.zeros_like(x)
        return _grad(x, b)
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=M, bfgs_upd_freq=L),
                      grad_with_host_read)
    with pytest.raises(RuntimeError, match="grad_with_host_read"):
        tr.jit_epochs()(tr.init(x0), data, ETA, 1)
    ok = _trainer("sqn")
    state, _ = ok.jit_epochs()(ok.init(x0), data, ETA, 1)
    torch.cuda.synchronize()
    assert int(state.niter) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("valset_frac", [None, 0.25])
def test_fused_fit_of_one_shape_replays_the_first_capture(dev, valset_frac):
    """A second fused fit of one shape, with another ``reg_param`` and
    ``random_state``, warms up and captures nothing, and gives the bits of
    the same fit from an empty cache.  With ``valset_frac`` the split's
    rows make a shape of their own, whose trainer the first fit of that
    shape captures."""
    from stochqn_tpu_torch import StochasticLogisticRegression
    from stochqn_tpu_torch.models import logistic
    rng = np.random.default_rng(2)
    X = rng.standard_normal((160, F))
    Y = np.eye(C)[rng.integers(0, C, 160)]

    def fit(reg, rs, valset_frac):
        return StochasticLogisticRegression(
            reg_param=reg, random_state=rs, optimizer="SQN", engine="fused",
            step_size=0.05, valset_frac=valset_frac, nepochs=3,
            batches_per_epoch=8, mem_size=M, bfgs_upd_freq=L,
            device=dev).fit(X, Y)

    logistic.clear_fit_programs()
    fit(0.1, 1, None)
    if valset_frac is not None:
        graphs.reset_stats()
        fit(0.1, 1, valset_frac)
        assert graphs.STATS["captures"] > 0
    graphs.reset_stats()
    second = fit(1e-2, 2, valset_frac)
    torch.cuda.synchronize()
    assert graphs.STATS["captures"] == 0 and graphs.STATS["warm_s"] == 0.0
    assert graphs.STATS["replays"] > 0
    assert len(logistic._PROGRAMS) == (1 if valset_frac is None else 2)
    logistic.clear_fit_programs()
    again = fit(1e-2, 2, valset_frac)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(second.coef_, again.coef_)
    logistic.clear_fit_programs()


def _fit_logistic(dev, **kw):
    from stochqn_tpu_torch import StochasticLogisticRegression
    rng = np.random.default_rng(3)
    X = rng.standard_normal((160, F))
    Y = np.eye(C)[rng.integers(0, C, 160)]
    return StochasticLogisticRegression(
        **dict(dict(optimizer="SQN", engine="fused", step_size=0.05,
                    valset_frac=None, nepochs=2, batches_per_epoch=8,
                    mem_size=M, bfgs_upd_freq=L, device=dev), **kw)).fit(X, Y)


@pytest.mark.cuda
def test_fused_fit_programs_hold_one_family_each(dev):
    """Fused fits over five ``batches_per_epoch``: the cache keeps the
    four shapes used last, each trainer with the one family of graphs and
    buffers its shape captured."""
    from stochqn_tpu_torch.models import logistic
    logistic.clear_fit_programs()
    for batches in (2, 4, 5, 8, 10):
        _fit_logistic(dev, batches_per_epoch=batches)
    torch.cuda.synchronize()
    kept = list(logistic._PROGRAMS.values())
    assert len(kept) == 4
    assert [len(trainer._programs.families) for trainer, _ in kept] == [1] * 4
    logistic.clear_fit_programs()


@pytest.mark.cuda
def test_fused_fits_on_two_cards_keep_a_program_each(dev):
    """Fits with the default device under ``torch.cuda.device(0)`` and
    then ``(1)``: each card builds its own program, whose penalty lies on
    it, and gives the bits of the same fit from an empty cache; a second
    fit on card 0 reuses card 0's program."""
    from stochqn_tpu_torch.models import logistic
    from stochqn_tpu_torch.utils import metrics
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (one program a card)")
    logistic.clear_fit_programs()
    metrics.reset()
    with torch.cuda.device(0):
        _fit_logistic(dev, reg_param=0.1, random_state=1)
    with torch.cuda.device(1):
        on_1 = _fit_logistic(dev, reg_param=1e-2, random_state=2)
        assert on_1._fused_state.x.device == torch.device("cuda", 1)
    with torch.cuda.device(0):
        on_0 = _fit_logistic(dev, reg_param=1e-2, random_state=2)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    counters = metrics.snapshot()["counters"]
    assert (counters["fit_programs_built"],
            counters["fit_programs_reused"]) == (2, 1)
    assert sorted(p.device.index for _, p in logistic._PROGRAMS.values()) \
        == [0, 1]
    logistic.clear_fit_programs()
    with torch.cuda.device(1):
        again = _fit_logistic(dev, reg_param=1e-2, random_state=2)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(on_1.coef_, again.coef_)
    with torch.cuda.device(0):
        logistic.clear_fit_programs()
        again = _fit_logistic(dev, reg_param=1e-2, random_state=2)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(on_0.coef_, again.coef_)
    logistic.clear_fit_programs()
    metrics.reset()
