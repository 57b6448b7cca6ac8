"""The torch port's single-dispatch programs against the JAX package's.

``FusedTrainer.jit_epoch``, ``jit_epochs`` (a scalar step and a
``[nepochs]`` schedule) and ``jit_epochs_scheduled`` against the JAX
package's own ``jit_*`` on ``test_fused.py``'s quadratic (gradient
``A (x - mean(batch))``), in float64 on both sides: SQN, adaQN and
oLBFGS, block and interleaved pairs (adaQN has no interleaved layout),
``aligned`` True, False and None, ``B % upd_freq != 0`` and a state
resumed mid-round.  ``x``, the pair rows and ``x_sum`` within rtol 1e-9
(atol 1e-12: each side sums in its own order), the infos and ``niter``
exactly.  Then ``donate`` (``test_fused.py:304-340``'s two cases) and a
second call on one trainer with another step.

On the CPU the programs run the eager loop.  The graph driver of
``stochqn_tpu_torch.graphs`` (the static buffers, the copies into them
and back, the cache by layout and start phase, ``donate``) is driven here
too, with a stand-in for the capture that runs the epoch at each replay
on the same buffers: the same bits as the eager loop.  The capture itself
runs only on the card (``test_torch_graphs_cuda.py``).
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core import config as jcfg  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               OLBFGSConfig, SQNConfig, graphs)
from stochqn_tpu_torch.graphs import copy_tree, flatten  # noqa: E402
import torch_dist_worker as tw  # noqa: E402

RTOL, ATOL = 1e-9, 1e-12
L = 4
KINDS = ["oLBFGS", "SQN", "adaQN"]
# (optimizer, interleaved pairs)
LAYOUTS = [("oLBFGS", False), ("oLBFGS", True), ("SQN", False),
           ("SQN", True), ("adaQN", False)]
F64 = torch.float64


def _quad(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T


def _trainers(kind, interleaved, a, **trainer_kw):
    """The JAX package's trainer and the port's, on one problem."""
    ja, ta = jnp.asarray(a), torch.from_numpy(a)

    def jgrad(x, batch):
        return ja @ (x - jnp.mean(batch, axis=0))

    def jobj(x, batch):
        r = x - jnp.mean(batch, axis=0)
        return 0.5 * r @ ja @ r

    def tgrad(x, batch):
        return ta @ (x - torch.mean(batch, dim=0))

    def tobj(x, batch):
        r = x - torch.mean(batch, dim=0)
        return 0.5 * r @ ta @ r
    kw = dict(mem_size=3)
    if interleaved:
        kw["pairs_interleaved"] = True
    if kind == "oLBFGS":
        jc, tc = (jcfg.OLBFGSConfig.create(**kw),
                  OLBFGSConfig.create(**kw))
    elif kind == "SQN":
        jc, tc = (jcfg.SQNConfig.create(bfgs_upd_freq=L, **kw),
                  SQNConfig.create(bfgs_upd_freq=L, **kw))
    else:
        jc, tc = (jcfg.AdaQNConfig.create(bfgs_upd_freq=L, max_incr=1.01,
                                          **kw),
                  AdaQNConfig.create(bfgs_upd_freq=L, max_incr=1.01, **kw))
    obj = kind == "adaQN"
    return (JaxTrainer(kind, jc, jgrad, obj_fn=jobj if obj else None),
            FusedTrainer(kind, tc, tgrad, obj_fn=tobj if obj else None,
                         **trainer_kw))


def _torch_trainer(kind, a, **kw):
    return _trainers(kind, False, a, **kw)[1]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _check(tst, tinfos, jst, jinfos):
    assert tuple(tinfos.shape) == tuple(jinfos.shape)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert int(tst.niter) == int(jst.niter)
    assert int(tst.mem.count) == int(jst.mem.count)
    _close(tst.x, jst.x, "x")
    _close(tst.mem.s, jst.mem.s, "mem.s")
    _close(tst.mem.y, jst.mem.y, "mem.y")
    if hasattr(jst, "x_sum"):
        _close(tst.x_sum, jst.x_sum, "x_sum")


def _same_bits(a, b):
    la, sa = flatten(a)
    lb, sb = flatten(b)
    assert sa == sb
    for ta, tb in zip(la, lb):
        assert torch.equal(ta, tb)


def _data(rng, B, bs, n):
    c = rng.standard_normal((B, bs, n))
    return jnp.asarray(c), torch.from_numpy(c)


def _init(jtr, ttr, n):
    return jtr.init(jnp.zeros(n)), ttr.init(torch.zeros(n, dtype=F64))


@pytest.mark.parametrize("kind,interleaved", LAYOUTS)
@pytest.mark.parametrize("aligned", [True, False, None])
@pytest.mark.parametrize("schedule", [False, True])
def test_jit_epochs_matches_jax(rng, kind, interleaved, aligned, schedule):
    """Three epochs over the same batches in one program, ``B % L == 0``,
    a scalar step or a ``[nepochs]`` schedule."""
    n, B, bs, E = 8, 12, 2, 3
    jtr, ttr = _trainers(kind, interleaved, _quad(rng, n))
    jd, td = _data(rng, B, bs, n)
    steps = np.array([0.05, 0.03, 0.02]) if schedule else 0.05
    jst, tst = _init(jtr, ttr, n)
    jst, jinfos = jtr.jit_epochs()(
        jst, jd, jnp.asarray(steps) if schedule else steps, nepochs=E,
        aligned=aligned)
    tst, tinfos = ttr.jit_epochs()(
        tst, td, torch.from_numpy(steps) if schedule else steps, E,
        aligned=aligned)
    _check(tst, tinfos, jst, jinfos)


@pytest.mark.parametrize("kind,interleaved", LAYOUTS)
@pytest.mark.parametrize("aligned", [False, None])
@pytest.mark.parametrize("resumed", [False, True])
def test_jit_epochs_ragged_matches_jax(rng, kind, interleaved, aligned,
                                       resumed):
    """``B % L != 0`` (10 batches, L = 4: every epoch starts at another
    phase), from a fresh state or one resumed mid-round (5 batches in)."""
    n, B, bs, E = 8, 10, 2, 3
    jtr, ttr = _trainers(kind, interleaved, _quad(rng, n))
    jd, td = _data(rng, B, bs, n)
    jst, tst = _init(jtr, ttr, n)
    if resumed:
        jst, _ = jtr.jit_epoch()(jst, jd[:5], 0.05, aligned=None)
        tst, _ = ttr.jit_epoch()(tst, td[:5], 0.05, aligned=None)
        assert int(tst.niter) == int(jst.niter) == 5
    jst, jinfos = jtr.jit_epochs()(jst, jd, 0.04, nepochs=E, aligned=aligned)
    tst, tinfos = ttr.jit_epochs()(tst, td, 0.04, E, aligned=aligned)
    _check(tst, tinfos, jst, jinfos)


@pytest.mark.parametrize("kind,interleaved", LAYOUTS)
@pytest.mark.parametrize("aligned", [True, None])
def test_jit_epoch_matches_jax(rng, kind, interleaved, aligned):
    """Two calls of one trainer's ``jit_epoch`` with two step sizes: the
    second follows its step, as the JAX package's does."""
    n, B, bs = 8, 12, 2
    jtr, ttr = _trainers(kind, interleaved, _quad(rng, n))
    jd, td = _data(rng, B, bs, n)
    jst, tst = _init(jtr, ttr, n)
    jfn, tfn = jtr.jit_epoch(), ttr.jit_epoch()
    assert ttr.jit_epoch() is tfn                 # cached on the trainer
    for eta in (0.05, 0.02):
        jst, jinfos = jfn(jst, jd, eta, aligned=aligned)
        tst, tinfos = tfn(tst, td, eta, aligned=aligned)
        _check(tst, tinfos, jst, jinfos)


@pytest.mark.parametrize("kind,interleaved", LAYOUTS)
@pytest.mark.parametrize("aligned", [True, False])
def test_jit_epochs_scheduled_matches_jax(rng, kind, interleaved, aligned):
    """Three epochs, each on its own row order and step size."""
    n, B, bs, E = 8, 12, 2, 3
    jtr, ttr = _trainers(kind, interleaved, _quad(rng, n))
    rows = rng.standard_normal((B * bs, n))
    orders = np.stack([np.random.RandomState(7 + e).permutation(B * bs)
                       for e in range(E)])
    steps = np.array([0.05, 0.035, 0.03])
    jst, tst = _init(jtr, ttr, n)
    jst, jinfos = jtr.jit_epochs_scheduled()(
        jst, jnp.asarray(rows), jnp.asarray(steps),
        jnp.asarray(orders, jnp.int32), batch_size=bs, aligned=aligned)
    tst, tinfos = ttr.jit_epochs_scheduled()(
        tst, torch.from_numpy(rows), torch.from_numpy(steps),
        torch.from_numpy(orders), bs, aligned=aligned)
    _check(tst, tinfos, jst, jinfos)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("donate", [False, True])
def test_jit_epochs_matches_epoch_loop(rng, kind, donate):
    """``jit_epochs`` gives ``run_epochs``'s trajectory and infos, with
    either ``donate``; without donation the state passed in is left as it
    was (``test_fused.py::test_jit_epochs_matches_epoch_loop``)."""
    n, B, bs = 8, 12, 2
    a = _quad(rng, n)
    centers = torch.from_numpy(rng.standard_normal((B, bs, n)))
    loop = _torch_trainer(kind, a)
    st_l, infos_l = loop.run_epochs(loop.init(torch.zeros(n, dtype=F64)),
                                    centers, 3, 0.05)
    one = _torch_trainer(kind, a, donate=donate)
    st_in = one.init(torch.zeros(n, dtype=F64))
    before = copy_tree(st_in)
    st_o, infos_o = one.jit_epochs()(st_in, centers, 0.05, nepochs=3,
                                     aligned=True)
    assert infos_o.shape == infos_l.shape == (3, B)
    assert torch.equal(infos_o, infos_l)
    _same_bits(st_o, st_l)
    if not donate:
        _same_bits(st_in, before)


@pytest.mark.parametrize("kind", KINDS)
def test_donated_epoch_trajectory_identical(rng, kind):
    """Donation changes no bit, and the donated state is consumed: the
    result shares its pair rows (updated in place), where without
    donation the passed-in state keeps its own values
    (``test_fused.py::test_donated_epoch_trajectory_identical``)."""
    n, B, bs = 8, 12, 2
    a = _quad(rng, n)
    centers = torch.from_numpy(rng.standard_normal((B, bs, n)))
    kept = _torch_trainer(kind, a)
    donated = _torch_trainer(kind, a, donate=True)
    s_kept = kept.init(torch.zeros(n, dtype=F64))
    s_don = donated.init(torch.zeros(n, dtype=F64))
    out_k, inf_k = kept.jit_epoch()(s_kept, centers, 0.05)
    out_d, inf_d = donated.jit_epoch()(s_don, centers, 0.05)
    assert torch.equal(inf_k, inf_d)
    _same_bits(out_k, out_d)
    assert out_d.mem.s.data_ptr() == s_don.mem.s.data_ptr()
    assert out_k.mem.s.data_ptr() != s_kept.mem.s.data_ptr()
    assert int(s_kept.niter) == 0 and not s_kept.mem.s.any()
    # run_epochs follows donate in the same way
    s_kept2 = kept.init(torch.zeros(n, dtype=F64))
    kept.run_epochs(s_kept2, centers, 2, 0.05)
    assert int(s_kept2.niter) == 0 and not s_kept2.mem.s.any()


def test_jit_on_a_cuda_mesh_raises(rng):
    """A CUDA mesh over gloo: gloo's collectives run on the host and cannot
    be captured, so every ``jit_*`` of a trainer on it raises, naming gloo
    and the eager drivers (``eager_only``); a CPU (gloo) mesh takes the
    eager loop (``test_torch_no_jax.py``), an NCCL mesh the graphs (the
    next test)."""
    tr = _torch_trainer("SQN", _quad(rng, 4))
    tr.mesh = types.SimpleNamespace(device_type="cuda")
    tr._comm = types.SimpleNamespace(capturable=False)
    assert tr.eager_only
    for get in (tr.jit_epoch, tr.jit_epochs, tr.jit_epochs_scheduled):
        with pytest.raises(RuntimeError, match=r"gloo.*epoch\(\) / "
                           r"epochs\(\) / epochs_scheduled\(\)"):
            get()


class _OneRankNccl:
    """A one-rank mesh whose groups report NCCL: every sum the identity."""
    n_data = n_param = 1
    data_rank = param_rank = 0
    capturable = True

    def sum_param(self, parts, label):
        return tuple(parts)

    def sum_data(self, t, label):
        return t.clone()

    def gather_param(self, parts, label):
        return tuple(parts)

    def param_slice(self, full):
        return full


@pytest.mark.parametrize("kind", KINDS)
def test_jit_on_an_nccl_mesh_takes_the_graph_path(rng, replayed, kind):
    """A CUDA mesh whose groups are NCCL: ``jit_epochs`` runs the graph
    driver (one family, keyed by the mesh's shape and this rank's place,
    one graph), with the eager epochs' bits on the same mesh."""
    n, B, bs = 8, 12, 2
    a = _quad(rng, n)
    data = torch.from_numpy(rng.standard_normal((B, bs, n)))
    tr, eager = _torch_trainer(kind, a), _torch_trainer(kind, a)
    s0, r0 = (t.init(torch.zeros(n, dtype=F64)) for t in (tr, eager))
    for t in (tr, eager):
        t.mesh = types.SimpleNamespace(device_type="cuda")
        t._comm = _OneRankNccl()
    assert not tr.eager_only
    st, infos = tr.jit_epochs()(s0, data, 0.05, 2)
    ref, ref_infos = eager.epochs(r0, data, 0.05, 2)
    assert torch.equal(infos, ref_infos)
    _same_bits(st, ref)
    (key,) = tr._programs.families
    assert key[-1] == (1, 1, 0, 0)
    assert len(tr._programs.graphs()) == 1


def test_capture_error_names_the_user_function(rng):
    """A failure inside the user's function during a capture is raised
    with the function's role, name and line."""
    def my_grad(x, batch):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=2, bfgs_upd_freq=2),
                      my_grad)
    try:
        my_grad(None, None)
    except RuntimeError as err:
        msg = str(graphs._capture_error(tr, err))
    assert "grad_fn 'my_grad'" in msg and "test_torch_jit_epochs.py" in msg
    assert "SQN epoch in a CUDA graph failed" in msg


# -- the graph driver, with a stand-in for the capture ------------------------ #
# In place of graphs._Graph on the CPU: each replay runs the epoch on the
# family's buffers and writes its state back, as the captured graph does.
_Replayed = tw.ReplayedGraph


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _Replayed)
    monkeypatch.setattr(graphs, "captures", lambda state: True)


@pytest.mark.parametrize("kind,interleaved", LAYOUTS)
@pytest.mark.parametrize("B", [12, 10])
def test_graph_driver_matches_eager(rng, replayed, kind, interleaved, B):
    """The graph driver gives the eager loop's bits over three epochs and a
    fourth call with another step and fresh data, with one graph per
    layout and start phase met: one for oLBFGS and for ``B % L == 0``,
    phases 0 and 2 for ``B = 10``."""
    n, bs = 8, 2
    a = _quad(rng, n)
    d1 = torch.from_numpy(rng.standard_normal((B, bs, n)))
    d2 = torch.from_numpy(rng.standard_normal((B, bs, n)))
    tr = _trainers(kind, interleaved, a)[1]
    eager = _trainers(kind, interleaved, a)[1]
    st, infos = tr.jit_epochs()(tr.init(torch.zeros(n, dtype=F64)), d1, 0.05,
                                3)
    ref, ref_infos = eager.epochs(eager.init(torch.zeros(n, dtype=F64)), d1,
                                  0.05, 3)
    assert torch.equal(infos, ref_infos)
    _same_bits(st, ref)
    st, infos = tr.jit_epoch()(st, d2, 0.02)
    ref, ref_infos = eager.epoch(ref, d2, 0.02)
    assert torch.equal(infos, ref_infos)
    _same_bits(st, ref)
    layouts = sorted(k for f in tr._programs.families.values()
                     for k in f.graphs)
    want = ([(False, 0)] if kind == "oLBFGS" or B % L == 0
            else [(True, 0), (True, 2)])
    assert layouts == want


@pytest.mark.parametrize("kind", KINDS)
def test_graph_driver_buffers_and_donate(rng, replayed, kind):
    """The static buffers: without donation the caller's state is copied in
    and the result is a copy of the buffers; with it the result is the
    buffers, and passing it back copies nothing.  The data is copied
    once, and again after the caller modifies it in place."""
    n, B, bs = 8, 12, 2
    a = _quad(rng, n)
    data = torch.from_numpy(rng.standard_normal((B, bs, n)))
    tr = _torch_trainer(kind, a)
    s0 = tr.init(torch.zeros(n, dtype=F64))
    before = copy_tree(s0)
    s1, _ = tr.jit_epoch()(s0, data, 0.05)
    _same_bits(s0, before)
    (fam,) = tr._programs.families.values()
    assert s1.x is not fam.state[0] and torch.equal(s1.x, fam.state[0])
    state_bytes = sum(t.nbytes for t in fam.state)
    assert fam.copy_in_bytes == state_bytes + data.nbytes

    tr.donate = True
    s2, _ = tr.jit_epoch()(s1, data, 0.05)
    assert fam.copy_in_bytes == 2 * state_bytes + data.nbytes
    assert all(a is b for a, b in zip(flatten(s2)[0], fam.state))
    s3, _ = tr.jit_epoch()(s2, data, 0.05)          # nothing copied in
    assert fam.copy_in_bytes == 2 * state_bytes + data.nbytes
    data.mul_(1.0)                                  # a new version
    tr.jit_epoch()(s3, data, 0.05)
    assert fam.copy_in_bytes == 2 * state_bytes + 2 * data.nbytes

    eager = _torch_trainer(kind, a)
    ref = eager.init(torch.zeros(n, dtype=F64))
    for _ in range(4):
        ref, _ = eager.epoch(ref, data, 0.05)
    _same_bits(s3, ref)


def test_graph_driver_scheduled_matches_eager(rng, replayed):
    """``jit_epochs_scheduled`` on the driver: each epoch's order and step
    copied in, the gather inside the epoch; the eager bits."""
    n, B, bs, E = 8, 10, 2, 3
    a = _quad(rng, n)
    rows = torch.from_numpy(rng.standard_normal((B * bs, n)))
    orders = torch.stack([torch.from_numpy(
        np.random.RandomState(e).permutation(B * bs)) for e in range(E)])
    steps = torch.tensor([0.05, 0.04, 0.03], dtype=F64)
    tr, eager = _torch_trainer("SQN", a), _torch_trainer("SQN", a)
    st, infos = tr.jit_epochs_scheduled()(
        tr.init(torch.zeros(n, dtype=F64)), rows, steps, orders, bs)
    ref, ref_infos = eager.epochs_scheduled(
        eager.init(torch.zeros(n, dtype=F64)), rows, steps, orders, bs)
    assert torch.equal(infos, ref_infos)
    _same_bits(st, ref)


def test_write_back_stages_aliased_outputs(rng, replayed):
    """Inside the capture the output state goes back into the buffers: a
    field updated in place stays, one that is another field's buffer is
    staged first (swapping two fields must not read a field already
    overwritten), and the bytes copied are counted."""
    tr = _torch_trainer("SQN", _quad(rng, 4))
    st = tr.init(torch.arange(4, dtype=F64))
    st.x_sum.fill_(7.0)
    programs = graphs.EpochPrograms(tr)
    fam = programs.family("batched", st, torch.zeros(2, 1, 4), F64, None)
    fam.load(st, torch.zeros(2, 1, 4), torch.tensor(0.1, dtype=F64))
    buf = fam.state_tree()
    out = buf.replace(x=buf.x_sum, x_sum=buf.x)      # a swap
    nbytes = fam.write_back(out)
    assert nbytes == 2 * buf.x.nbytes
    assert torch.equal(fam.state_tree().x, torch.full((4,), 7.0, dtype=F64))
    assert torch.equal(fam.state_tree().x_sum,
                       torch.arange(4, dtype=F64))
    with pytest.raises(RuntimeError, match="another layout"):
        fam.write_back(buf.replace(x=buf.x[:2]))
