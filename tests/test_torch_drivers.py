"""The torch port's epoch drivers against the JAX package's.

``FusedTrainer.epochs_scheduled`` (precomputed row orders and step sizes)
against ``jit_epochs_scheduled`` on the same orders, ``run_epochs`` with a
``decr_step_size`` schedule against the JAX ``run_epochs``, the shuffle
driver against the scheduled one on the permutations it drew (inside the
port: torch's and JAX's random streams differ), and oLBFGS with
``paired_grads`` against the sequential layout and against the JAX
package's paired epoch.

The problem is ``test_fused.py``'s quadratic (n = 8 or 10, gradient
``A (x - mean(batch))``), in float64 on both sides.  Tolerances: the
port against the JAX package, rtol 1e-9 and atol 1e-12 (float64, each
side summing in its own order); the shuffle driver against the scheduled
one, bit for bit (the same gathers and the same ops); paired against
sequential, ``test_fused.py``'s rtol 1e-6 and atol 1e-9 (the batched
gradient sums in another order).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core import config as jcfg  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               OLBFGSConfig, SQNConfig)
from stochqn_tpu_torch.fused import shuffle_batched  # noqa: E402
from stochqn_tpu_torch.utils.schedules import step_size_sqrt  # noqa: E402

RTOL, ATOL = 1e-9, 1e-12
PAIRED_RTOL, PAIRED_ATOL = 1e-6, 1e-9
KINDS = ["oLBFGS", "SQN", "adaQN"]


def _quad(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T


def _funs(a):
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
    return (jgrad, jobj), (tgrad, tobj)


def _configs(kind, **kw):
    L = 4
    if kind == "oLBFGS":
        kw = dict(mem_size=3, **kw)
        return jcfg.OLBFGSConfig.create(**kw), OLBFGSConfig.create(**kw)
    if kind == "SQN":
        kw = dict(mem_size=3, bfgs_upd_freq=L, **kw)
        return jcfg.SQNConfig.create(**kw), SQNConfig.create(**kw)
    kw = dict(mem_size=3, bfgs_upd_freq=L, max_incr=1.01, **kw)
    return jcfg.AdaQNConfig.create(**kw), AdaQNConfig.create(**kw)


def _trainers(kind, a, **trainer_kw):
    (jgrad, jobj), (tgrad, tobj) = _funs(a)
    jc, tc = _configs(kind)
    obj = kind == "adaQN"
    return (JaxTrainer(kind, jc, jgrad, obj_fn=jobj if obj else None,
                       **trainer_kw),
            FusedTrainer(kind, tc, tgrad, obj_fn=tobj if obj else None,
                         **trainer_kw))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _assert_states_close(tst, jst):
    _close(tst.x, jst.x, what="x")
    _close(tst.mem.s, jst.mem.s, what="mem.s")
    _close(tst.mem.y, jst.mem.y, what="mem.y")
    assert int(tst.mem.count) == int(jst.mem.count)
    assert int(tst.mem.head) == int(jst.mem.head)
    assert int(tst.niter) == int(jst.niter)


@pytest.mark.parametrize("kind", KINDS)
def test_epochs_scheduled_matches_jax(rng, kind):
    """Three epochs, each on its own row order and step size
    (``test_fused.py::test_jit_epochs_scheduled_matches_manual_gather``'s
    schedule), on both sides."""
    n, B, bs, E = 8, 12, 2, 3
    a = _quad(rng, n)
    rows = rng.standard_normal((B * bs, n))
    orders = np.stack([np.random.RandomState(7 + e).permutation(B * bs)
                       for e in range(E)])
    steps = np.asarray([step_size_sqrt(0.05, e) for e in range(E)])
    jtr, ttr = _trainers(kind, a)
    jst, jinfos = jtr.jit_epochs_scheduled()(
        jtr.init(jnp.zeros(n)), jnp.asarray(rows), jnp.asarray(steps),
        jnp.asarray(orders, jnp.int32), batch_size=bs, aligned=True)
    tst, tinfos = ttr.epochs_scheduled(
        ttr.init(torch.zeros(n, dtype=torch.float64)),
        torch.from_numpy(rows), torch.from_numpy(steps),
        torch.from_numpy(orders), batch_size=bs)
    assert tinfos.shape == (E, B)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    _assert_states_close(tst, jst)
    assert int(tst.niter) == E * B


def test_epochs_scheduled_misaligned_batches_match_jax(rng):
    """B = 10 batches per scheduled epoch with L = 4: every epoch after the
    first starts mid-round, and the host count carries it across."""
    n, B, bs, E = 8, 10, 2, 3
    a = _quad(rng, n)
    rows = rng.standard_normal((B * bs + 3, n))   # 3 rows never gathered
    orders = np.stack([rng.permutation(B * bs + 3)[:B * bs]
                       for _ in range(E)])
    jtr, ttr = _trainers("SQN", a)
    jst, jinfos = jtr.jit_epochs_scheduled()(
        jtr.init(jnp.zeros(n)), jnp.asarray(rows), jnp.full(E, 0.05),
        jnp.asarray(orders, jnp.int32), batch_size=bs)
    tst, tinfos = ttr.epochs_scheduled(
        ttr.init(torch.zeros(n, dtype=torch.float64)),
        torch.from_numpy(rows), 0.05, torch.from_numpy(orders),
        batch_size=bs)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    _assert_states_close(tst, jst)


def test_epochs_scheduled_rejects_ragged_orders():
    trainer = FusedTrainer("SQN", SQNConfig.create(mem_size=2,
                                                   bfgs_upd_freq=2),
                           lambda x, b: x)
    state = trainer.init(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="multiple of batch_size"):
        trainer.epochs_scheduled(state, torch.zeros(10, 3), 0.1,
                                 torch.zeros((2, 7), dtype=torch.int64),
                                 batch_size=2)


@pytest.mark.parametrize("kind", KINDS)
def test_run_epochs_decr_step_size_matches_jax(rng, kind):
    """``run_epochs`` with the guided driver's schedule hook: both sides
    take ``decr_step_size(step0, epoch)`` per epoch."""
    n, B, bs = 8, 12, 2
    a = _quad(rng, n)
    centers = rng.standard_normal((B, bs, n))
    jtr, ttr = _trainers(kind, a)
    jst, jinfos = jtr.run_epochs(jtr.init(jnp.zeros(n)),
                                 jnp.asarray(centers), 3, 0.05,
                                 decr_step_size=step_size_sqrt)
    tst, tinfos = ttr.run_epochs(ttr.init(torch.zeros(n, dtype=torch.float64)),
                                 torch.from_numpy(centers), 3, 0.05,
                                 decr_step_size=step_size_sqrt)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    _assert_states_close(tst, jst)


@pytest.mark.parametrize("kind", ["SQN", "adaQN"])
def test_run_epochs_resumed_mid_round_matches_jax(rng, kind):
    """``run_epochs`` from a state 3 steps into a round, on B = 10 batches
    with L = 4: ``niter`` is read once and every boundary lands where the
    JAX package's ``lax.cond`` puts it."""
    n, B, bs = 8, 10, 2
    a = _quad(rng, n)
    centers = rng.standard_normal((B, bs, n))
    jtr, ttr = _trainers(kind, a)
    jst, _ = jax.jit(jtr.epoch, static_argnames=("aligned",))(
        jtr.init(jnp.zeros(n)), jnp.asarray(centers[:3]), 0.05,
        aligned=False)
    jst, jinfos = jtr.run_epochs(jst, jnp.asarray(centers), 2, 0.05,
                                 decr_step_size=step_size_sqrt)
    tst, _ = ttr.epoch(ttr.init(torch.zeros(n, dtype=torch.float64)),
                       torch.from_numpy(centers[:3]), 0.05, aligned=False)
    tst, tinfos = ttr.run_epochs(tst, torch.from_numpy(centers), 2, 0.05,
                                 decr_step_size=step_size_sqrt)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    _assert_states_close(tst, jst)
    assert int(tst.niter) == 3 + 2 * B


@pytest.mark.parametrize("kind", KINDS)
def test_run_epochs_shuffle_equals_scheduled(rng, kind):
    """``run_epochs(shuffle=generator)`` is ``epochs_scheduled`` on the
    permutations it drew: one ``randperm`` of the epoch's rows per epoch,
    each applied to the unshuffled data.  The same bits."""
    n, B, bs, E = 8, 12, 2, 3
    a = _quad(rng, n)
    centers = torch.from_numpy(rng.standard_normal((B, bs, n)))
    _, ttr = _trainers(kind, a)
    gen = torch.Generator().manual_seed(11)
    twin = torch.Generator().manual_seed(11)
    sst, sinfos = ttr.run_epochs(ttr.init(torch.zeros(n, dtype=torch.float64)),
                                 centers, E, 0.05,
                                 decr_step_size=step_size_sqrt, shuffle=gen)
    orders = torch.stack([torch.randperm(B * bs, generator=twin)
                          for _ in range(E)])
    steps = torch.tensor([step_size_sqrt(0.05, e) for e in range(E)],
                         dtype=torch.float64)
    qst, qinfos = ttr.epochs_scheduled(
        ttr.init(torch.zeros(n, dtype=torch.float64)),
        centers.reshape(B * bs, n), steps, orders, batch_size=bs)
    assert torch.equal(sinfos, qinfos)
    assert torch.equal(sst.x, qst.x)
    assert torch.equal(sst.mem.s, qst.mem.s)


def test_shuffle_batched_permutes_rows(rng):
    data = {"x": torch.arange(24.0).reshape(4, 3, 2),
            "y": torch.arange(12).reshape(4, 3)}
    out = shuffle_batched(data, torch.Generator().manual_seed(0))
    assert out["x"].shape == (4, 3, 2) and out["y"].shape == (4, 3)
    # rows move together across leaves, and every row is kept once
    np.testing.assert_array_equal(out["x"][..., 0].numpy(),
                                  2 * out["y"].numpy())
    assert sorted(out["y"].flatten().tolist()) == list(range(12))
    assert not torch.equal(out["y"], data["y"])


PAIRED_KW = [
    dict(mem_size=4, min_curvature=1e-4, y_reg=1e-3),
    dict(mem_size=1, hess_init=0.5),
    dict(mem_size=4, min_curvature=0.5),   # forces curvature rejections
]


@pytest.mark.parametrize("kw", PAIRED_KW,
                         ids=["y_reg", "hess_init", "rejects"])
def test_olbfgs_paired_matches_sequential_and_jax(rng, kw):
    """Mirror of ``test_fused.py::test_olbfgs_paired_matches_sequential``:
    the paired epoch gives the sequential epoch's trajectory, memory and
    info codes; and it matches the JAX package's paired epoch."""
    n, B, bs = 10, 12, 3
    a = _quad(rng, n)
    centers = rng.standard_normal((B, bs, n))
    (jgrad, _), (tgrad, _) = _funs(a)
    runs = {}
    for paired in (True, False):
        trainer = FusedTrainer("oLBFGS", OLBFGSConfig.create(**kw), tgrad,
                               paired_grads=paired)
        runs[paired] = trainer.epochs(
            trainer.init(torch.zeros(n, dtype=torch.float64)),
            torch.from_numpy(centers), 0.05, nepochs=2)
    (sp, ip), (ss, is_) = runs[True], runs[False]
    assert torch.equal(ip, is_)
    for name in ("x", "grad_prev", "niter"):
        _close(getattr(sp, name), getattr(ss, name), PAIRED_RTOL,
               PAIRED_ATOL, name)
    _close(sp.mem.s, ss.mem.s, PAIRED_RTOL, PAIRED_ATOL, "mem.s")
    _close(sp.mem.y, ss.mem.y, PAIRED_RTOL, PAIRED_ATOL, "mem.y")
    assert int(sp.mem.head) == int(ss.mem.head)
    assert int(sp.mem.count) == int(ss.mem.count)

    jtr = JaxTrainer("oLBFGS", jcfg.OLBFGSConfig.create(**kw), jgrad,
                     paired_grads=True)
    ep = jax.jit(jtr.epoch)
    jst, jinfos = jtr.init(jnp.zeros(n)), []
    for _ in range(2):
        jst, info = ep(jst, jnp.asarray(centers), 0.05)
        jinfos.append(np.asarray(info))
    np.testing.assert_array_equal(ip.numpy(), np.stack(jinfos))
    _assert_states_close(sp, jst)
    _close(sp.mem.s_pending, jst.mem.s_pending, what="mem.s_pending")


def test_paired_is_off_by_default():
    fields = {f.name: f.default for f in dataclasses.fields(FusedTrainer)}
    assert fields["paired_grads"] is False
