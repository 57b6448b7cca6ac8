"""The PyTorch port's sharded single-dispatch programs on the CPU.

``FusedTrainer.jit_epoch``, ``jit_epochs`` and ``jit_epochs_scheduled`` on
a ``(data, param)`` mesh.  On the card they capture the sharded epoch, its
NCCL collectives included, in CUDA graphs; here the 4-rank gloo cluster of
``tests/torch_dist_worker.py`` (suite ``parallel``, shared with
``test_torch_parallel.py``: one cluster a session) drives the same graph
driver with a stand-in for the capture (``torch_dist_worker.ReplayedGraph``:
each replay runs the epoch on the graph's buffers, its collectives taken
as a capture takes them and logged at the replay), every group taken as
NCCL's.  Cases: ``__graft_entry__.dryrun_multichip``'s six at its shapes
(SQN on 2 x 2 and 4 x 1, bfloat16 adaQN on 1 x 4, bfloat16 interleaved
oLBFGS on 2 x 2, the scheduled whole fit with the gather and this rank's
rows inside the replayed epoch, the padded-COO sparse gradient; the
oLBFGS case in float64, ``torch_dist_worker.DRYRUN_F64``), and
SQN, adaQN and oLBFGS (bfloat16 interleaved pairs) on each of 4 x 1,
1 x 4 and 2 x 2 in float64.

Every rank's replays are held against the same rank's eager epochs bit
for bit, and the recorder's log of the replays against the eager log, op
for op; the gathered results against the JAX package's own ``jit_*`` on
the same mesh of forced host devices, at ``tests/test_parallel.py``'s
tolerances (float64 1e-8 / 1e-10 at ``:120``, float32 1e-5 / 1e-6 at
``:617``, bfloat16 pairs 1e-3 / 1e-4 at ``:527``).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_worker as tw
from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models import losses
from stochqn_tpu.models.sparse import sparse_multinomial_logistic_grad
from stochqn_tpu.parallel import (epoch_batch_constraint, make_mesh,
                                  shard_batches, shard_state)

WORLD = 4
CONFIGS = {"SQN": SQNConfig, "adaQN": AdaQNConfig, "oLBFGS": OLBFGSConfig}


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return tw.suite_results("parallel", WORLD, str(base))


def _ranks(suite, case, name):
    """Every rank's results of one problem of ``case``."""
    return [{k[len(name) + 1:]: v for k, v in r.items()
             if k.startswith(name + "_")}
            for r in tw.load_case(*suite, case, WORLD)]


def _tolerance(cfg_kw, dtype):
    if cfg_kw.get("pairs_bf16"):
        return dict(rtol=1e-3, atol=1e-4)
    if dtype == np.float64:
        return dict(rtol=1e-8, atol=1e-10)
    return dict(rtol=1e-5, atol=1e-6)


def _jax_mesh(shape):
    return make_mesh(n_data=shape[0], n_param=shape[1],
                     devices=jax.devices()[:WORLD])


def _check_ranks(ranks, shape, graphs=1, replays=2):
    """Each rank: the eager epochs' bits and log, ``graphs`` graphs keyed
    by the mesh's shape and this rank's coordinates, ``replays`` replays;
    the gathered ``x`` the same on every rank."""
    n_data, n_param = shape
    for r, res in enumerate(ranks):
        assert bool(res["same"]), f"rank {r}: not the eager epochs' bits"
        assert bool(res["same_log"]), f"rank {r}: not the eager log"
        assert res["mesh_keys"].tolist() == [
            [n_data, n_param, r // n_param, r % n_param]]
        assert int(res["graphs"]) == graphs
        assert int(res["replays"]) == replays
        np.testing.assert_array_equal(res["x"], ranks[0]["x"])
        np.testing.assert_array_equal(res["infos"], ranks[0]["infos"])
    return ranks[0]


@pytest.mark.parametrize("name", list(tw.DRYRUN))
def test_dryrun_case_on_graphs_matches_jax(suite, name):
    """``dryrun_multichip``'s case through the port's ``jit_epochs`` (or
    ``jit_epochs_scheduled``) on the mesh, 2 epochs, against the JAX
    package's on the same mesh."""
    opt, shape, _, cfg_kw = tw.DRYRUN[name]
    res = _check_ranks(_ranks(suite, "graphs_dryrun", name), shape)
    x0, data = tw.dryrun_data(name)
    reg = tw.DRYRUN_REG
    mesh = _jax_mesh(shape)
    if name == "sparse_2x2":
        def grad_fn(x, b):
            return sparse_multinomial_logistic_grad(x, b[0], b[1], b[2], 63,
                                                    reg_param=reg)
    else:
        def grad_fn(x, b):
            return losses.multinomial_logistic_grad(x, b[0], b[1], None, reg)

    def obj_fn(x, b):
        return losses.multinomial_logistic_loss(x, b[0], b[1], None, reg)
    tr = FusedTrainer(opt, CONFIGS[opt].create(**cfg_kw), grad_fn,
                      obj_fn=obj_fn if opt == "adaQN" else None)
    st = shard_state(tr.init(jnp.asarray(x0)), mesh)
    if name == "scheduled_2x2":
        (X, Y), orders, steps = data
        tr = dataclasses.replace(
            tr, batch_constraint=epoch_batch_constraint(mesh))
        rows = NamedSharding(mesh, P("data", None))
        flat = (jax.device_put(jnp.asarray(X), rows),
                jax.device_put(jnp.asarray(Y), rows))
        st, infos = tr.jit_epochs_scheduled()(
            st, flat, jnp.asarray(steps), jnp.asarray(orders, jnp.int32),
            batch_size=tw.DRYRUN[name][2][2], aligned=True)
    else:
        data = shard_batches(tuple(jnp.asarray(a) for a in data), mesh)
        st, infos = tr.jit_epochs()(st, data, tw.DRYRUN_STEP, 2,
                                    aligned=True)
    np.testing.assert_allclose(res["x"], np.asarray(st.x),
                               **_tolerance(cfg_kw, x0.dtype))
    np.testing.assert_array_equal(res["infos"], np.asarray(infos))
    assert int(res["niter"]) == int(st.niter) == 8


@pytest.mark.parametrize("name", list(tw.GRID))
def test_optimizer_on_mesh_on_graphs_matches_jax(suite, name):
    """SQN, adaQN and oLBFGS on 4 x 1, 1 x 4 and 2 x 2: the port's
    ``jit_epochs`` for 2 epochs and ``jit_epoch`` at another step on the
    cached graph, against the JAX package's on the same mesh."""
    opt, shape, cfg_kw = tw.GRID[name]
    res = _check_ranks(_ranks(suite, "graphs_grid", name), shape,
                       replays=3)
    a_np, x0, data_np = tw.grid_data()
    a = jnp.asarray(a_np)

    def grad_fn(x, b):
        return a @ (x - jnp.mean(b, axis=0))

    def obj_fn(x, b):
        r = x[None, :] - b
        return 0.5 * jnp.mean(jnp.einsum("bi,ij,bj->b", r, a, r))
    tr = FusedTrainer(opt, CONFIGS[opt].create(**cfg_kw), grad_fn,
                      obj_fn=obj_fn)
    mesh = _jax_mesh(shape)
    st = shard_state(tr.init(jnp.asarray(x0)), mesh)
    data = shard_batches(jnp.asarray(data_np), mesh)
    st, i1 = tr.jit_epochs()(st, data, tw.GRID_STEPS[0], 2)
    st, i2 = tr.jit_epoch()(st, data, tw.GRID_STEPS[1])
    np.testing.assert_allclose(res["x"], np.asarray(st.x),
                               **_tolerance(cfg_kw, np.float64))
    np.testing.assert_array_equal(
        res["infos"], np.concatenate([np.asarray(i1),
                                      np.asarray(i2)[None]]))
    assert int(res["niter"]) == int(st.niter) == 3 * tw.GRID_B


def test_every_rank_replays_the_same_graphs_in_order(suite):
    """Epochs that start at other phases: the layout and start phase are
    host decisions every rank makes alike, so every rank captures the same
    graphs and replays them in the same order, with the eager bits."""
    ranks = tw.load_case(*suite, "graphs_order", WORLD)
    _check_ranks(ranks, (2, 2), graphs=3, replays=4)
    want = [[1, 0], [1, 1], [1, 0], [1, 1]]       # (generic, start phase)
    for res in ranks:
        assert res["layouts"].tolist() == want


@pytest.mark.parametrize("name", ["sqn_2x2", "adaqn_1x4", "sqn_4x1",
                                  "olbfgs_2x2"])
def test_dryrun_draws_are_graft_entrys(name):
    """The worker's draws of a dense case are ``__graft_entry__``'s."""
    import __graft_entry__ as ge
    opt, _, (nf, C, bs, B, _), _ = tw.DRYRUN[name]
    make = {"SQN": ge._flagship, "adaQN": ge._flagship_adaqn}.get(opt)
    if make is None:
        _, state, (X, Y) = ge._flagship_olbfgs(
            n_features=nf, n_classes=C, batch_size=bs, num_batches=B)
    else:
        _, state, (X, Y) = make(n_features=nf, n_classes=C, batch_size=bs,
                                upd_freq=2, num_batches=B)
    x0, (Xw, Yw) = tw.dryrun_data(name)
    for got, want in ((x0, state.x), (Xw, X), (Yw, Y)):
        np.testing.assert_array_equal(got, np.asarray(want))
