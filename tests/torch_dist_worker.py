"""Worker of the PyTorch port's multi-rank CPU tests (not collected).

``tests/test_torch_parallel.py`` and ``tests/test_torch_distributed.py``
start a gloo cluster of these workers on the CPU with :func:`run_suite`
(file rendezvous, so that concurrent clusters never share a port); every
rank runs every case of one suite in order and writes each case's
results, per rank, to ``<out>/<case>.r<rank>.npz``.  The problems are
built from numpy seeds by the functions below, which the tests call too:
the tests hold what the ranks wrote against the JAX package on the same
inputs.  This module imports torch and numpy only, never jax.

Usage: python tests/torch_dist_worker.py <suite> <rank> <world> <init file>
                                         <out dir>
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


# ---------------------------------------------------------------------------
# problems, shared with the tests (numpy only)
def quad(seed, n):
    """A symmetric positive definite ``[n, n]`` matrix."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T


def dp_problem(seed, n, bs):
    """``x``, ``v`` and a ``[bs, n]`` batch."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n), rng.standard_normal(n),
            rng.standard_normal((bs, n)))


def pairs_problem(seed, n, m, dtype=np.float64):
    """Pair rows ``s``, ``y`` ``[m, n]``, a gradient and a diagonal."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((m, n))
    y = s + 0.3 * rng.standard_normal((m, n))
    g = rng.standard_normal(n)
    diag = rng.uniform(0.5, 1.5, n)
    return tuple(a.astype(dtype) for a in (s, y, g, diag))


def diag_quad(seed, n, dtype=np.float32):
    return np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(dtype)


def batches(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# Budget cases: (name, optimizer, mesh, n, bs, m, config) on the diagonal
# quadratic ``0.5 (x - mean(b))' A (x - mean(b))``, warmed by one unsharded
# epoch on batches(1, (4, bs, n)) at step 0.05.
BUDGETS = {
    "dp_sqn_step": ("SQN", (4, 1), 512, 16, 3, {}),
    "param_adaqn_step": ("adaQN", (1, 4), 4096, 8, 3,
                         dict(fisher_size=4, max_incr=1.01,
                              rmsprop_weight=0.9)),
    "mixed_sqn_round": ("SQN", (2, 2), 512, 16, 3, {}),
    "mixed_olbfgs_step": ("oLBFGS", (2, 2), 512, 16, 3,
                          dict(min_curvature=1e-8)),
    "bf16_olbfgs_param": ("oLBFGS", (1, 4), 4096, 8, 3,
                          dict(min_curvature=1e-8, pairs_bf16=True,
                               pairs_interleaved=True)),
    "bf16_fisher_adaqn_param": ("adaQN", (1, 4), 4096, 8, 3,
                                dict(fisher_size=4, max_incr=1.01,
                                     rmsprop_weight=0.9, pairs_bf16=True,
                                     fisher_bf16=True)),
}
BUDGET_L = 4


def logistic_problem(seed=7, rows=96, features=7, classes=3):
    """A small multinomial problem: ``X``, one-hot ``Y``; ``(features + 1)
    * classes`` parameters (24: even)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((rows, features))
    labels = rng.integers(0, classes, rows)
    return X, np.eye(classes)[labels]


LOGISTIC_KW = dict(optimizer="SQN", engine="fused", reg_param=0.1,
                   step_size=0.1, valset_frac=None, batches_per_epoch=4,
                   nepochs=3, mem_size=3, bfgs_upd_freq=2)


def ls_problem(seed=11, rows=64, features=6):
    """Least squares for the guided front end: ``X``, ``y``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((rows, features))
    return X, X @ rng.standard_normal(features) + 0.1 * rng.standard_normal(
        rows)


GUIDED_REG = 0.05


# ---------------------------------------------------------------------------
# the sharded programs (jit_epoch / jit_epochs / jit_epochs_scheduled) on
# the graph driver, with a stand-in for the capture
class ReplayedGraph:
    """In place of ``stochqn_tpu_torch.graphs._Graph`` where nothing is
    captured (the CPU): each replay runs the epoch on the family's buffers
    and writes its state back, as the captured graph does.  The epoch's
    collectives go where a capture puts them (``comm.CAPTURED``, not the
    open logs), and the replay then logs them as ``_Graph.replay`` does.
    :data:`REPLAYED` takes the layout of every replay, in order."""

    def __init__(self, family, run):
        self.family, self.run = family, run
        self.launches, self.replays, self.copy_bytes = {}, 0, 0
        self.pending = None
        if family.in_place:     # the warm-up on the buffers is the epoch
            out, self.pending = run(family.state_tree(),
                                    family.inputs_tree(), family.eta)
            family.write_back(out)

    def replay(self):
        from stochqn_tpu_torch.parallel import comm
        fam = self.family
        comm.CAPTURED.clear()
        capturing, comm._capturing = comm._capturing, lambda buf: True
        try:
            out, infos = self.run(fam.state_tree(), fam.inputs_tree(),
                                  fam.eta)
            self.copy_bytes = fam.write_back(out)
        finally:
            comm._capturing = capturing
        comm.log_replay(list(comm.CAPTURED))
        comm.CAPTURED.clear()
        self.replays += 1
        REPLAYED.append(next(k for k, g in fam.graphs.items() if g is self))
        return infos


REPLAYED: list = []


@contextlib.contextmanager
def graph_stand_in():
    """The graph driver on gloo CPU ranks: :class:`ReplayedGraph` for the
    capture, every state taken as one on the card and every group as
    NCCL's (build the trainers inside the block)."""
    from stochqn_tpu_torch import graphs
    from stochqn_tpu_torch.parallel import mesh
    saved = graphs._Graph, graphs.captures, mesh.capturable
    graphs._Graph, graphs.captures = ReplayedGraph, lambda state: True
    mesh.capturable = lambda group: True
    try:
        yield
    finally:
        graphs._Graph, graphs.captures, mesh.capturable = saved


# __graft_entry__.dryrun_multichip's six cases at 4 devices, its shapes and
# seeds: name -> (optimizer, mesh, (n_features, n_classes, batch_size,
# num_batches, seed), config).  "scheduled" runs jit_epochs_scheduled,
# "sparse" the padded-COO gradient.
DRYRUN = {
    "sqn_2x2": ("SQN", (2, 2), (63, 8, 8, 4, 0),
                dict(mem_size=10, bfgs_upd_freq=2)),
    "adaqn_1x4": ("adaQN", (1, 4), (63, 4, 4, 4, 1),
                  dict(mem_size=3, fisher_size=8, bfgs_upd_freq=2,
                       max_incr=1.01, rmsprop_weight=0.9, pairs_bf16=True,
                       fisher_bf16=True)),
    "sqn_4x1": ("SQN", (4, 1), (63, 4, 16, 4, 0),
                dict(mem_size=10, bfgs_upd_freq=2)),
    "olbfgs_2x2": ("oLBFGS", (2, 2), (63, 8, 8, 4, 2),
                   dict(mem_size=4, min_curvature=1e-8,
                        pairs_interleaved=True, pairs_bf16=True)),
    "scheduled_2x2": ("SQN", (2, 2), (63, 8, 8, 4, 0),
                      dict(mem_size=10, bfgs_upd_freq=2)),
    "sparse_2x2": ("SQN", (2, 2), None, dict(mem_size=3, bfgs_upd_freq=2)),
}
DRYRUN_REG = 1e-1
DRYRUN_STEP = 0.05
# bfloat16 oLBFGS forks on float32 summation order (the JAX package forks
# from itself so; ROADMAP, queue C), so that case runs its data and x0 in
# float64, its pairs still bfloat16, where both packages' sums agree.
DRYRUN_F64 = ("olbfgs_2x2",)


def dryrun_data(name):
    """``(x0, data)`` of a DRYRUN case as ``__graft_entry__`` draws them
    (float32): ``data`` is ``(X [B, bs, f], Y [B, bs, C])``; for
    "scheduled" ``(flat_rows, orders, steps)``; for "sparse" ``(idx, val,
    Y)`` padded COO ``[4, 8, 8]`` (the scheduled case's generator, used on
    after its orders, as ``dryrun_multichip`` does)."""
    if name == "sparse_2x2":
        _, _, rng = _scheduled_draws()
        nf, C, k, bs = 63, 8, 8, 8
        rows = 4 * bs
        dense = np.zeros((rows, nf), np.float32)
        for r in range(rows):
            cols = rng.choice(nf, size=k // 2, replace=False)
            dense[r, cols] = rng.standard_normal(k // 2)
        idx = np.zeros((rows, k), np.int64)
        val = np.zeros((rows, k), np.float32)
        for r in range(rows):
            nz = np.flatnonzero(dense[r])
            idx[r, :nz.size], val[r, :nz.size] = nz, dense[r, nz]
        hot = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=rows)]
        x0 = rng.standard_normal((nf + 1) * C).astype(np.float32)
        return x0, (idx.reshape(4, bs, k), val.reshape(4, bs, k),
                    hot.reshape(4, bs, C))
    if name == "scheduled_2x2":
        (x0, (X, Y)), sched, _ = _scheduled_draws()
        return x0, ((X.reshape(-1, X.shape[-1]), Y.reshape(-1, Y.shape[-1])),
                    *sched)
    nf, C, bs, B, seed = DRYRUN[name][2]
    dtype = np.float64 if name in DRYRUN_F64 else np.float32
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((nf + 1) * C).astype(np.float32)
    X = rng.standard_normal((B, bs, nf)).astype(np.float32)
    Y = np.eye(C)[rng.integers(0, C, size=(B, bs))].astype(np.float32)
    return x0.astype(dtype), (X.astype(dtype), Y.astype(dtype))


def _scheduled_draws():
    """The scheduled case's data, its two epochs' orders and steps, and the
    generator they were drawn from, left where ``dryrun_multichip`` leaves
    it."""
    x0, data = dryrun_data("sqn_2x2")
    rng = np.random.default_rng(7)
    n_rows = data[0].shape[0] * data[0].shape[1]
    orders = np.stack([rng.permutation(n_rows) for _ in range(2)])
    steps = np.array([0.05, 0.05 / np.sqrt(2.0)], np.float32)
    return (x0, data), (orders, steps), rng


# The three optimizers on each mesh of 4 ranks, on a float64 quadratic,
# the mean over the rows of 0.5 (x - b)' A (x - b): name -> (optimizer,
# mesh, config).  oLBFGS keeps bfloat16 interleaved pairs.
GRID_OPTIMIZERS = {
    "SQN": dict(mem_size=3, bfgs_upd_freq=2),
    "adaQN": dict(mem_size=3, fisher_size=4, bfgs_upd_freq=2, max_incr=1.01,
                  rmsprop_weight=0.9),
    "oLBFGS": dict(mem_size=3, min_curvature=1e-8, pairs_interleaved=True,
                   pairs_bf16=True),
}
GRID_MESHES = ((4, 1), (1, 4), (2, 2))
GRID = {f"{opt.lower()}_{d}x{p}": (opt, (d, p), cfg)
        for opt, cfg in GRID_OPTIMIZERS.items() for d, p in GRID_MESHES}
GRID_N, GRID_B, GRID_BS = 16, 6, 8
GRID_STEPS = (0.05, 0.03)       # jit_epochs for 2 epochs, then jit_epoch


def grid_data():
    """``(a [n, n], x0, data [B, bs, n])`` in float64."""
    return (quad(21, GRID_N), np.zeros(GRID_N),
            batches(22, (GRID_B, GRID_BS, GRID_N), np.float64))


# ---------------------------------------------------------------------------
# the cases (run inside the cluster)
def _torch_cases():
    import torch

    import dist_common as dc
    from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer, OLBFGSConfig,
                                   SQN, SQNConfig,
                                   StochasticLogisticRegression, minimize)
    from stochqn_tpu_torch.fused import _adaqn_base, _adaqn_boundary, _flat
    from stochqn_tpu_torch.fused import _sqn_base, _sqn_boundary, olbfgs_step
    from stochqn_tpu_torch.models import sparse as sp
    from stochqn_tpu_torch.ops.pairs import commit_pair
    from stochqn_tpu_torch.ops.two_loop import two_loop, two_loop_cached
    from stochqn_tpu_torch.core.state import BFGSMemory
    from stochqn_tpu_torch.parallel import (MeshComm, collective_ops,
                                            data_parallel_grad,
                                            data_parallel_hvp,
                                            data_parallel_value,
                                            gather_state, make_mesh,
                                            record_collectives,
                                            shard_batches, shard_state)
    from stochqn_tpu_torch.parallel import comm as comm_mod
    from stochqn_tpu_torch.parallel import distributed
    from stochqn_tpu_torch.utils import checkpoint, metrics

    T = torch.as_tensor
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device_type="cpu")
        return meshes[shape]

    def gathered(state, m):
        return gather_state(state, m).x.numpy()

    def ops_table(log):
        """The log as arrays: kind (0 reduce, 1 gather), bytes, group
        size, and the labels joined."""
        return dict(kinds=np.array([op.kind == "all-gather" for op in log],
                                   np.int64),
                    nbytes=np.array([op.payload_bytes for op in log],
                                    np.int64),
                    groups=np.array([op.group_size for op in log], np.int64),
                    labels=np.array("|".join(op.label for op in log)))

    # -- data-parallel evaluation (test_parallel.py:25, :40, :56) ----------
    def dp_eval():
        m = mesh((4, 1))
        x, v, batch = (T(a) for a in dp_problem(0, 10, 16))
        a = T(quad(1, 10))
        rows = shard_batches(batch, m, batched=False)

        def sum_grad(x, b):
            return b.sum(0) + 0.0 * x

        def grad_fn(x, b):
            return (a @ (x[:, None] - b.T)).sum(1)

        def obj_fn(x, b):
            r = x[None, :] - b
            return 0.5 * torch.einsum("bi,ij,bj->", r, a, r)

        def mean_grad(x, b):
            return a @ (x - b.mean(0))

        returned = []

        def keeping(x, b):          # the sum must not write into it
            returned.append(obj_fn(x, b))
            return returned[-1]
        data_parallel_value(keeping, m)(x, rows)
        return dict(
            value_kept=np.bool_(torch.equal(returned[0], obj_fn(x, rows))),
            sum_grad=data_parallel_grad(sum_grad, m)(x, rows).numpy(),
            grad=data_parallel_grad(grad_fn, m)(x, rows).numpy(),
            value=data_parallel_value(obj_fn, m)(x, rows).numpy(),
            hvp=data_parallel_hvp(grad_fn, m)(x, v, rows).numpy(),
            mean_grad=data_parallel_grad(mean_grad, m, "mean")(
                x, rows).numpy())

    # -- the uncached two-loop on a sharded param axis (:82, :125) ----------
    def two_loop_param():
        m = mesh((1, 4))
        comm = MeshComm(m)
        out = {}
        for key, n, mm in (("small", 64, 5), ("budget", 512, 6)):
            s, y, g, diag = (comm.param_slice(T(a))
                             for a in pairs_problem(2, n, mm))
            with record_collectives() as log:
                d = two_loop(g, s, y, 0, mm, comm=comm)
            out[key] = comm.gather_param([d], "test")[0].numpy()
            out[key + "_allreduces"] = np.int64(len(log))
            dd = two_loop(g, s, y, 0, mm, diag=diag, comm=comm)
            out[key + "_diag"] = comm.gather_param([dd], "test")[0].numpy()
            dk = two_loop(g.float(), s.float(), y.float(), 0, mm,
                          use_pallas=True, comm=comm)
            out[key + "_kernel"] = comm.gather_param([dk], "test")[0].numpy()
        return out

    # -- a sharded fused epoch against the JAX unsharded one (:101) --------
    def fused_epoch():
        n, B, bs, L = 16, 8, 8, 4
        a = T(quad(3, n))

        def grad_fn(x, b):
            return a @ (x - b.mean(0))
        m = mesh((2, 2))
        tr = FusedTrainer("SQN", SQNConfig.create(mem_size=3,
                                                  bfgs_upd_freq=L),
                          grad_fn, mesh=m, reduction="mean")
        data = T(batches(4, (B, bs, n), np.float64))
        st, infos = tr.epoch(tr.init(torch.zeros(n, dtype=torch.float64)),
                             shard_batches(data, m), 0.05)
        return dict(x=gathered(st, m), infos=infos.numpy(),
                    niter=st.niter.numpy())

    # -- adaQN couplings on a sharded param axis (:147) --------------------
    def adaqn_coupling():
        n, mm = 512, 4
        m = mesh((1, 4))
        comm = MeshComm(m)
        s, y, g, diag = (T(a) for a in pairs_problem(5, n, mm, np.float32))
        mem = BFGSMemory.create(mm, n, torch.float32)
        for i in range(mm):
            mem = mem.replace(s_pending=s[i].clone())
            mem, _ = commit_pair(mem, y[i].clone(), 1e-8, 0.0)
        mem_sh = shard_state(mem, m)
        out = {}
        for coupling, pallas in (("matvec", None), ("gram", None),
                                 ("gram", True)):
            key = coupling + ("_kernel" if pallas else "")
            with record_collectives() as log:
                d = two_loop_cached(comm.param_slice(g), mem_sh,
                                    diag=comm.param_slice(diag),
                                    coupling=coupling, use_pallas=pallas,
                                    comm=comm)
            out[key] = comm.gather_param([d], "test")[0].numpy()
            out[key + "_allreduces"] = np.int64(len(log))
        return out

    # -- per-step collective budgets (:223 - :575) --------------------------
    def budget_trainer(optimizer, n, mm, cfg_kw, the_mesh=None):
        a_diag = T(diag_quad(6, n))

        def grad_fn(x, b):
            return a_diag * (x - b.mean(0))

        def obj_fn(x, b):
            r = x - b.mean(0)
            return 0.5 * torch.dot(r, a_diag * r)
        if optimizer == "SQN":
            cfg = SQNConfig.create(mem_size=mm, bfgs_upd_freq=BUDGET_L,
                                   **cfg_kw)
        elif optimizer == "adaQN":
            cfg = AdaQNConfig.create(mem_size=mm, bfgs_upd_freq=BUDGET_L,
                                     **cfg_kw)
        else:
            cfg = OLBFGSConfig.create(mem_size=mm, **cfg_kw)
        return FusedTrainer(optimizer, cfg, grad_fn, obj_fn=obj_fn,
                            mesh=the_mesh, reduction="mean")

    def budget(name):
        optimizer, shape, n, bs, mm, cfg_kw = BUDGETS[name]
        m = mesh(shape)
        warm_data = T(batches(1, (4, bs, n)))
        plain = budget_trainer(optimizer, n, mm, cfg_kw)
        st, _ = plain.epoch(plain.init(torch.zeros(n)), warm_data, 0.05)
        tr = budget_trainer(optimizer, n, mm, cfg_kw, m)
        st = shard_state(st, m)
        comm = tr._comm
        batch = shard_batches(T(batches(2, (bs, n))), m, batched=False)
        eta = torch.tensor(0.05)
        out = {}
        with record_collectives() as log:
            if optimizer == "SQN":
                st2, _ = _sqn_base(tr.cfg, tr._grad, st, batch, eta, comm)
            elif optimizer == "adaQN":
                st2, _ = _adaqn_base(tr.cfg, tr._grad, st, batch, eta, comm)
            else:
                st2, _ = olbfgs_step(tr.cfg, tr._grad, st, batch, eta, comm)
        out.update({"step_" + k: v for k, v in ops_table(log).items()})
        if optimizer != "oLBFGS":
            big = shard_batches(T(batches(3, (BUDGET_L * bs, n))), m,
                                batched=False)
            st2 = st2.replace(niter=torch.full_like(st2.niter, 2 * BUDGET_L))
            bad = torch.zeros((), dtype=torch.bool)
            with record_collectives() as log:
                if optimizer == "SQN":
                    _sqn_boundary(tr.cfg, tr._grad, st2, big, bad, tr._hvp,
                                  comm)
                else:
                    _adaqn_boundary(tr.cfg, tr._grad, tr._obj, st2, big, big,
                                    bad, comm)
            out.update({"boundary_" + k: v
                        for k, v in ops_table(log).items()})
        if name == "bf16_olbfgs_param":
            # one more epoch from the warm state, sharded
            st3, _ = tr.epoch(st, shard_batches(warm_data, m), 0.05)
            out["x_next_epoch"] = gathered(st3, m)
        return out

    # -- the scheduled whole fit on a mixed mesh (:401) ---------------------
    def scheduled():
        n, n_rows, bs, L, mm, nepochs = 64, 64, 8, 2, 3, 3
        a_diag = T(diag_quad(8, n, np.float64))

        def grad_fn(x, b):
            return a_diag * (x - b[0].mean(0))
        m = mesh((2, 2))
        tr = FusedTrainer("SQN", SQNConfig.create(mem_size=mm,
                                                  bfgs_upd_freq=L),
                          grad_fn, mesh=m, reduction="mean")
        flat = T(batches(9, (n_rows, n), np.float64))
        orders = scheduled_orders(n_rows, nepochs)
        steps = torch.tensor([0.05 / np.sqrt(e + 1.0)
                              for e in range(nepochs)], dtype=torch.float64)
        st, infos = tr.epochs_scheduled(
            tr.init(torch.zeros(n, dtype=torch.float64)), (flat,), steps,
            T(orders), batch_size=bs, aligned=True)
        return dict(x=gathered(st, m), infos=infos.numpy(),
                    niter=st.niter.numpy())

    # -- padded-COO sparse SQN on a mixed mesh (:578) ----------------------
    def sparse_sqn():
        nf, C, k, bs, B, L, mm = 256, 4, 8, 16, 8, 4, 3
        m = mesh((2, 2))
        n_data = MeshComm(m).n_data
        idx, val, hot, x0 = sparse_problem(nf, C, k, bs, B)

        def grad_fn(x, b):
            # the penalty split over the data ranks: summed, it is counted
            # once
            return sp.sparse_multinomial_logistic_grad(
                x, b[0], b[1], b[2], nf, reg_param=1e-1 / n_data)
        tr = FusedTrainer("SQN", SQNConfig.create(mem_size=mm,
                                                  bfgs_upd_freq=L),
                          grad_fn, mesh=m)
        data = shard_batches((T(idx).long(), T(val), T(hot)), m)
        st0 = tr.init(T(x0))
        st, infos = tr.epoch(st0, data, 0.05)
        with record_collectives() as log:
            _sqn_base(tr.cfg, tr._grad, tr.init(T(x0)),
                      tuple(d[0] for d in data), torch.tensor(0.05),
                      tr._comm)
        return dict(x=gathered(st, m), infos=infos.numpy(),
                    niter=st.niter.numpy(),
                    **{"step_" + k: v for k, v in ops_table(log).items()})

    # -- the front ends: the regulariser, a non-dividing axis, guided,
    #    minimize -------------------------------------------------------
    def logistic():
        X, Y = logistic_problem()
        m = mesh((2, 2))
        kw = dict(LOGISTIC_KW, dtype=torch.float64, device="cpu")
        out = {}
        programs = ("fit_programs_built", "fit_programs_reused")
        for shuffle in (False, True):
            key = "shuffled" if shuffle else "fixed"
            before = metrics.snapshot()["counters"]
            sharded = StochasticLogisticRegression(
                mesh=m, shuffle_data=shuffle, **kw).fit(X, Y)
            after = metrics.snapshot()["counters"]
            out[key + "_programs"] = np.array(
                [after[k] - before[k] for k in programs])
            plain = StochasticLogisticRegression(
                shuffle_data=shuffle, **kw).fit(X, Y)
            out[key] = sharded.x_
            out[key + "_plain"] = plain.x_
            out[key + "_predict"] = sharded.predict(X)
        # 96 rows in 16 batches of 6: 4 data ranks cannot split a batch
        try:
            StochasticLogisticRegression(
                mesh=mesh((4, 1)), **dict(kw, batches_per_epoch=16)
            ).fit(X, Y)
        except ValueError as exc:
            out["nondividing"] = np.array(str(exc))
        return out

    def guided():
        X, y = ls_problem()
        m = mesh((2, 2))
        out = {}
        for sharded in (True, False):
            opt = SQN(np.zeros(X.shape[1]), ls_grad_torch, ls_obj_torch,
                      ls_hvp_torch, batches_per_epoch=4, step_size=0.05,
                      nepochs=3, mem_size=3, bfgs_upd_freq=2, verbose=False,
                      dtype=torch.float64, device="cpu")
            opt.fit(X, y, engine="fused", mesh=m if sharded else None,
                    reduction="mean")
            key = "sharded" if sharded else "plain"
            out[key] = opt.get_x()
            out[key + "_mode"] = np.array(opt._fused_dispatch_mode)
            opt.partial_fit(X[:16], y[:16])
            out[key + "_partial"] = opt.get_x()
            out[key + "_niter"] = np.int64(opt.niter)
        # the other dispatch modes: fixed batches ("invariant") and the
        # per-epoch loop (a callback, and a validation set for early
        # stopping), sharded against unsharded
        for mode, over, fit_kw in (
                ("invariant", dict(shuffle_data=False, decr_step_size=None),
                 {}),
                ("loop", dict(callback_epoch=lambda x: None, tol=-1.0),
                 dict(valset=(X[:16], y[:16], None)))):
            for sharded in (True, False):
                opt = SQN(np.zeros(X.shape[1]), ls_grad_torch, ls_obj_torch,
                          ls_hvp_torch, batches_per_epoch=4, step_size=0.05,
                          nepochs=3, mem_size=3, bfgs_upd_freq=2,
                          verbose=False, dtype=torch.float64, device="cpu",
                          **over)
                opt.fit(X, y, engine="fused", mesh=m if sharded else None,
                        reduction="mean", **fit_kw)
                key = f"{mode}_{'sharded' if sharded else 'plain'}"
                out[key] = opt.get_x()
                out[key + "_mode"] = np.array(opt._fused_dispatch_mode)
        return out

    def minimize_case():
        X, y = ls_problem()
        m = mesh((2, 2))
        data = (T(X), T(y))

        def loss_fn(x, b):
            r = b[0] @ x - b[1]
            return 0.5 * torch.mean(r * r) + 0.5 * GUIDED_REG * torch.dot(x, x)
        out = {}
        sqn_kw = dict(optimizer="SQN", step_size=0.05, batch_size=16,
                      nepochs=3, mem_size=3, bfgs_upd_freq=2, tol=1e-12)
        for optimizer in ("SQN", "adaQN"):
            kw = dict(sqn_kw, optimizer=optimizer)
            if optimizer == "adaQN":
                kw.update(fisher_size=4, rmsprop_weight=0.9)
            res = minimize(loss_fn, torch.zeros(X.shape[1],
                                                dtype=torch.float64),
                           data, mesh=m, reduction="mean", **kw)
            out[optimizer] = res.x.numpy()
            out[optimizer + "_losses"] = np.array(res.losses)
        # the structured-parameter path (PytreeTrainer) on the same mesh
        res = minimize(lambda p, b: loss_fn(p["w"], b),
                       {"w": torch.zeros(X.shape[1], dtype=torch.float64)},
                       data, mesh=m, reduction="mean", **sqn_kw)
        out["SQN_tree"] = res.x["w"].detach().numpy()
        return out

    # -- the guard's threshold is the global n ----------------------------
    def guard():
        from stochqn_tpu_torch.ops.pairs import direction_is_bad
        m = mesh((1, 4))
        comm = MeshComm(m)
        n = 64
        # ||d|| = 32,000: under 1e3 * 64, over 1e3 * 16 (a slice's n)
        d = torch.full((n,), 4000.0, dtype=torch.float64)
        nan = d.clone()
        nan[5] = float("nan")                   # on rank 0's slice only
        return dict(bad=np.bool_(direction_is_bad(comm.param_slice(d),
                                                  comm)),
                    bad_nan=np.bool_(direction_is_bad(
                        comm.param_slice(nan), comm)))

    # -- more layouts on a mesh: interleaved ring commits, paired oLBFGS,
    #    adaQN's generic layout with a validation set -------------------
    def layouts():
        n = 16
        a_diag = T(diag_quad(13, n, np.float64))

        def grad_fn(x, b):
            return a_diag * (x - b.mean(0))

        def obj_fn(x, b):
            r = x - b.mean(0)
            return 0.5 * torch.dot(r, a_diag * r)
        data = T(batches(14, (6, 8, n), np.float64))
        x0 = torch.zeros(n, dtype=torch.float64)
        out = {}
        m = mesh((1, 4))
        tr = FusedTrainer("SQN", SQNConfig.create(
            mem_size=3, bfgs_upd_freq=2, pairs_interleaved=True), grad_fn,
            mesh=m, reduction="mean")
        st = tr.init(x0)
        st = st.replace(mem=st.mem.replace(shift=False))
        for _ in range(2):
            st, _ = tr.epoch(st, shard_batches(data, m), 0.05)
        out["ring"] = gathered(st, m)
        m = mesh((2, 2))
        tr = FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=3),
                          grad_fn, mesh=m, reduction="mean",
                          paired_grads=True)
        st, infos = tr.epoch(tr.init(x0), shard_batches(data, m), 0.05)
        out["paired"], out["paired_infos"] = gathered(st, m), infos.numpy()
        val = T(batches(15, (8, n), np.float64))
        tr = FusedTrainer("adaQN", AdaQNConfig.create(
            mem_size=3, fisher_size=4, bfgs_upd_freq=4, max_incr=1.01,
            rmsprop_weight=0.9), grad_fn, obj_fn=obj_fn, val_data=val,
            mesh=m, reduction="mean")
        st = tr.init(x0)
        for _ in range(2):
            st, infos = tr.epoch(st, shard_batches(data, m), 0.1)
        out["adaqn_generic"] = gathered(st, m)
        out["adaqn_generic_infos"] = infos.numpy()
        return out

    # -- the recorder ------------------------------------------------------
    def recorder():
        m = mesh((2, 2))
        comm = MeshComm(m)
        t = torch.ones(6, dtype=torch.float64)
        with record_collectives() as outer:
            comm_mod.all_reduce(t, comm.data_group, "a")
            with record_collectives() as inner:
                full = comm_mod.all_gather(torch.full((2, 3), float(
                    comm.param_rank)), comm.param_group, "b")
            comm.sum_param([torch.ones(2), torch.ones(3)], "c")
        return dict(outer=ops_table(outer)["nbytes"],
                    outer_kinds=ops_table(outer)["kinds"],
                    outer_groups=ops_table(outer)["groups"],
                    outer_labels=ops_table(outer)["labels"],
                    inner=ops_table(inner)["nbytes"],
                    reduced=t.numpy(), gathered=full.numpy(),
                    bytes_a=np.int64(comm_mod.collective_bytes(outer, "a")),
                    n_ops=np.int64(len(collective_ops(outer))))

    # -- the distributed suites (test_distributed.py) -----------------------
    def dist_trainer(optimizer, a, m):
        """dist_common's trainers on a mesh: a mean over the rows, so
        reduction="mean"."""
        a = torch.as_tensor(a)

        def grad_fn(x, b):
            return a @ (x - b.mean(0))

        def obj_fn(x, b):
            r = x - b.mean(0)
            return 0.5 * r @ (a @ r)
        cfg = {"SQN": lambda: SQNConfig.create(mem_size=3,
                                               bfgs_upd_freq=dc.L),
               "adaQN": lambda: AdaQNConfig.create(
                   mem_size=3, fisher_size=6, bfgs_upd_freq=dc.L,
                   max_incr=1.01, rmsprop_weight=0.9),
               "oLBFGS": lambda: OLBFGSConfig.create(mem_size=3)}[optimizer]
        return FusedTrainer(optimizer, cfg(), grad_fn, obj_fn=obj_fn,
                            mesh=m, reduction="mean")

    def dist_case(optimizer, shape):
        m = mesh(shape)
        centers, a, x0 = dc.make_data()
        tr = dist_trainer(optimizer, a, m)
        rows = distributed.process_local_batch_slice(dc.BS_GLOBAL, m)
        data = distributed.global_batches(centers[:, rows, :], m)
        st = tr.init(torch.as_tensor(x0))
        for _ in range(dc.NEPOCHS):
            st, _ = tr.epoch(st, data, dc.STEP, aligned=True)
        return dict(x=gathered(st, m), rows=np.array([rows.start,
                                                      rows.stop]))

    def slices():
        out = {}
        for shape in ((2, 1), (1, 2)):
            sl = distributed.process_local_batch_slice(8, mesh(shape))
            out["%dx%d" % shape] = np.array([sl.start, sl.stop])
        sl = distributed.process_local_batch_slice(8)
        out["none"] = np.array([sl.start, sl.stop])
        return out

    def sharded_checkpoint(out_dir):
        import torch.distributed as dist
        from torch.distributed.checkpoint.format_utils import \
            dcp_to_torch_save
        m = mesh((1, 2))
        centers, a, x0 = dc.make_data()
        tr = dist_trainer("SQN", a, m)
        data = distributed.global_batches(centers, m)
        st, _ = tr.epoch(tr.init(torch.as_tensor(x0)), data, dc.STEP)
        path = os.path.join(out_dir, "sharded_ckpt")
        checkpoint.save_sharded(path, st, m)
        fresh = checkpoint.load_sharded(path, tr.init(torch.zeros(dc.N)),
                                        m)
        same = all(bool(torch.equal(u, v)) for (_, u), (_, v) in zip(
            checkpoint._leaves_with_paths(st),
            checkpoint._leaves_with_paths(fresh)))
        full = gather_state(st, m)
        consolidated = os.path.join(out_dir, "consolidated.pt")
        if dist.get_rank() == 0:
            dcp_to_torch_save(path, consolidated)
        dist.barrier()
        flat = torch.load(consolidated, weights_only=False)
        equal_full = all(bool(torch.equal(flat[k], t)) for k, t in
                         checkpoint._leaves_with_paths(full))
        go_on, _ = tr.epoch(st, data, dc.STEP)
        resumed, _ = tr.epoch(fresh, data, dc.STEP)
        return dict(same_bits=np.bool_(same), consolidated=np.bool_(
            equal_full), keys=np.array(sorted(flat)),
            x_continued=gathered(go_on, m), x_resumed=gathered(resumed, m))

    # -- the programs on a mesh, on the graph driver (the stand-in for the
    #    capture), against the same rank's eager epochs --------------------
    def programs(make, shape, x0, run_eager, run_graph):
        """``run_graph(trainer, state)`` on the graph driver against
        ``run_eager`` on another trainer, both from ``x0`` and recorded:
        the same bits, the same collectives in order."""
        from stochqn_tpu_torch.graphs import flatten
        m = mesh(shape)
        with graph_stand_in():
            eager, graphed = make(m), make(m)
            with record_collectives() as elog:
                ref, ref_infos = run_eager(eager, eager.init(x0))
            with record_collectives() as glog:
                st, infos = run_graph(graphed, graphed.init(x0))
        progs = graphed._programs
        same = torch.equal(infos, ref_infos) and all(
            torch.equal(a, b) for a, b in zip(flatten(st)[0],
                                              flatten(ref)[0]))
        keys = {k[-1] for k in progs.families}
        return dict(x=gathered(st, m), infos=infos.numpy(),
                    niter=st.niter.numpy(), same=np.bool_(same),
                    same_log=np.bool_(glog == elog and len(glog) > 0),
                    mesh_keys=np.array(sorted(keys)),
                    graphs=np.int64(len(progs.graphs())),
                    replays=np.int64(sum(g.replays
                                         for g in progs.graphs())))

    def graphs_dryrun():
        """``dryrun_multichip``'s six cases through ``jit_epochs`` (and
        ``jit_epochs_scheduled``), 2 epochs each."""
        from stochqn_tpu_torch.models.losses import (
            multinomial_logistic_grad, multinomial_logistic_loss)
        out = {}
        for name, (opt, shape, _, cfg_kw) in DRYRUN.items():
            x0, data = dryrun_data(name)
            n_data = shape[0]
            reg = DRYRUN_REG / n_data   # summed over the data ranks: once
            if name == "sparse_2x2":
                def grad_fn(x, b):
                    return sp.sparse_multinomial_logistic_grad(
                        x, b[0], b[1], b[2], 63, reg_param=reg)
                data = (T(data[0]), T(data[1]), T(data[2]))
            else:
                def grad_fn(x, b):
                    return multinomial_logistic_grad(x, b[0], b[1], None, reg)

            def obj_fn(x, b):
                return multinomial_logistic_loss(x, b[0], b[1], None, reg)
            cfg = {"SQN": SQNConfig, "adaQN": AdaQNConfig,
                   "oLBFGS": OLBFGSConfig}[opt].create(**cfg_kw)

            def make(m, opt=opt, cfg=cfg, grad_fn=grad_fn):
                return FusedTrainer(opt, cfg, grad_fn, mesh=m,
                                    obj_fn=obj_fn if opt == "adaQN" else None)
            if name == "scheduled_2x2":
                flat, orders, steps = data
                flat, orders, steps = (T(flat[0]), T(flat[1])), T(orders), \
                    T(steps)
                bs = DRYRUN[name][2][2]

                def run_eager(tr, st):
                    return tr.epochs_scheduled(st, flat, steps, orders, bs,
                                               aligned=True)

                def run_graph(tr, st):
                    return tr.jit_epochs_scheduled()(st, flat, steps, orders,
                                                     bs, aligned=True)
            else:
                data = shard_batches(tuple(T(a) for a in data), mesh(shape))

                def run_eager(tr, st, data=data):
                    return tr.epochs(st, data, DRYRUN_STEP, 2, aligned=True)

                def run_graph(tr, st, data=data):
                    return tr.jit_epochs()(st, data, DRYRUN_STEP, 2,
                                           aligned=True)
            res = programs(make, shape, T(x0), run_eager, run_graph)
            out.update({f"{name}_{k}": v for k, v in res.items()})
        return out

    def graphs_grid():
        """SQN, adaQN and oLBFGS (bfloat16 interleaved pairs) on meshes
        4 x 1, 1 x 4 and 2 x 2: ``jit_epochs`` for 2 epochs, then
        ``jit_epoch`` at another step on the cached graph."""
        a_np, x0, data_np = grid_data()
        a = T(a_np)

        def grad_fn(x, b):
            return a @ (x - b.mean(0))

        def obj_fn(x, b):       # a mean over the rows, as "mean" sums it
            r = x[None, :] - b
            return 0.5 * torch.einsum("bi,ij,bj->b", r, a, r).mean()
        out = {}
        for name, (opt, shape, cfg_kw) in GRID.items():
            cfg = {"SQN": SQNConfig, "adaQN": AdaQNConfig,
                   "oLBFGS": OLBFGSConfig}[opt].create(**cfg_kw)

            def make(m, opt=opt, cfg=cfg):
                return FusedTrainer(opt, cfg, grad_fn, obj_fn=obj_fn, mesh=m,
                                    reduction="mean")
            data = shard_batches(T(data_np), mesh(shape))

            def run(epochs, epoch, st):
                st, i1 = epochs(st, data, GRID_STEPS[0], 2)
                st, i2 = epoch(st, data, GRID_STEPS[1])
                return st, torch.cat([i1, i2[None]])
            res = programs(
                make, shape, T(x0),
                lambda tr, st: run(tr.epochs, tr.epoch, st),
                lambda tr, st: run(tr.jit_epochs(), tr.jit_epoch(), st))
            out.update({f"{name}_{k}": v for k, v in res.items()})
        return out

    def graphs_order():
        """Epochs that start at other phases (5 batches, L = 2; an epoch of
        3 batches first): every rank replays the same layouts in the same
        order, as the eager epochs take them."""
        a_np, x0, data_np = grid_data()
        a = T(a_np)

        def grad_fn(x, b):
            return a @ (x - b.mean(0))
        shape = (2, 2)
        data = shard_batches(T(data_np[:5]), mesh(shape))

        def make(m):
            return FusedTrainer("SQN", SQNConfig.create(
                **GRID_OPTIMIZERS["SQN"]), grad_fn, mesh=m, reduction="mean")

        def run(epoch, epochs, st):
            st, i1 = epoch(st, data[:3], GRID_STEPS[0])
            st, i2 = epochs(st, data, GRID_STEPS[1], 3)
            return st, torch.cat([i1, i2.reshape(-1)])
        REPLAYED.clear()
        res = programs(make, shape, T(x0),
                       lambda tr, st: run(tr.epoch, tr.epochs, st),
                       lambda tr, st: run(tr.jit_epoch(), tr.jit_epochs(),
                                          st))
        res["layouts"] = np.array(REPLAYED, np.int64)
        return res

    cases = {
        "parallel": [("dp_eval", dp_eval), ("two_loop_param", two_loop_param),
                     ("fused_epoch", fused_epoch),
                     ("adaqn_coupling", adaqn_coupling),
                     ("scheduled", scheduled), ("sparse_sqn", sparse_sqn),
                     ("logistic", logistic), ("guided", guided),
                     ("minimize", minimize_case), ("recorder", recorder),
                     ("guard", guard), ("layouts", layouts),
                     ("graphs_dryrun", graphs_dryrun),
                     ("graphs_grid", graphs_grid),
                     ("graphs_order", graphs_order)]
        + [(name, lambda name=name: budget(name)) for name in BUDGETS],
        "dist2": [(f"{opt}_{topo}", lambda opt=opt, shape=shape:
                   dist_case(opt, shape))
                  for opt in ("SQN", "adaQN", "oLBFGS")
                  for topo, shape in (("dp", (2, 1)), ("param", (1, 2)))]
        + [("slices", slices)],
        "dist4": [(f"SQN_{topo}", lambda shape=shape: dist_case("SQN", shape))
                  for topo, shape in (("2x2", (2, 2)), ("4x1", (4, 1)))],
    }
    return cases, sharded_checkpoint


def scheduled_orders(n_rows, nepochs):
    rng = np.random.default_rng(10)
    return np.stack([rng.permutation(n_rows) for _ in range(nepochs)])


def sparse_problem(nf, C, k, bs, B):
    """Rows of ``k // 2`` nonzeros as padded COO ``[B, bs, k]``, one-hot
    labels and ``x0``."""
    rng = np.random.default_rng(12)
    dense = np.zeros((B * bs, nf), np.float32)
    for r in range(B * bs):
        cols = rng.choice(nf, size=k // 2, replace=False)
        dense[r, cols] = rng.standard_normal(k // 2)
    idx = np.zeros((B * bs, k), np.int64)
    val = np.zeros((B * bs, k), np.float32)
    for r in range(B * bs):
        nz = np.flatnonzero(dense[r])
        idx[r, :nz.size], val[r, :nz.size] = nz, dense[r, nz]
    hot = np.eye(C, dtype=np.float32)[rng.integers(0, C, B * bs)]
    x0 = rng.standard_normal((nf + 1) * C).astype(np.float32)
    return (idx.reshape(B, bs, k), val.reshape(B, bs, k),
            hot.reshape(B, bs, C), x0)


# the guided callables: a mean least-squares loss with the penalty inside
# the mean's call (reduction="mean" is exact for it); they take numpy arrays
# and tensors alike
def ls_obj_torch(x, X, y, sample_weight=None):
    r = X @ x - y
    return 0.5 * (r * r).mean() + 0.5 * GUIDED_REG * (x * x).sum()


def ls_grad_torch(x, X, y, sample_weight=None):
    return X.T @ (X @ x - y) / y.shape[0] + GUIDED_REG * x


def ls_hvp_torch(x, v, X, y, sample_weight=None):
    return X.T @ (X @ v) / y.shape[0] + GUIDED_REG * v


SUITES = ("parallel", "dist2", "dist4")


def main(argv):
    suite, rank, world, init_file, out_dir = argv
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO)
    from stochqn_tpu_torch.parallel import distributed
    distributed.initialize(init_method=f"file://{init_file}",
                           world_size=world, rank=rank, device_type="cpu")
    cases, sharded_checkpoint = _torch_cases()
    todo = list(cases[suite])
    if suite == "dist2":
        todo.append(("checkpoint", lambda: sharded_checkpoint(out_dir)))
    for name, fn in todo:
        t0 = time.perf_counter()
        result = fn()
        np.savez(os.path.join(out_dir, f"{name}.r{rank}.npz"), **result)
        print(f"[rank {rank}] {name} {time.perf_counter() - t0:.2f} s",
              flush=True)
    torch.distributed.destroy_process_group()


def run_suite(suite, world, out_dir, timeout=300):
    """Start ``world`` workers of ``suite`` writing into ``out_dir``; wait
    for all.  Returns ``(returncodes, logs)``."""
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r), str(world),
         init_file, out_dir], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0] + "\n(timed out)")
    return [p.returncode for p in procs], logs


def suite_results(suite, world, base_dir):
    """Run ``suite`` once per test session and return ``(out_dir, info)``
    with ``info`` the return codes and logs.  Under pytest-xdist every
    worker that needs the suite calls this with the session's shared
    directory: the first runs the cluster under a file lock, the others
    wait for it and read what it wrote."""
    import fcntl
    import json
    out = os.path.join(base_dir, f"torch_{suite}")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = os.path.join(out, "done.json")
        if not os.path.exists(done):
            rcs, logs = run_suite(suite, world, out)
            with open(done, "w") as f:
                json.dump({"rcs": rcs, "logs": logs}, f)
        with open(done) as f:
            return out, json.load(f)


def load_case(out_dir, info, case, world):
    """Every rank's results of ``case``: a list of dicts; a case a rank
    did not finish fails with the logs."""
    paths = [os.path.join(out_dir, f"{case}.r{r}.npz") for r in range(world)]
    if not all(os.path.exists(p) for p in paths):
        raise AssertionError(
            f"case {case} did not finish on every rank (return codes "
            f"{info['rcs']}):\n" + "\n".join(log[-3000:]
                                             for log in info["logs"]))
    out = []
    for p in paths:
        with np.load(p) as f:
            out.append({k: f[k] for k in f.files})
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
