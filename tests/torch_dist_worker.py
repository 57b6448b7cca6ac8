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
    from stochqn_tpu_torch.utils import checkpoint

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
        for shuffle in (False, True):
            key = "shuffled" if shuffle else "fixed"
            sharded = StochasticLogisticRegression(
                mesh=m, shuffle_data=shuffle, **kw).fit(X, Y)
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

    cases = {
        "parallel": [("dp_eval", dp_eval), ("two_loop_param", two_loop_param),
                     ("fused_epoch", fused_epoch),
                     ("adaqn_coupling", adaqn_coupling),
                     ("scheduled", scheduled), ("sparse_sqn", sparse_sqn),
                     ("logistic", logistic), ("guided", guided),
                     ("minimize", minimize_case), ("recorder", recorder),
                     ("guard", guard), ("layouts", layouts)]
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
