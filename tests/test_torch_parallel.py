"""The PyTorch port's sharded execution on the CPU, against the JAX
package: the counterparts of ``tests/test_parallel.py``.

One gloo cluster of 4 ranks (``tests/torch_dist_worker.py``, suite
``parallel``) runs every case once per session, on meshes 4 x 1 (data
only), 1 x 4 (param only) and 2 x 2; each test reads what the ranks wrote
and holds it against the JAX package's unsharded result on the same numpy
inputs, at ``tests/test_parallel.py``'s tolerances, float64 where that
test runs float64.

The collective budgets come from the port's recorder
(``parallel.record_collectives``), where the JAX tests parse compiled HLO
(``parallel/hlo_stats.py``, whose three parser tests have no counterpart).
They differ from the JAX budgets in one way, by design: GSPMD partitions
the user's gradient over a sharded parameter axis, while the port's user
function sees the full ``x``, so every gradient evaluation on such an
axis first gathers ``x`` (one all-gather of ``n`` values) and then sums
this rank's slice of the gradient over the data axis (``n / n_param``
values).  Everything else a step or a boundary reduces is O(m) scalars.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as tw
from stochqn_tpu import api as japi
from stochqn_tpu import guided as jg
from stochqn_tpu.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu.core.state import BFGSMemory
from stochqn_tpu.fused import FusedTrainer
from stochqn_tpu.models.logistic import StochasticLogisticRegression as JaxLR
from stochqn_tpu.models.sparse import sparse_multinomial_logistic_grad
from stochqn_tpu.ops.pairs import commit_pair
from stochqn_tpu.ops.two_loop import two_loop, two_loop_cached

WORLD = 4


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return tw.suite_results("parallel", WORLD, str(base))


def _case(suite, name):
    return tw.load_case(*suite, name, WORLD)


def _same_on_every_rank(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(results[0][key], r[key])
    return results[0][key]


# -- data-parallel evaluation (test_parallel.py:25, :40, :56) ----------------
@pytest.mark.parametrize("key", ("sum_grad", "grad", "value", "hvp",
                                 "mean_grad"))
def test_data_parallel_evaluation_matches_local(suite, key):
    x, v, batch = (jnp.asarray(a) for a in tw.dp_problem(0, 10, 16))
    a = jnp.asarray(tw.quad(1, 10))

    def grad_fn(x, b):
        return (a @ (x[:, None] - b.T)).sum(axis=1)

    def obj_fn(x, b):
        r = x[None, :] - b
        return 0.5 * jnp.einsum("bi,ij,bj->", r, a, r)
    want = {"sum_grad": jnp.sum(batch, axis=0),
            "grad": grad_fn(x, batch),
            "value": obj_fn(x, batch),
            "hvp": jax.jvp(lambda xx: grad_fn(xx, batch), (x,), (v,))[1],
            "mean_grad": a @ (x - jnp.mean(batch, axis=0))}[key]
    got = _same_on_every_rank(_case(suite, "dp_eval"), key)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10)


def test_data_parallel_sum_leaves_the_functions_result_alone(suite):
    """The data sum runs on a copy: a value a user's function returned
    (and may keep) is not overwritten by the sum of the ranks' values."""
    for r in _case(suite, "dp_eval"):
        assert bool(r["value_kept"])


# -- the uncached two-loop on a sharded param axis (:82, :125) ---------------
@pytest.mark.parametrize("size", ("small", "budget"))
def test_two_loop_param_sharded_matches(suite, size):
    n, m = {"small": (64, 5), "budget": (512, 6)}[size]
    s, y, g, diag = (jnp.asarray(a) for a in tw.pairs_problem(2, n, m))
    results = _case(suite, "two_loop_param")
    ref = np.asarray(two_loop(g, s, y, 0, m))
    np.testing.assert_allclose(_same_on_every_rank(results, size), ref,
                               rtol=1e-10)
    np.testing.assert_allclose(
        _same_on_every_rank(results, size + "_diag"),
        np.asarray(two_loop(g, s, y, 0, m, diag=diag)), rtol=1e-10)
    # the projection kernel's route (its plain version on the CPU) on this
    # rank's columns, in float32
    np.testing.assert_allclose(_same_on_every_rank(results, size + "_kernel"),
                               ref, rtol=1e-4, atol=1e-5)
    # W g and W W^T in ONE all-reduce (the JAX test allows 3)
    assert int(results[0][size + "_allreduces"]) == 1


# -- a sharded fused epoch against the JAX unsharded one (:101) --------------
def test_fused_trainer_sharded_epoch_matches_unsharded(suite):
    n, B, bs, L = 16, 8, 8, 4
    a = jnp.asarray(tw.quad(3, n))

    def grad_fn(x, batch):
        return a @ (x - jnp.mean(batch, axis=0))
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=3, bfgs_upd_freq=L),
                      grad_fn)
    data = jnp.asarray(tw.batches(4, (B, bs, n), np.float64))
    st, infos = jax.jit(tr.epoch)(tr.init(jnp.zeros(n)), data, 0.05)
    results = _case(suite, "fused_epoch")
    np.testing.assert_allclose(_same_on_every_rank(results, "x"),
                               np.asarray(st.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(results[0]["infos"], np.asarray(infos))
    assert int(results[0]["niter"]) == B


# -- adaQN couplings (:147) ---------------------------------------------------
def test_param_sharded_adaqn_coupling_allreduce_counts(suite):
    """The gram coupling's n-contractions are independent and share one
    all-reduce; the matvec coupling's projection -> alpha -> Y u2 chain
    needs two.  The projection kernel's route sums what it projects in
    one, as the gram coupling does."""
    n, m = 512, 4
    s, y, g, diag = (jnp.asarray(a)
                     for a in tw.pairs_problem(5, n, m, np.float32))
    mem = BFGSMemory.create(m, n, jnp.float32)
    for i in range(m):
        mem = mem.replace(s_pending=s[i])
        mem, _ = commit_pair(mem, y[i], 1e-8, 0.0)
    results = _case(suite, "adaqn_coupling")
    counts = {k: int(results[0][k + "_allreduces"])
              for k in ("matvec", "gram", "gram_kernel")}
    assert counts == {"matvec": 2, "gram": 1, "gram_kernel": 1}
    for key, coupling in (("matvec", "matvec"), ("gram", "gram"),
                          ("gram_kernel", "gram")):
        ref = np.asarray(two_loop_cached(g, mem, diag=diag,
                                         coupling=coupling))
        np.testing.assert_allclose(_same_on_every_rank(results, key), ref,
                                   rtol=1e-4, atol=1e-5)


# -- per-step collective budgets (:223 - :575) -------------------------------
def _budget(results, phase):
    """This phase's recorded collectives on rank 0, and every rank's the
    same."""
    r0 = results[0]
    for r in results[1:]:
        for k in ("kinds", "nbytes", "groups"):
            np.testing.assert_array_equal(r[f"{phase}_{k}"],
                                          r0[f"{phase}_{k}"])
    return (r0[f"{phase}_kinds"], r0[f"{phase}_nbytes"],
            r0[f"{phase}_groups"], str(r0[f"{phase}_labels"]).split("|"))


def _check_budget(kinds, nbytes, groups, labels, n, n_data, n_param,
                  evals, slices=None, gathered_vectors=1, small_max=1024):
    """``evals`` function evaluations, each with one all-gather of
    ``gathered_vectors`` x n float32 over the param axis (none where it
    has one rank); ``slices`` (default ``evals``) of them vector-valued,
    each with one sum of n / n_param values over the data axis; every
    other collective small."""
    slices = evals if slices is None else slices
    big = [i for i, lab in enumerate(labels)
           if lab.startswith("gather") or lab in ("grad", "hvp")]
    gathers = [i for i in big if kinds[i] == 1]
    sums = [i for i in big if kinds[i] == 0]
    assert len(sums) == slices, labels
    assert all(nbytes[i] == n * 4 // n_param and groups[i] == n_data
               for i in sums), (nbytes, groups, labels)
    if n_param == 1:
        assert not gathers, labels
    else:
        assert len(gathers) == evals, labels
        assert all(nbytes[i] == gathered_vectors * n * 4
                   and groups[i] == n_param for i in gathers)
    small = [i for i in range(len(labels)) if i not in big]
    assert all(groups[i] in (n_data, n_param) for i in small)
    assert sum(nbytes[i] for i in small) <= small_max, (nbytes, labels)
    assert all(nbytes[i] < n for i in small)
    return [labels[i] for i in small]


def test_collective_bytes_data_parallel_step(suite):
    """Pure data parallelism (4 x 1): the only per-step collective is the
    gradient's all-reduce, exactly n * 4 payload bytes over the 4 data
    ranks; the boundary adds the Hessian-vector product's, the same
    size."""
    results = _case(suite, "dp_sqn_step")
    kinds, nbytes, groups, labels = _budget(results, "step")
    assert labels == ["grad"] and list(nbytes) == [512 * 4]
    assert list(groups) == [4] and list(kinds) == [0]
    kinds, nbytes, groups, labels = _budget(results, "boundary")
    assert labels == ["hvp"] and list(nbytes) == [512 * 4]


def test_collective_bytes_param_only_adaqn_step(suite):
    """Param only (1 x 4), adaQN matvec coupling: besides the gradient's
    gather and slice, the two-loop's two dependent sums and the guard's,
    O(m) bytes, independent of n; the boundary's guard value, Fisher
    product and commit the same."""
    results = _case(suite, "param_adaqn_step")
    small = _check_budget(*_budget(results, "step"), n=4096, n_data=1,
                          n_param=4, evals=1)
    assert small == ["two_loop", "two_loop", "guard"]
    small = _check_budget(*_budget(results, "boundary"), n=4096, n_data=1,
                          n_param=4, evals=1, slices=0)
    assert small == ["value", "fisher_y", "commit"]


def test_collective_bytes_mixed_mesh_sqn_round(suite):
    """2 x 2: per step the gathered x, the gradient's slice over the data
    axis and two small sums (the split route's W g, the guard); per
    boundary x and s gathered together, the Hessian-vector product's
    slice and the commit's one sum."""
    results = _case(suite, "mixed_sqn_round")
    small = _check_budget(*_budget(results, "step"), n=512, n_data=2,
                          n_param=2, evals=1)
    assert small == ["two_loop", "guard"]
    small = _check_budget(*_budget(results, "boundary"), n=512, n_data=2,
                          n_param=2, evals=1, gathered_vectors=2)
    assert small == ["commit"]


def test_collective_bytes_olbfgs_step_mixed_mesh(suite):
    """oLBFGS on 2 x 2: two gradient evaluations per step, then the
    commit's curvature and Gram sums in ONE all-reduce."""
    small = _check_budget(*_budget(_case(suite, "mixed_olbfgs_step"),
                                   "step"), n=512, n_data=2, n_param=2,
                          evals=2)
    assert small == ["two_loop", "guard", "commit"]


def test_collective_bytes_bf16_interleaved_olbfgs_param_sharded(suite):
    """bfloat16 interleaved pairs on 1 x 4: the per-step payload besides
    the gradients is O(m) scalars, never the pair buffer; and one more
    sharded epoch from the warm state matches the JAX unsharded one."""
    results = _case(suite, "bf16_olbfgs_param")
    small = _check_budget(*_budget(results, "step"), n=4096, n_data=1,
                          n_param=4, evals=2)
    assert small == ["two_loop", "guard", "commit"]
    n, bs = 4096, 8
    a_diag = jnp.asarray(tw.diag_quad(6, n))

    def grad_fn(x, batch):
        return a_diag * (x - jnp.mean(batch, axis=0))
    cfg = OLBFGSConfig.create(mem_size=3, min_curvature=1e-8,
                              pairs_bf16=True, pairs_interleaved=True)
    tr = FusedTrainer("oLBFGS", cfg, grad_fn)
    data = jnp.asarray(tw.batches(1, (4, bs, n)))
    st, _ = tr.epoch(tr.init(jnp.zeros(n, jnp.float32)), data, 0.05)
    st, _ = jax.jit(tr.epoch)(st, data, 0.05)
    np.testing.assert_allclose(
        _same_on_every_rank(results, "x_next_epoch"), np.asarray(st.x),
        rtol=1e-3, atol=1e-4)


def test_collective_bytes_bf16_fisher_adaqn_param_sharded(suite):
    """adaQN with bfloat16 pair and Fisher rows on 1 x 4: the step's and
    the boundary's sums (Fisher products, guard, commit) stay O(m); the
    [fisher_size, n] buffer never crosses the mesh."""
    results = _case(suite, "bf16_fisher_adaqn_param")
    _check_budget(*_budget(results, "step"), n=4096, n_data=1, n_param=4,
                  evals=1)
    small = _check_budget(*_budget(results, "boundary"), n=4096, n_data=1,
                          n_param=4, evals=1, slices=0)
    assert small == ["value", "fisher_y", "commit"]


# -- the scheduled whole fit (:401) -------------------------------------------
def test_scheduled_whole_fit_sharded_matches_unsharded(suite):
    n, n_rows, bs, L, m, nepochs = 64, 64, 8, 2, 3, 3
    a_diag = jnp.asarray(tw.diag_quad(8, n, np.float64))

    def grad_fn(x, batch):
        return a_diag * (x - jnp.mean(batch[0], axis=0))
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=m, bfgs_upd_freq=L),
                      grad_fn)
    flat = jnp.asarray(tw.batches(9, (n_rows, n), np.float64))
    orders = jnp.asarray(tw.scheduled_orders(n_rows, nepochs), jnp.int32)
    steps = jnp.asarray([0.05 / np.sqrt(e + 1.0) for e in range(nepochs)])
    st, infos = tr.jit_epochs_scheduled()(
        tr.init(jnp.zeros(n)), (flat,), steps, orders, batch_size=bs,
        aligned=True)
    results = _case(suite, "scheduled")
    np.testing.assert_allclose(_same_on_every_rank(results, "x"),
                               np.asarray(st.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(results[0]["infos"], np.asarray(infos))
    assert int(results[0]["niter"]) == nepochs * (n_rows // bs)


# -- padded-COO sparse SQN (:578) ---------------------------------------------
def test_sparse_sqn_sharded_epoch_matches_and_budget(suite):
    nf, C, k, bs, B, L, m = 256, 4, 8, 16, 8, 4, 3
    idx, val, hot, x0 = tw.sparse_problem(nf, C, k, bs, B)

    def grad_fn(x, batch):
        i, v, Y = batch
        return sparse_multinomial_logistic_grad(x, i, v, Y, nf,
                                                reg_param=1e-1)
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=m, bfgs_upd_freq=L),
                      grad_fn)
    data = (jnp.asarray(idx, jnp.int32), jnp.asarray(val), jnp.asarray(hot))
    st, infos = jax.jit(tr.epoch)(tr.init(jnp.asarray(x0)), data, 0.05)
    results = _case(suite, "sparse_sqn")
    np.testing.assert_allclose(_same_on_every_rank(results, "x"),
                               np.asarray(st.x), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(results[0]["infos"], np.asarray(infos))
    assert int(results[0]["niter"]) == B
    n = (nf + 1) * C
    small = _check_budget(*_budget(results, "step"), n=n, n_data=2,
                          n_param=2, evals=1)
    assert small == ["two_loop", "guard"]


# -- the front ends: the regulariser and a non-dividing data axis ------------
def test_logistic_sharded_fit_counts_the_penalty_once(suite):
    """reg_param = 0.1 on a 2 x 2 mesh (two data ranks): the sharded fit
    is the unsharded one (each rank carries half the penalty; summed as
    it stands the penalty would count twice), and the JAX package's
    unshuffled fit; shuffled, every rank draws the same permutations, so
    the sharded fit is the unsharded port's."""
    X, Y = tw.logistic_problem()
    results = _case(suite, "logistic")
    ref = JaxLR(dtype=np.float64, shuffle_data=False,
                **tw.LOGISTIC_KW).fit(X, Y)
    fixed = _same_on_every_rank(results, "fixed")
    np.testing.assert_allclose(fixed, results[0]["fixed_plain"], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(fixed, np.asarray(ref.x_), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(_same_on_every_rank(results, "shuffled"),
                               results[0]["shuffled_plain"], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(results[0]["fixed_predict"],
                                  ref.predict(X))


def test_logistic_mesh_fit_takes_no_shared_program(suite):
    """A fit on a mesh builds a trainer of its own, outside the fused fits'
    shared programs: it counts as neither built nor reused."""
    for r in _case(suite, "logistic"):
        for key in ("fixed", "shuffled"):
            np.testing.assert_array_equal(r[key + "_programs"], [0, 0])


def test_logistic_non_dividing_data_axis_raises(suite):
    """Batches of 6 rows on 4 data ranks: the port raises (the JAX package
    replicates such a batch, which a sum over the data axis would count
    4 times)."""
    for r in _case(suite, "logistic"):
        assert "data axis (4) must divide the 6 rows" in str(r["nondividing"])


def test_guided_sharded_fit_matches_jax_and_partial_fit_continues(suite):
    """The guided SQN's fused fit on 2 x 2 (shuffled: numpy's order on
    every rank; one scheduled dispatch) against the JAX package's fused
    fit, then ``partial_fit`` from the gathered state as after an
    unsharded fit."""
    X, y = tw.ls_problem()
    results = _case(suite, "guided")
    j = jg.SQN(np.zeros(X.shape[1]), tw.ls_grad_torch, tw.ls_obj_torch,
               tw.ls_hvp_torch, batches_per_epoch=4, step_size=0.05,
               nepochs=3, mem_size=3, bfgs_upd_freq=2, verbose=False)
    j.fit(X, y, engine="fused")
    r0 = results[0]
    assert str(r0["sharded_mode"]) == "scheduled"
    np.testing.assert_allclose(_same_on_every_rank(results, "sharded"),
                               np.asarray(j.x), rtol=1e-8, atol=1e-10)
    j.partial_fit(X[:16], y[:16])
    np.testing.assert_allclose(_same_on_every_rank(results,
                                                   "sharded_partial"),
                               np.asarray(j.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(r0["sharded_partial"], r0["plain_partial"],
                               rtol=1e-9, atol=1e-12)
    assert int(r0["sharded_niter"]) == int(r0["plain_niter"]) == j.niter
    for mode in ("invariant", "loop"):      # the other dispatch modes
        assert str(r0[mode + "_sharded_mode"]) == mode
        np.testing.assert_allclose(
            _same_on_every_rank(results, mode + "_sharded"),
            r0[mode + "_plain"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("optimizer", ("SQN", "adaQN"))
def test_minimize_sharded_matches_jax(suite, optimizer):
    X, y = tw.ls_problem()

    def loss_fn(x, b):
        r = b[0] @ x - b[1]
        return 0.5 * jnp.mean(r * r) + 0.5 * tw.GUIDED_REG * jnp.dot(x, x)
    kw = dict(optimizer=optimizer, step_size=0.05, batch_size=16, nepochs=3,
              mem_size=3, bfgs_upd_freq=2, tol=1e-12)
    if optimizer == "adaQN":
        kw.update(fisher_size=4, rmsprop_weight=0.9)
    ref = japi.minimize(loss_fn, jnp.zeros(X.shape[1]),
                        (jnp.asarray(X), jnp.asarray(y)), **kw)
    results = _case(suite, "minimize")
    np.testing.assert_allclose(_same_on_every_rank(results, optimizer),
                               np.asarray(ref.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(results[0][optimizer + "_losses"],
                               np.asarray(ref.losses), rtol=1e-8)
    if optimizer == "SQN":      # a dict of parameters: the same steps
        np.testing.assert_allclose(
            _same_on_every_rank(results, "SQN_tree"), results[0]["SQN"],
            rtol=1e-12, atol=1e-14)


def test_guard_threshold_uses_the_global_n(suite):
    """||d|| = 32,000 over n = 64 on 1 x 4: within 1e3 * n for the whole
    vector (a slice's n, 16, would call it bad); a NaN on one rank's
    slice makes the direction bad on every rank."""
    for r in _case(suite, "guard"):
        assert not bool(r["bad"])
        assert bool(r["bad_nan"])


def test_sharded_layouts_match_jax(suite):
    """Interleaved ring-mode commits on 1 x 4 (SQN, 2 epochs), paired
    oLBFGS gradients on 2 x 2, and adaQN's generic layout (6 batches, L =
    4) with a validation set for its guard on 2 x 2 (2 epochs), each
    against the JAX package's unsharded run."""
    n = 16
    a_diag = jnp.asarray(tw.diag_quad(13, n, np.float64))

    def grad_fn(x, b):
        return a_diag * (x - jnp.mean(b, axis=0))

    def obj_fn(x, b):
        r = x - jnp.mean(b, axis=0)
        return 0.5 * jnp.vdot(r, a_diag * r)
    data = jnp.asarray(tw.batches(14, (6, 8, n), np.float64))
    x0 = jnp.zeros(n)
    results = _case(suite, "layouts")

    tr = FusedTrainer("SQN", SQNConfig.create(
        mem_size=3, bfgs_upd_freq=2, pairs_interleaved=True), grad_fn)
    st = tr.init(x0)
    st = st.replace(mem=st.mem.replace(shift=False))
    for _ in range(2):
        st, _ = tr.epoch(st, data, 0.05)
    np.testing.assert_allclose(_same_on_every_rank(results, "ring"),
                               np.asarray(st.x), rtol=1e-8, atol=1e-10)

    tr = FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=3), grad_fn,
                      paired_grads=True)
    st, infos = tr.epoch(tr.init(x0), data, 0.05)
    np.testing.assert_allclose(_same_on_every_rank(results, "paired"),
                               np.asarray(st.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(results[0]["paired_infos"],
                                  np.asarray(infos))

    val = jnp.asarray(tw.batches(15, (8, n), np.float64))
    tr = FusedTrainer("adaQN", AdaQNConfig.create(
        mem_size=3, fisher_size=4, bfgs_upd_freq=4, max_incr=1.01,
        rmsprop_weight=0.9), grad_fn, obj_fn=obj_fn, val_data=val)
    st = tr.init(x0)
    for _ in range(2):
        st, infos = tr.epoch(st, data, 0.1)
    np.testing.assert_allclose(_same_on_every_rank(results, "adaqn_generic"),
                               np.asarray(st.x), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(results[0]["adaqn_generic_infos"],
                                  np.asarray(infos))


# -- the recorder (the counterpart of the hlo_stats parser tests) ------------
def test_recorder_logs_kind_bytes_group_and_label(suite):
    """An all-reduce of 6 float64 (48 bytes) over the data axis, an
    all-gather of [2, 3] float32 shards over the param axis (the padded
    [2, 6] buffer it all-reduces: 48 bytes) in a nested recorder, and two
    independent sums in one all-reduce (5 float32): the outer log holds
    all three in order, the inner only the gather."""
    for r in _case(suite, "recorder"):
        assert list(r["outer"]) == [48, 48, 20]
        assert list(r["outer_kinds"]) == [0, 1, 0]
        assert list(r["outer_groups"]) == [2, 2, 2]
        assert str(r["outer_labels"]) == "a|b|c"
        assert list(r["inner"]) == [48]
        assert int(r["bytes_a"]) == 48 and int(r["n_ops"]) == 3
        np.testing.assert_array_equal(r["reduced"], np.full(6, 2.0))
        np.testing.assert_array_equal(r["gathered"],
                                      np.array([[0, 0, 0, 1, 1, 1]] * 2))
