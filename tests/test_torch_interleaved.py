"""The torch port's interleaved pair layout against the JAX package:
``BFGSMemoryInterleaved`` with its two commit modes, the interleaved
small-math cache, the collapsed direction on the interleaved buffer, and
SQN with ``pairs_interleaved=True`` in the fused engine and in free mode.

Inputs are made with numpy and handed to both packages.  Tolerances:
float64 to its rounding (rtol 1e-10 on the memory, where both sides run
the same products in their own summation orders); float32 as in
``tests/test_torch_pairs.py`` (rtol 2e-5, atol 1e-6: n-length dot
products in different orders, amplified a little by the Neumann inverses
and the c0/cg products).  Shift and ring mode are held to the JAX
package's same mode; the JAX package decides the mode from the buffer's
size, so its ring mode is made with ``create(shift=False)``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu import free as jax_free  # noqa: E402
from stochqn_tpu.core.config import SQNConfig as JaxSQNConfig  # noqa: E402
from stochqn_tpu.core.state import BFGSMemory as JaxMemory  # noqa: E402
from stochqn_tpu.core.state import (  # noqa: E402
    BFGSMemoryInterleaved as JaxInterleaved)
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu.ops import pairs as jpairs  # noqa: E402
from stochqn_tpu.ops.two_loop import two_loop_cached as jax_two_loop  # noqa: E402
from stochqn_tpu_torch import (FusedTrainer, SQN_free, SQNConfig,  # noqa: E402
                               bfgs_memory_interleaved_from_numpy,
                               bfgs_memory_interleaved_to_numpy,
                               sqn_state_from_numpy, sqn_state_to_numpy)
from stochqn_tpu_torch.convert import bfgs_memory_to_numpy  # noqa: E402
from stochqn_tpu_torch.core import sqn  # noqa: E402
from stochqn_tpu_torch.core.state import (BFGSMemory,  # noqa: E402
                                          BFGSMemoryInterleaved,
                                          SHIFT_MAX_BYTES, make_bfgs_memory)
from stochqn_tpu_torch.models import losses as tl  # noqa: E402
from stochqn_tpu_torch.ops import pairs  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel  # noqa: E402
from stochqn_tpu_torch.ops.two_loop import two_loop_cached  # noqa: E402

N = 300
TOL = {"float32": dict(rtol=2e-5, atol=1e-6),
       "float64": dict(rtol=1e-10, atol=1e-12)}
# 8 commits: a curvature rejection and an enabled=False veto in between,
# 6 accepted, so m = 1, 3 and 5 all wrap
SEQUENCE = ["ok", "ok", "reject", "ok", "veto", "ok", "ok", "ok"]


def jax_fields(obj):
    """A JAX state or memory as numpy (nested dicts for nested dataclasses;
    the static ``shift`` as a bool)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (jax_fields(v) if dataclasses.is_dataclass(v)
                       else v if isinstance(v, bool) else np.asarray(v))
    return out


def assert_mem_close(tmem, jmem, dtype):
    got = (bfgs_memory_interleaved_to_numpy(tmem)
           if isinstance(tmem, BFGSMemoryInterleaved)
           else bfgs_memory_to_numpy(tmem))
    want = jax_fields(jmem)
    assert set(got) == set(want)
    for name, ref in want.items():
        if name == "shift":
            assert got[name] is ref
            continue
        assert got[name].dtype == ref.dtype, name
        np.testing.assert_allclose(got[name], ref, err_msg=name, **TOL[dtype])


def memories(layout, m, dtype, n=N):
    """An empty memory of each package in ``layout``: "block", "shift" or
    "ring"."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if layout == "block":
        return JaxMemory.create(m, n, jdt), BFGSMemory.create(m, n, tdt)
    shift = layout == "shift"
    return (JaxInterleaved.create(m, n, jdt, shift=shift),
            BFGSMemoryInterleaved.create(m, n, tdt, shift=shift))


def pair(rng, kind, dtype, n=N):
    s = rng.standard_normal(n)
    y = -s if kind == "reject" else s + 0.3 * rng.standard_normal(n)
    return s.astype(dtype), y.astype(dtype)


def commit_both(jmem, tmem, s, y, enabled=True, y_reg=0.0,
                direction_cache=True, min_curvature=1e-4):
    jmem, jacc = jpairs.commit_pair(
        jmem.replace(s_pending=jnp.asarray(s)), jnp.asarray(y), min_curvature,
        y_reg, enabled=jnp.asarray(enabled), direction_cache=direction_cache)
    tmem, tacc = pairs.commit_pair(
        tmem.replace(s_pending=torch.from_numpy(s)), torch.from_numpy(y),
        min_curvature, y_reg, enabled=torch.tensor(enabled),
        direction_cache=direction_cache)
    assert bool(tacc) == bool(jacc)
    return jmem, tmem, bool(tacc)


def committed(layout, m, dtype, commits, seed=21, direction_cache=True):
    jmem, tmem = memories(layout, m, dtype)
    rng = np.random.default_rng(seed)
    for _ in range(commits):
        s, y = pair(rng, "ok", dtype)
        jmem, tmem, _ = commit_both(jmem, tmem, s, y,
                                    direction_cache=direction_cache)
    return jmem, tmem


# --- the memory and its commits ---------------------------------------------
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("layout", ["block", "shift", "ring"])
@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("direction_cache", [True, False],
                         ids=["sqn_cache", "olbfgs_cache"])
def test_commit_sequence_matches_jax(m, layout, dtype, direction_cache):
    """Accepts, a curvature rejection and a veto, into every layout: the
    whole memory (pair rows, Gram, indices, every cache field) after every
    commit, against the JAX package's same layout and mode."""
    jmem, tmem = memories(layout, m, dtype)
    assert_mem_close(tmem, jmem, dtype)
    rng = np.random.default_rng(7 + m)
    for kind in SEQUENCE:
        s, y = pair(rng, kind, dtype)
        jmem, tmem, acc = commit_both(jmem, tmem, s, y, enabled=kind != "veto",
                                      y_reg=0.1 if m == 3 else 0.0,
                                      direction_cache=direction_cache)
        assert acc == (kind == "ok")
        assert_mem_close(tmem, jmem, dtype)
    assert int(tmem.count) == m
    assert int(tmem.head) == (0 if layout == "shift" else 6 % m)
    if not direction_cache:
        assert not tmem.c0.any() and not tmem.cg.any()


def test_shift_rows_are_newest_first_and_ring_rows_in_place():
    """Shift mode keeps the newest pair at rows 0-1 in a new buffer; ring
    mode writes rows 2*head, 2*head + 1 of the buffer it was given."""
    rng = np.random.default_rng(3)
    _, shift = memories("shift", 3, "float64")
    _, ring = memories("ring", 3, "float64")
    ring_buf = ring.sy
    rows = []
    for _ in range(4):
        s, y = pair(rng, "ok", "float64")
        rows.append((s, y))
        for name in ("shift", "ring"):
            mem = shift if name == "shift" else ring
            mem, _ = pairs.commit_pair(
                mem.replace(s_pending=torch.from_numpy(s)),
                torch.from_numpy(y), 1e-4, 0.0)
            if name == "shift":
                shift = mem
            else:
                ring = mem
    for i, (s, y) in enumerate(reversed(rows[1:])):     # newest first
        np.testing.assert_array_equal(shift.s[i].numpy(), s)
        np.testing.assert_array_equal(shift.y[i].numpy(), y)
    assert ring.sy is ring_buf and int(ring.head) == 1
    np.testing.assert_array_equal(ring.sy[0].numpy(), rows[3][0])  # wrapped
    np.testing.assert_array_equal(ring.sy[3].numpy(), rows[1][1])


def test_create_decides_the_mode_by_size_and_can_be_forced():
    small = BFGSMemoryInterleaved.create(3, 10)
    assert small.shift and small.sy.shape == (6, 10)
    assert small.s.shape == small.y.shape == (3, 10)
    assert not BFGSMemoryInterleaved.create(3, 10, shift=False).shift
    assert SHIFT_MAX_BYTES == 4 * 1024 ** 3      # the JAX package's value
    # the size rule itself, on a meta tensor (no memory): 2m n 4 bytes
    n_over = SHIFT_MAX_BYTES // (2 * 10 * 4) + 1
    assert not BFGSMemoryInterleaved.create(10, n_over, device="meta").shift
    assert isinstance(make_bfgs_memory(2, 5, interleaved=True),
                      BFGSMemoryInterleaved)
    assert isinstance(make_bfgs_memory(2, 5), BFGSMemory)


@pytest.mark.parametrize("cls", [BFGSMemory, BFGSMemoryInterleaved])
def test_flush_resets_only_the_indices(cls):
    mem = cls.create(3, 8, torch.float64)
    rng = np.random.default_rng(5)
    for _ in range(2):
        s, y = pair(rng, "ok", "float64", n=8)
        mem, _ = pairs.commit_pair(mem.replace(s_pending=torch.from_numpy(s)),
                                   torch.from_numpy(y), 1e-4, 0.0)
    flushed = mem.flush()
    assert int(flushed.count) == int(flushed.head) == 0
    assert flushed.gram is mem.gram and flushed.rho is mem.rho


@pytest.mark.parametrize("shift", [True, False], ids=["shift", "ring"])
@pytest.mark.parametrize("head,count", [(0, 0), (0, 2), (1, 3), (2, 4),
                                        (3, 4)])
def test_small_cache_interleaved_order_matches_jax(head, count, shift):
    """``_small_cache`` on one interleaved Gram (a random symmetric
    positive-definite one, so every curvature is positive), both modes,
    with the collapsed matrices scattered to interleaved order."""
    m = 4
    rng = np.random.default_rng(head * 10 + count)
    a = rng.standard_normal((2 * m, 3 * m))
    gram = a @ a.T + np.eye(2 * m)
    if shift:
        head = 0
    want = jpairs._small_cache(jnp.asarray(gram), jnp.int32(head),
                               jnp.int32(count), m, direction_cache=True,
                               interleaved=True, shift=shift)
    got = pairs._small_cache(torch.from_numpy(gram), torch.tensor(head),
                             torch.tensor(count), m, direction_cache=True,
                             interleaved=True, shift=shift)
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("layout", ["shift", "ring"])
def test_converter_round_trip_is_exact(layout):
    jmem, tmem = committed(layout, 3, "float32", 5)
    d = bfgs_memory_interleaved_to_numpy(tmem)
    assert d["shift"] is (layout == "shift") and d["perm"].dtype == np.int32
    back = bfgs_memory_interleaved_to_numpy(
        bfgs_memory_interleaved_from_numpy(d, device="cpu"))
    for name in d:
        np.testing.assert_array_equal(back[name], d[name])
    # and from the JAX memory's own fields
    assert_mem_close(bfgs_memory_interleaved_from_numpy(jax_fields(jmem), "cpu"),
                     jmem, "float32")


# --- the collapsed direction on the interleaved buffer ---------------------
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("layout", ["shift", "ring"])
@pytest.mark.parametrize("n_commits", [1, 3, 6])     # 6 overfills m = 4
@pytest.mark.parametrize("h0", [0.0, 0.5])
def test_collapsed_interleaved_matches_jax(h0, n_commits, layout, dtype):
    """SQN's collapsed direction from an interleaved memory (float32
    through the direction wrappers, which run their plain versions on the
    CPU), against the JAX package's and against the port's own block
    layout on the same pairs."""
    jmem, tmem = committed(layout, 4, dtype, n_commits)
    _, bmem = committed("block", 4, dtype, n_commits)
    g = np.random.default_rng(4).standard_normal(N).astype(dtype)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, h0=h0,
                                   collapsed=True))
    launches = two_loop_kernel.LAUNCHES + two_loop_kernel.DIRECTION_LAUNCHES
    got = two_loop_cached(torch.from_numpy(g), tmem, h0=h0, collapsed=True)
    block = two_loop_cached(torch.from_numpy(g), bmem, h0=h0, collapsed=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (N,)
    tol = (dict(rtol=1e-10, atol=1e-12) if dtype == "float64"
           else dict(rtol=3e-5, atol=1e-5))
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(got.numpy(), block.numpy(), **tol)
    assert (two_loop_kernel.LAUNCHES + two_loop_kernel.DIRECTION_LAUNCHES
            == launches)                                # CPU: plain only


def test_collapsed_empty_interleaved_returns_gradient():
    jmem, tmem = committed("shift", 3, "float32", 3)
    tmem = pairs.conditional_flush(tmem, torch.tensor(True))
    g = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    got = two_loop_cached(torch.from_numpy(g), tmem, collapsed=True)
    np.testing.assert_array_equal(got.numpy(), g)


# --- SQN with pairs_interleaved=True ---------------------------------------
F, C, BS, B, M, L, REG, ETA = 12, 5, 4, 8, 3, 4, 0.1, 0.05


def _data(dtype):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((B, BS, F))
    Y = np.eye(C)[rng.integers(0, C, (B, BS))]
    x0 = 0.1 * rng.standard_normal((F + 1) * C)
    return tuple(a.astype(dtype) for a in (X, Y, x0))


def _jax_grad(x, batch):
    return jl.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def _torch_grad(x, batch):
    return tl.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cfg_kw", [{}, {"use_grad_diff": True}],
                         ids=["hessvec", "grad_diff"])
def test_fused_sqn_interleaved_matches_jax(cfg_kw, dtype):
    """``FusedTrainer("SQN")`` with ``pairs_interleaved=True``, 2 epochs,
    against the JAX package's: info codes, ``x`` and the interleaved
    memory (float32: rtol 1e-4, atol 2e-5 as in
    ``tests/test_torch_fused_sqn.py``; float64: 1e-9)."""
    X, Y, x0 = _data(dtype)
    kw = dict(mem_size=M, bfgs_upd_freq=L, pairs_interleaved=True, **cfg_kw)
    jtr = JaxTrainer("SQN", JaxSQNConfig.create(**kw), _jax_grad)
    ttr = FusedTrainer("SQN", SQNConfig.create(**kw), _torch_grad)
    etas = [ETA] * 2
    jst, jinfos = jtr.jit_epochs()(
        jtr.init(jnp.asarray(x0)), (jnp.asarray(X), jnp.asarray(Y)),
        jnp.asarray(etas, dtype), nepochs=2)
    tst, tinfos = ttr.epochs(ttr.init(torch.from_numpy(x0)),
                             (torch.from_numpy(X), torch.from_numpy(Y)),
                             torch.tensor(etas, dtype=getattr(torch, dtype)),
                             nepochs=2)
    assert isinstance(tst.mem, BFGSMemoryInterleaved) and tst.mem.shift
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert int(tst.mem.count) == int(jst.mem.count) > 1
    tol = (dict(rtol=1e-9, atol=1e-12) if dtype == "float64"
           else dict(rtol=1e-4, atol=2e-5))
    got, want = sqn_state_to_numpy(tst), jax_fields(jst)
    for name in ("x", "x_sum", "x_avg_prev", "grad_prev"):
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)
    for name in ("sy", "gram", "gamma", "c0", "cg", "perm", "count"):
        np.testing.assert_allclose(got["mem"][name], want["mem"][name],
                                   err_msg=f"mem.{name}", **tol)


def test_fused_sqn_interleaved_carry_over_from_jax():
    """One interleaved SQN epoch in JAX, the state moved across with
    ``sqn_state_from_numpy`` (an ``sy`` memory), one more on both sides."""
    X, Y, x0 = _data("float64")
    kw = dict(mem_size=M, bfgs_upd_freq=L, pairs_interleaved=True)
    jtr = JaxTrainer("SQN", JaxSQNConfig.create(**kw), _jax_grad)
    ttr = FusedTrainer("SQN", SQNConfig.create(**kw), _torch_grad)
    data_j = (jnp.asarray(X), jnp.asarray(Y))
    ep = jtr.jit_epochs()
    jst, _ = ep(jtr.init(jnp.asarray(x0)), data_j, jnp.asarray([ETA]),
                nepochs=1)
    tst = sqn_state_from_numpy(jax_fields(jst), device="cpu")
    assert isinstance(tst.mem, BFGSMemoryInterleaved)
    jst, jinfos = ep(jst, data_j, jnp.asarray([ETA]), nepochs=1)
    tst, tinfos = ttr.epochs(tst, (torch.from_numpy(X), torch.from_numpy(Y)),
                             ETA, nepochs=1)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tst.mem.sy.numpy(), np.asarray(jst.mem.sy),
                               rtol=1e-9, atol=1e-12)


class QuadProblem:
    """f_b(x) = 0.5 (x - c_b)^T A (x - c_b) for per-batch centers c_b
    (``tests/test_torch_free.py``)."""

    def __init__(self, seed, n, nbatches=16):
        rng = np.random.default_rng(seed)
        q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        self.a = q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T
        self.centers = rng.standard_normal((nbatches, n))
        self.x0 = rng.standard_normal(n)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sqn_free_interleaved_matches_jax_in_lockstep(dtype):
    """``SQN_free(pairs_interleaved=True)`` against the JAX class on the
    quadratic problem: the same requests and infos at every call, and the
    same points (rtol 1e-10 in float64, 1e-5 in float32)."""
    problem = QuadProblem(1234, 10)
    kw = dict(mem_size=4, bfgs_upd_freq=5, pairs_interleaved=True,
              use_float=dtype == "float32")
    topt = SQN_free(**kw, device="cpu")
    jopt = jax_free.SQN_free(**kw)
    tol = TOL[dtype] if dtype == "float64" else dict(rtol=1e-5, atol=1e-6)
    x_t = problem.x0.astype(dtype)
    x_j = x_t.copy()
    treq, jreq = topt.run_optimizer(x_t, 0.05), jopt.run_optimizer(x_j, 0.05)
    b = 0
    for it in range(150):
        assert treq["task"] == jreq["task"], it
        assert treq["info"] == jreq["info"], it
        np.testing.assert_allclose(x_t, x_j, err_msg=f"call {it}", **tol)
        for opt, req in ((topt, treq), (jopt, jreq)):
            if req["task"] == "calc_grad":
                at = np.asarray(req["requested_on"], np.float64)
                opt.update_gradient(problem.a @ (
                    at - problem.centers[(b + 1) % 16]))
            else:
                opt.update_hess_vec(problem.a @ np.asarray(
                    req["requested_on"][1], np.float64))
        b += treq["task"] == "calc_grad"
        treq, jreq = (topt.run_optimizer(x_t, 0.05),
                      jopt.run_optimizer(x_j, 0.05))
    assert isinstance(topt.state.mem, BFGSMemoryInterleaved)
    assert int(topt.state.mem.count) == 4


def test_sqn_init_builds_the_interleaved_memory():
    st = sqn.init(torch.zeros(7, dtype=torch.float64),
                  SQNConfig.create(mem_size=2, pairs_interleaved=True))
    assert isinstance(st.mem, BFGSMemoryInterleaved)
    assert st.mem.sy.shape == (4, 7) and st.mem.sy.dtype == torch.float64
