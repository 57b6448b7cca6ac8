"""bfloat16 pair and Fisher storage in the torch port against the JAX package.

``pairs_bf16`` stores the (s, y) rows in bfloat16 and ``fisher_bf16`` the
Fisher rows; everything else, and all the math, stays in the iterate's
dtype.  A row is rounded to nearest even when it is written (``jnp.astype``
and ``Tensor.to`` round alike), the Gram columns come from the rounded
rows, and products upcast the stored rows (``_mem_mm``).

Tolerances:

* stored rows: within 1 bfloat16 ulp of the JAX package's (both round
  float32 candidates that differ by a few float32 ulps; on this problem
  they come out equal);
* float32 state after the runs: rtol 1e-4 and atol 2e-5, as
  ``test_torch_fused_sqn.py`` holds float32 (each side sums in its own
  order);
* float64 free mode in lockstep: rtol 1e-10 and atol 1e-12 for SQN, as
  ``test_torch_free.py``, and rtol 1e-8 and atol 1e-10 for oLBFGS, as
  ``test_torch_olbfgs.py``;
* convergence: the JAX package's own checks (the bfloat16 run within 10%
  or 15% of the float32 run's loss), and the port's loss within 1e-4 of
  the JAX bfloat16 run's;
* directions of a bfloat16 commit stream, interleaved against block:
  ``test_interleaved.py``'s rtol 5e-2 and atol 5e-3; port against JAX:
  rtol 1e-5 and atol 1e-6 (the same stored rows, float32 sums).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu import free as jax_free  # noqa: E402
from stochqn_tpu.core import config as jcfg  # noqa: E402
from stochqn_tpu.core import state as jstate  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu.ops import pairs as jpairs  # noqa: E402
from stochqn_tpu.ops.two_loop import (  # noqa: E402
    two_loop_cached as jax_two_loop_cached)
from stochqn_tpu_torch import (AdaQNConfig, BFGSMemory,  # noqa: E402
                               BFGSMemoryInterleaved, FisherMemory,
                               FusedTrainer, OLBFGSConfig, SQNConfig,
                               SQN_free, adaqn_state_from_numpy,
                               adaqn_state_to_numpy, oLBFGS_free,
                               sqn_state_from_numpy, sqn_state_to_numpy)
from stochqn_tpu_torch.core import state as tstate  # noqa: E402
from stochqn_tpu_torch.models import losses as tl  # noqa: E402
from stochqn_tpu_torch.ops import pairs as tpairs  # noqa: E402
from stochqn_tpu_torch.ops import two_loop as ttwo_loop  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402
from test_torch_free import QuadProblem, _drive  # noqa: E402
from test_torch_olbfgs import _drive_free  # noqa: E402

F, C, BS, NB, M, L, REG, ETA = 12, 5, 4, 8, 3, 4, 0.1, 0.05
RTOL, ATOL = 1e-4, 2e-5


def _data():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((NB, BS, F)).astype(np.float32)
    Y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (NB, BS))]
    x0 = (0.1 * rng.standard_normal((F + 1) * C)).astype(np.float32)
    return X, Y, x0


def _jgrad(x, b):
    return jl.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _jobj(x, b):
    return jl.multinomial_logistic_loss(x, b[0], b[1], None, REG)


def _tgrad(x, b):
    return tl.multinomial_logistic_grad(x, b[0], b[1], None, REG)


def _tobj(x, b):
    return tl.multinomial_logistic_loss(x, b[0], b[1], None, REG)


def _ulps(got, want):
    """Largest distance in bfloat16 ulps (at the larger magnitude)."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _jax_rows(mem):
    rows = mem.sy if hasattr(mem, "sy") else jnp.concatenate([mem.s, mem.y])
    return np.asarray(rows.astype(jnp.float32))


def _torch_rows(mem):
    rows = mem.sy if hasattr(mem, "sy") else torch.cat([mem.s, mem.y])
    return rows.float().numpy()


@pytest.fixture
def ring_mode(monkeypatch):
    """Interleaved memories in ring mode on both sides (the mode the
    capacity threshold picks for large buffers)."""
    monkeypatch.setattr(jstate, "SHIFT_MAX_BYTES", 0)
    monkeypatch.setattr(tstate, "SHIFT_MAX_BYTES", 0)


LAYOUTS = ["block", "shift", "ring"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["SQN", "oLBFGS"])
def test_pair_rows_within_one_ulp_of_jax(request, kind, layout):
    """After the first commits (3 live pairs), the stored bfloat16 rows
    agree with the JAX package's to 1 ulp, in every layout; the Gram
    cache, ``x`` and the info codes agree as float32 does."""
    if layout == "ring":
        request.getfixturevalue("ring_mode")
    X, Y, x0 = _data()
    interleaved = layout != "block"
    if kind == "SQN":
        kw, nepochs = dict(mem_size=M, bfgs_upd_freq=L), 2
        jc, tc = jcfg.SQNConfig, SQNConfig
    else:
        kw, nepochs = dict(mem_size=M), 1
        jc, tc = jcfg.OLBFGSConfig, OLBFGSConfig
    kw.update(pairs_bf16=True, pairs_interleaved=interleaved)
    jtr = JaxTrainer(kind, jc.create(**kw), _jgrad)
    ttr = FusedTrainer(kind, tc.create(**kw), _tgrad)
    jst, jinfos = jtr.jit_epochs()(
        jtr.init(jnp.asarray(x0)), (jnp.asarray(X), jnp.asarray(Y)),
        jnp.float32(ETA), nepochs=nepochs)
    tst, tinfos = ttr.epochs(ttr.init(torch.from_numpy(x0)),
                             (torch.from_numpy(X), torch.from_numpy(Y)),
                             ETA, nepochs=nepochs)
    rows = tst.mem.sy if interleaved else tst.mem.s
    assert rows.dtype == torch.bfloat16
    if interleaved:
        assert tst.mem.shift == (layout == "shift") == jst.mem.shift
    assert int(tst.mem.count) == int(jst.mem.count) == M
    assert _ulps(_torch_rows(tst.mem), _jax_rows(jst.mem)) <= 1.0
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    for name in ("gram", "gamma", "rho"):
        np.testing.assert_allclose(getattr(tst.mem, name).numpy(),
                                   np.asarray(getattr(jst.mem, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["SQN", "oLBFGS"])
def test_fused_pairs_bf16_float64_matches_jax(request, kind, layout):
    """Float64 data, x0 and math with bfloat16 pairs, 4 epochs.  The two
    packages' float64 sums agree to ~1e-16, so no stored row rounds to a
    different bfloat16 neighbour and the trajectories stay together (in
    float32 a last-bit difference can flip a rounding, and bfloat16 oLBFGS
    then forks; ``chip_smoke.py`` phase 16 holds it in float64 at full
    shape for that reason).  Rows bit for bit, codes equal, ``x`` within
    rtol 1e-10 and atol 1e-12."""
    if layout == "ring":
        request.getfixturevalue("ring_mode")
    X, Y, x0 = (a.astype(np.float64) for a in _data())
    kw = dict(mem_size=M, pairs_bf16=True,
              pairs_interleaved=layout != "block")
    if kind == "SQN":
        kw["bfgs_upd_freq"] = L
    jc, tc = {"SQN": (jcfg.SQNConfig, SQNConfig),
              "oLBFGS": (jcfg.OLBFGSConfig, OLBFGSConfig)}[kind]
    jtr = JaxTrainer(kind, jc.create(**kw), _jgrad)
    ttr = FusedTrainer(kind, tc.create(**kw), _tgrad)
    jst, jinfos = jtr.jit_epochs()(
        jtr.init(jnp.asarray(x0)), (jnp.asarray(X), jnp.asarray(Y)),
        jnp.float64(ETA), nepochs=4)
    tst, tinfos = ttr.epochs(ttr.init(torch.from_numpy(x0), device="cpu"),
                             (torch.from_numpy(X), torch.from_numpy(Y)),
                             ETA, nepochs=4)
    assert tst.x.dtype == torch.float64
    assert int(tst.mem.count) == int(jst.mem.count) == M
    np.testing.assert_array_equal(_torch_rows(tst.mem), _jax_rows(jst.mem))
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=1e-10,
                               atol=1e-12)


def _quad(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return (q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T).astype(np.float32)


def _quad_funs(a):
    ja, ta = jnp.asarray(a), torch.from_numpy(a)

    def jgrad(x, b):
        return ja @ (x - jnp.mean(b, axis=0))

    def jobj(x, b):
        r = x - jnp.mean(b, axis=0)
        return 0.5 * r @ ja @ r

    def tgrad(x, b):
        return ta @ (x - torch.mean(b, dim=0))

    def tobj(x, b):
        r = x - torch.mean(b, dim=0)
        return 0.5 * r @ ta @ r
    return jgrad, jobj, tgrad, tobj


def _quad_losses(kind, cfg_kw, rng, bound):
    """Mirror of ``test_fused.py``'s bfloat16 convergence checks: 4 epochs
    on the quadratic, float32 against bfloat16, in the port; and the
    port's bfloat16 loss against the JAX package's."""
    n, B, bs = 8, 12, 2
    a = _quad(rng, n)
    centers = (rng.standard_normal((B, bs, n)) * 0.1).astype(np.float32)
    jgrad, jobj, tgrad, tobj = _quad_funs(a)
    jc, tc = {"SQN": (jcfg.SQNConfig, SQNConfig),
              "adaQN": (jcfg.AdaQNConfig, AdaQNConfig)}[kind]
    flag = "pairs_bf16" if kind == "SQN" else "fisher_bf16"
    obj = {"obj_fn": tobj} if kind == "adaQN" else {}
    flat = torch.from_numpy(centers.reshape(-1, n))
    losses = {}
    for bf16 in (False, True):
        trainer = FusedTrainer(kind, tc.create(**cfg_kw, **{flag: bf16}),
                               tgrad, **obj)
        st, _ = trainer.epochs(trainer.init(torch.ones(n)),
                               torch.from_numpy(centers), 0.1, nepochs=4)
        losses[bf16] = float(tobj(st.x, flat))
        stored = st.mem.s if kind == "SQN" else st.fisher.f
        assert stored.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert losses[True] < max(bound * losses[False], losses[False] + 1e-3)
    if cfg_kw.get("use_pallas"):
        # the kernel route's math on the JAX side, without Pallas
        cfg_kw = dict(cfg_kw, use_pallas=None, coupling="gram")
    jtr = JaxTrainer(kind, jc.create(**cfg_kw, **{flag: True}), jgrad,
                     **({"obj_fn": jobj} if kind == "adaQN" else {}))
    jst, _ = jtr.jit_epochs()(jtr.init(jnp.ones(n, jnp.float32)),
                              jnp.asarray(centers), jnp.float32(0.1),
                              nepochs=4)
    jloss = float(jobj(jst.x, jnp.asarray(centers.reshape(-1, n))))
    np.testing.assert_allclose(losses[True], jloss, rtol=1e-4)


def test_fused_sqn_pairs_bf16_converges(rng):
    _quad_losses("SQN", dict(mem_size=3, bfgs_upd_freq=4), rng, 1.1)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_adaqn_fisher_bf16(rng, use_pallas):
    """``fisher_bf16`` keeps the float32 pairs, so ``use_pallas=True``
    still takes the projection (on the CPU its plain version)."""
    _quad_losses("adaQN", dict(mem_size=3, fisher_size=10, bfgs_upd_freq=4,
                               max_incr=1.01, use_pallas=use_pallas),
                 rng, 1.15)


def test_adaqn_pairs_bf16_skips_the_projection_kernel(monkeypatch):
    """The projection kernel takes float32 pairs only: with ``pairs_bf16``
    the diagonal two-loop takes the plain route whatever ``use_pallas``
    says, as in the JAX package, and the two agree."""
    def refuse(*args):
        raise AssertionError("project_adaqn called on bfloat16 pairs")
    monkeypatch.setattr(ttwo_loop, "project_adaqn", refuse)
    X, Y, x0 = _data()
    kw = dict(mem_size=M, fisher_size=6, bfgs_upd_freq=L, max_incr=1.01,
              pairs_bf16=True, use_pallas=True, coupling="gram")
    jtr = JaxTrainer("adaQN", jcfg.AdaQNConfig.create(**kw), _jgrad,
                     obj_fn=_jobj)
    ttr = FusedTrainer("adaQN", AdaQNConfig.create(**kw), _tgrad,
                       obj_fn=_tobj)
    jst, jinfos = jtr.jit_epochs()(
        jtr.init(jnp.asarray(x0)), (jnp.asarray(X), jnp.asarray(Y)),
        jnp.float32(ETA), nepochs=2)
    tst, tinfos = ttr.epochs(ttr.init(torch.from_numpy(x0)),
                             (torch.from_numpy(X), torch.from_numpy(Y)),
                             ETA, nepochs=2)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    assert _ulps(_torch_rows(tst.mem), _jax_rows(jst.mem)) <= 1.0
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shift", [True, False])
def test_fisher_bf16_append_and_y_match_jax(shift):
    """The Fisher append rounds each gradient to bfloat16; ``fisher_y``
    upcasts the rows and divides in float32.  Ring and shift appends, past
    a wrap of the ring."""
    rng = np.random.default_rng(3)
    n, k = 37, 4
    grads = rng.standard_normal((6, n)).astype(np.float32)
    s = rng.standard_normal(n).astype(np.float32)
    jf = jstate.FisherMemory.create(k, n, jnp.float32, jnp.bfloat16,
                                    shift=shift)
    tf = FisherMemory.create(k, n, torch.float32, torch.bfloat16,
                             shift=shift)
    for g in grads:
        jf = jf.append(jnp.asarray(g))
        tf = tf.append(torch.from_numpy(g))
        assert _ulps(tf.f.float().numpy(),
                     np.asarray(jf.f.astype(jnp.float32))) == 0.0
    assert int(tf.count) == int(jf.count) == k
    np.testing.assert_allclose(
        tpairs.fisher_y(tf, torch.from_numpy(s)).numpy(),
        np.asarray(jpairs.fisher_y(jf, jnp.asarray(s))), rtol=1e-5,
        atol=1e-6)


def _commit_stream(rng, k=12, n=37):
    svecs = rng.standard_normal((k, n)).astype(np.float32)
    yvecs = (svecs * rng.uniform(0.5, 2.0, (k, 1))
             + 0.1 * rng.standard_normal((k, n))).astype(np.float32)
    if k > 7:
        yvecs[3], yvecs[7] = -yvecs[3], -yvecs[7]
    return svecs, yvecs, svecs[::-1].copy()


def _torch_stream(stream, layout, collapsed):
    n = stream[0].shape[1]
    if layout == "block":
        mem = BFGSMemory.create(5, n, torch.float32, torch.bfloat16)
    else:
        mem = BFGSMemoryInterleaved.create(5, n, torch.float32,
                                           torch.bfloat16,
                                           shift=layout == "shift")
    ds, accs = [], []
    for s, y, g in zip(*(torch.from_numpy(a) for a in stream)):
        mem, acc = tpairs.commit_pair(mem.replace(s_pending=s), y, 1e-4, 0.0,
                                      direction_cache=collapsed)
        ds.append(ttwo_loop.two_loop_cached(g, mem, collapsed=collapsed))
        accs.append(bool(acc))
    return torch.stack(ds).numpy(), accs


def _jax_stream(stream, layout, collapsed):
    n = stream[0].shape[1]
    if layout == "block":
        mem = jstate.BFGSMemory.create(5, n, jnp.float32, jnp.bfloat16)
    else:
        mem = jstate.BFGSMemoryInterleaved.create(5, n, jnp.float32,
                                                  jnp.bfloat16,
                                                  shift=layout == "shift")
    ds, accs = [], []
    for s, y, g in zip(*(jnp.asarray(a) for a in stream)):
        mem, acc = jpairs.commit_pair(mem.replace(s_pending=s), y, 1e-4,
                                      0.0, direction_cache=collapsed)
        ds.append(jax_two_loop_cached(g, mem, collapsed=collapsed))
        accs.append(bool(acc))
    return np.stack([np.asarray(d) for d in ds]), accs


@pytest.mark.parametrize("collapsed", [False, True])
@pytest.mark.parametrize("layout", ["shift", "ring"])
def test_bf16_interleaved_matches_block_layout(layout, collapsed):
    """Mirror of ``test_interleaved.py::test_bf16_storage_matches_block_
    layout``, in shift and ring mode: a commit stream with two rejects and
    a wrap of the ring gives the block layout's accepts and directions;
    each layout gives the JAX package's."""
    stream = _commit_stream(np.random.default_rng(7))
    d_blk, a_blk = _torch_stream(stream, "block", collapsed)
    d_ilv, a_ilv = _torch_stream(stream, layout, collapsed)
    assert a_blk == a_ilv and sum(a_blk) == 10
    np.testing.assert_allclose(d_ilv, d_blk, rtol=5e-2, atol=5e-3)
    for lay, got in (("block", d_blk), (layout, d_ilv)):
        want, accs = _jax_stream(stream, lay, collapsed)
        assert accs == a_blk
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=lay)


def test_bf16_direction_goes_to_the_streamed_kernel(monkeypatch):
    """A float32 gradient on bfloat16 pairs takes ``direction_streamed``
    (the one-read kernel is float32 only), in block layout and on an
    interleaved memory's halves ``sy[:m]``, ``sy[m:]``."""
    calls = []
    real = tlk.direction_streamed

    def spy(s_mem, y_mem, *rest):
        calls.append((s_mem.dtype, s_mem.data_ptr(), s_mem.shape))
        return real(s_mem, y_mem, *rest)
    monkeypatch.setattr(ttwo_loop, "direction_streamed", spy)
    monkeypatch.setattr(ttwo_loop, "direction",
                        lambda *a: pytest.fail("direction on bf16 pairs"))
    stream = _commit_stream(np.random.default_rng(7), k=4)
    for layout in ("block", "shift"):
        calls.clear()
        _torch_stream(stream, layout, True)
        assert len(calls) == 4
        assert all(c[0] == torch.bfloat16 and c[2] == (5, 37) for c in calls)


def _jax_numpy(obj):
    return {f.name: (_jax_numpy(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("kind", ["SQN", "adaQN"])
def test_convert_round_trip_bf16(kind):
    """A JAX bfloat16 state comes in bit for bit (through its uint16 bits,
    no ml_dtypes on the port's side), goes out as uint16 bit patterns that
    JAX reads back bit for bit, and both continue alike for an epoch."""
    X, Y, x0 = _data()
    if kind == "SQN":
        kw = dict(mem_size=M, bfgs_upd_freq=L, pairs_bf16=True)
        jtr = JaxTrainer("SQN", jcfg.SQNConfig.create(**kw), _jgrad)
        ttr = FusedTrainer("SQN", SQNConfig.create(**kw), _tgrad)
        to_port, from_port = sqn_state_from_numpy, sqn_state_to_numpy
    else:
        kw = dict(mem_size=M, fisher_size=6, bfgs_upd_freq=L, max_incr=None,
                  pairs_bf16=True, fisher_bf16=True)
        jtr = JaxTrainer("adaQN", jcfg.AdaQNConfig.create(**kw), _jgrad)
        ttr = FusedTrainer("adaQN", AdaQNConfig.create(**kw), _tgrad)
        to_port, from_port = adaqn_state_from_numpy, adaqn_state_to_numpy
    jdata = (jnp.asarray(X), jnp.asarray(Y))
    jst, _ = jtr.jit_epochs()(jtr.init(jnp.asarray(x0)), jdata,
                              jnp.float32(ETA), nepochs=1)
    tst = to_port(_jax_numpy(jst), device="cpu")
    assert tst.mem.s.dtype == torch.bfloat16
    out = from_port(tst)
    bf16_rows = [("mem", "s"), ("mem", "y")]
    if kind == "adaQN":
        bf16_rows.append(("fisher", "f"))
    for part, name in bf16_rows:
        bits = out[part][name]
        assert bits.dtype == np.uint16
        back = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
        want = getattr(getattr(jst, part), name)
        assert back.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(back.astype(jnp.float32)),
                                      np.asarray(want.astype(jnp.float32)))
    assert torch.equal(to_port(out, device="cpu").mem.s, tst.mem.s)
    jst, jinfos = jtr.jit_epochs()(jst, jdata, jnp.float32(ETA), nepochs=1)
    tst, tinfos = ttr.epochs(tst, (torch.from_numpy(X), torch.from_numpy(Y)),
                             ETA, nepochs=1)
    np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind,interleaved", [
    ("SQN", False), ("SQN", True), ("oLBFGS", False), ("oLBFGS", True)])
def test_free_mode_pairs_bf16_matches_jax_in_lockstep(kind, interleaved):
    """``SQN_free`` / ``oLBFGS_free`` with ``pairs_bf16`` (float64 iterate,
    bfloat16 pairs) against the JAX package's, call by call."""
    if kind == "SQN":
        kw = dict(mem_size=4, bfgs_upd_freq=5)
        tcls, jcls = SQN_free, jax_free.SQN_free
    else:
        kw = dict(mem_size=4)
        tcls, jcls = oLBFGS_free, jax_free.oLBFGS_free
    kw.update(pairs_bf16=True, pairs_interleaved=interleaved)
    topt, jopt = tcls(**kw, device="cpu"), jcls(**kw)
    if kind == "SQN":
        _drive(topt, jopt, QuadProblem(1234, 10), 120, "float64")
    else:       # test_torch_olbfgs.py's float64 lockstep and tolerance
        _drive_free(topt, jopt, QuadProblem(1234, 10), 120, 0.05, (),
                    dict(rtol=1e-8, atol=1e-10))
    rows = topt.state.mem.sy if interleaved else topt.state.mem.s
    assert rows.dtype == torch.bfloat16
    assert int(topt.state.mem.count) == 4
    assert _ulps(_torch_rows(topt.state.mem),
                 _jax_rows(jopt.state.mem)) <= 1.0
