"""The torch port's uncached two-loop oracles (``two_loop``,
``two_loop_sequential``) against the JAX package's and against the
pure-numpy oracle, over the cases of ``tests/test_two_loop.py``.

Tolerances: in float64 every implementation computes the same sums in
another order (rtol 1e-10, atol 1e-12, as ``tests/test_two_loop.py``); the
``use_pallas=True`` routes run in float32 (rtol 3e-5, atol 1e-4, as
``tests/test_pallas_kernels.py``), where on the CPU the port's kernel
wrappers run their plain versions and the JAX package its Pallas kernels
in interpret mode.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oracle_numpy import two_loop_np  # noqa: E402
from stochqn_tpu.ops.two_loop import two_loop as jax_two_loop  # noqa: E402
from stochqn_tpu.ops.two_loop import (  # noqa: E402
    two_loop_sequential as jax_two_loop_sequential)
from stochqn_tpu_torch.core.state import BFGSMemory  # noqa: E402
from stochqn_tpu_torch.ops import two_loop as two_loop_mod  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402
from stochqn_tpu_torch.ops.pairs import (commit_pair,  # noqa: E402
                                         conditional_flush)
from stochqn_tpu_torch.ops.two_loop import (two_loop,  # noqa: E402
                                            two_loop_cached,
                                            two_loop_sequential)

RTOL, ATOL = 1e-10, 1e-12


def _random_pairs(rng, n, k):
    """k (s, y) pairs with positive curvature."""
    pairs = []
    for _ in range(k):
        s = rng.standard_normal(n)
        y = rng.standard_normal(n)
        y = y + (1.0 + abs(np.dot(s, y))) / np.dot(s, s) * s
        pairs.append((s, y))
    return pairs


def _fill_ring(pairs, mem_size, n, head_offset=0):
    """Chronological pairs in a ring.  A full ring may start at any offset
    (head == oldest row); a ring that is not full starts at row 0 with
    head == count."""
    s_mem = np.zeros((mem_size, n))
    y_mem = np.zeros((mem_size, n))
    count = len(pairs)
    start = head_offset % mem_size if count == mem_size else 0
    for c, (s, y) in enumerate(pairs):
        s_mem[(start + c) % mem_size] = s
        y_mem[(start + c) % mem_size] = y
    return s_mem, y_mem, (start if count == mem_size else count), count


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [7, 130])
@pytest.mark.parametrize("count,mem_size,head_offset", [
    (0, 5, 0), (1, 5, 0), (3, 5, 0), (5, 5, 0), (5, 5, 2), (5, 5, 4),
    (10, 10, 7),
])
@pytest.mark.parametrize("h0", [0.0, 0.37])
def test_oracles_match_jax_and_numpy_scalar_h0(rng, n, count, mem_size,
                                               head_offset, h0):
    pairs = _random_pairs(rng, n, count)
    s_mem, y_mem, head, cnt = _fill_ring(pairs, mem_size, n, head_offset)
    g = rng.standard_normal(n)
    want = two_loop_np(g, pairs, h0=h0)
    jargs = (jnp.asarray(g), jnp.asarray(s_mem), jnp.asarray(y_mem), head,
             cnt)
    targs = (_t(g), _t(s_mem), _t(y_mem))
    for got, jgot in (
            (two_loop(*targs, head, cnt, h0=h0),
             jax_two_loop(*jargs, h0=h0)),
            (two_loop(*targs, torch.tensor(head), torch.tensor(cnt), h0=h0),
             jax_two_loop(*jargs, h0=h0)),
            (two_loop_sequential(*targs, head, cnt, h0=h0),
             jax_two_loop_sequential(*jargs, h0=h0))):
        assert got.dtype == torch.float64 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("fn", ["two_loop", "two_loop_sequential"])
def test_oracles_match_numpy_diag(rng, fn):
    n, mem_size, count = 50, 6, 6
    pairs = _random_pairs(rng, n, count)
    s_mem, y_mem, head, cnt = _fill_ring(pairs, mem_size, n, head_offset=3)
    g = rng.standard_normal(n)
    diag = rng.uniform(0.1, 2.0, size=n)
    want = two_loop_np(g, pairs, diag=diag)
    got = getattr(two_loop_mod, fn)(_t(g), _t(s_mem), _t(y_mem), head, cnt,
                                    diag=_t(diag))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    jgot = jax_two_loop(jnp.asarray(g), jnp.asarray(s_mem),
                        jnp.asarray(y_mem), head, cnt, diag=jnp.asarray(diag))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fn", ["two_loop", "two_loop_sequential"])
def test_empty_memory_returns_gradient(rng, fn):
    n = 11
    g = rng.standard_normal(n)
    zeros = torch.zeros(4, n, dtype=torch.float64)
    f = getattr(two_loop_mod, fn)
    out = f(_t(g), zeros, zeros, 0, 0, h0=5.0)
    np.testing.assert_array_equal(out.numpy(), g)  # h0 NOT applied when empty
    diag = rng.uniform(0.5, 1.5, size=n)
    out2 = f(_t(g), zeros, zeros, 0, 0, diag=_t(diag))
    np.testing.assert_allclose(out2.numpy(), diag * g, rtol=1e-15)


def test_secant_condition(rng):
    """BFGS invariant: H_k y_last = s_last, so two_loop(y_last) == s_last."""
    n, k = 12, 5
    pairs = _random_pairs(rng, n, k)
    s_mem, y_mem, head, cnt = _fill_ring(pairs, k, n, head_offset=2)
    s_last, y_last = pairs[-1]
    got = two_loop(_t(y_last), _t(s_mem), _t(y_mem), head, cnt)
    np.testing.assert_allclose(got.numpy(), s_last, rtol=1e-8, atol=1e-10)


def test_two_loop_equals_dense_inverse_hessian(rng):
    """With A-conjugate directions and exact y = A s, BFGS equals A^{-1}
    after n pairs."""
    n = 8
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = q @ np.diag(rng.uniform(1.0, 3.0, n)) @ q.T
    dirs = []
    for _ in range(n):
        s = rng.standard_normal(n)
        for p in dirs:
            s = s - (p @ a @ s) / (p @ a @ p) * p
        dirs.append(s)
    s_mem = np.stack(dirs)
    g = rng.standard_normal(n)
    got = two_loop(_t(g), _t(s_mem), _t(s_mem @ a), 0, n)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(a, g), rtol=1e-6,
                               atol=1e-8)


def _committed(rng, m, n, commits, direction_cache=False, scale=None):
    mem = BFGSMemory.create(m, n, torch.float64)
    for i in range(commits):
        s = _t(rng.standard_normal(n))
        if scale is None:
            y = s + 0.25 * _t(rng.standard_normal(n))
        else:
            y = s * (scale + 0.2 * i) + 0.01 * _t(rng.standard_normal(n))
        mem, acc = commit_pair(mem.replace(s_pending=s), y, 1e-8, 0.0,
                               direction_cache=direction_cache)
        assert bool(acc)
    return mem


def test_cached_gram_matches_recompute(rng):
    """two_loop with a supplied Gram equals the recompute path, and
    commit_pair maintains the Gram through ring wrap."""
    mem = _committed(rng, 4, 24, 7)
    w = torch.cat([mem.s, mem.y])
    np.testing.assert_allclose(mem.gram.numpy(), (w @ w.T).numpy(),
                               rtol=1e-12)
    g = _t(rng.standard_normal(24))
    with_gram = two_loop(g, mem.s, mem.y, mem.head, mem.count, gram=mem.gram)
    without = two_loop(g, mem.s, mem.y, mem.head, mem.count)
    np.testing.assert_allclose(with_gram.numpy(), without.numpy(),
                               rtol=1e-12)


def test_stale_rows_are_masked(rng):
    """Rows beyond ``count`` may hold stale data after a flush and must
    not affect the result."""
    n, mem_size, count = 20, 5, 2
    pairs = _random_pairs(rng, n, count)
    s_mem, y_mem, head, cnt = _fill_ring(pairs, mem_size, n)
    s_stale, y_stale = s_mem.copy(), y_mem.copy()
    s_stale[3:] = rng.standard_normal((2, n)) * 100
    y_stale[3:] = rng.standard_normal((2, n)) * 100
    g = _t(rng.standard_normal(n))
    clean = two_loop(g, _t(s_mem), _t(y_mem), head, cnt)
    stale = two_loop(g, _t(s_stale), _t(y_stale), head, cnt)
    np.testing.assert_allclose(stale.numpy(), clean.numpy(), rtol=1e-10)


@pytest.mark.parametrize("commits", [1, 3, 4, 6])   # 6 wraps the ring
def test_cached_diag_path_matches_two_loop(rng, commits):
    """two_loop_cached (commit-time cache) == two_loop for the diagonal
    H0, in both couplings."""
    n = 30
    mem = _committed(rng, 4, n, commits)
    g = _t(rng.standard_normal(n))
    diag = _t(rng.uniform(0.1, 2.0, n))
    ref = two_loop(g, mem.s, mem.y, mem.head, mem.count, diag=diag)
    for coupling in ("matvec", "gram"):
        got = two_loop_cached(g, mem, diag=diag, coupling=coupling)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("commits", [0, 1, 3, 4, 7])
@pytest.mark.parametrize("h0", [0.0, 0.7])
def test_collapsed_direction_matches_two_loop(rng, commits, h0):
    """The collapsed form d = gamma*g + W^T((c0 + gamma*cg)(W g)) equals
    the uncached two-loop for every ring state and H0 mode, in float64
    (the plain route of the collapsed branch)."""
    m, n = 4, 33
    mem = _committed(rng, m, n, commits, direction_cache=True, scale=1.5)
    g = _t(rng.standard_normal(n))
    ref = two_loop(g, mem.s, mem.y, mem.head, mem.count, h0=h0,
                   gram=mem.gram)
    got = two_loop_cached(g, mem, h0=h0, collapsed=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    seq = two_loop_sequential(g, mem.s, mem.y, mem.head, mem.count, h0=h0)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=RTOL,
                               atol=ATOL)
    # flushed memory: stale (c0, cg) must be masked -> d == g
    flushed = conditional_flush(mem, torch.tensor(True))
    d_flush = two_loop_cached(g, flushed, collapsed=True)
    np.testing.assert_array_equal(d_flush.numpy(), g.numpy())


def _f32_mem(rng, m, n):
    s = rng.standard_normal((m, n)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    return s, y


@pytest.mark.parametrize("with_gram", [False, True], ids=["recompute", "gram"])
@pytest.mark.parametrize("with_diag", [False, True], ids=["scalar", "diag"])
def test_use_pallas_route_matches_plain_and_jax(rng, monkeypatch, with_diag,
                                                with_gram):
    """``use_pallas=True`` takes ``project`` (no Gram, no diag),
    ``project_adaqn`` (diag) or no kernel (cached Gram, no diag), and
    agrees with the plain route and with the JAX package's Pallas route in
    interpret mode."""
    m, n, count = 4, 700, 4
    s, y = _f32_mem(rng, m, n)
    g = rng.standard_normal(n).astype(np.float32)
    diag = rng.uniform(0.1, 2.0, n).astype(np.float32) if with_diag else None
    w = np.concatenate([s, y])
    gram = (w @ w.T) if with_gram else None
    calls = []
    for name in ("project", "project_adaqn"):
        def spy(*args, _name=name, _fn=getattr(tlk, name)):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(two_loop_mod, name, spy)

    def run(use_pallas):
        return two_loop(_t(g), _t(s), _t(y), 2, count,
                        diag=None if diag is None else _t(diag),
                        gram=None if gram is None else _t(gram),
                        use_pallas=use_pallas)
    ref = run(False)
    assert calls == []
    launches = (tlk.PROJECT_LAUNCHES, tlk.PROJECT_ADAQN_LAUNCHES)
    got = run(True)
    assert calls == (["project_adaqn"] if with_diag else
                     [] if with_gram else ["project"])
    assert (tlk.PROJECT_LAUNCHES, tlk.PROJECT_ADAQN_LAUNCHES) == launches
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=3e-5, atol=1e-4)
    jgot = jax_two_loop(
        jnp.asarray(g), jnp.asarray(s), jnp.asarray(y), 2, count,
        diag=None if diag is None else jnp.asarray(diag),
        gram=None if gram is None else jnp.asarray(gram),
        use_pallas=True, pallas_interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=3e-5,
                               atol=1e-4)


@pytest.mark.parametrize("m,head", [(14, 5), (20, 13)])
def test_use_pallas_project_route_at_large_m_on_a_wrapped_ring(rng, m, head):
    """The ``project`` route on a full ring whose oldest pair is row
    ``head``, at an m whose 2m rows leave room for g in their last block of
    8 and at one whose rows fill their blocks (the CUDA kernel treats the
    two apart): the port against its plain route and against the JAX package's Pallas
    route in interpret mode (float32: rtol 3e-5, atol 1e-4, as above)."""
    n = 1003
    # y close to a multiple of s: a well-conditioned H for float32
    pairs = []
    for i in range(m):
        s = rng.standard_normal(n)
        pairs.append((s, (1.5 + 0.05 * i) * s
                      + 0.01 * rng.standard_normal(n)))
    s_mem, y_mem, hd, cnt = _fill_ring(pairs, m, n, head_offset=head)
    assert (hd, cnt) == (head, m)
    s, y = s_mem.astype(np.float32), y_mem.astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    launches = tlk.PROJECT_LAUNCHES
    got = two_loop(_t(g), _t(s), _t(y), hd, cnt, use_pallas=True)
    assert tlk.PROJECT_LAUNCHES == launches    # CPU tensors: the plain version
    ref = two_loop(_t(g), _t(s), _t(y), hd, cnt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=3e-5, atol=1e-4)
    jgot = jax_two_loop(jnp.asarray(g), jnp.asarray(s), jnp.asarray(y), hd,
                        cnt, use_pallas=True, pallas_interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=3e-5,
                               atol=1e-4)
    # float32 against the float64 oracle on the same (rounded) pairs
    want = two_loop_np(g.astype(np.float64),
                       [(a.astype(np.float32).astype(np.float64),
                         b.astype(np.float32).astype(np.float64))
                        for a, b in pairs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_use_pallas_with_other_dtypes_takes_the_plain_route(rng, monkeypatch,
                                                            dtype):
    """Decided before any launch, as in the JAX package: only float32
    gradient and pairs take a kernel."""
    for name in ("project", "project_adaqn"):
        monkeypatch.setattr(two_loop_mod, name,
                            lambda *a: pytest.fail("kernel route taken"))
    s, y = _f32_mem(rng, 3, 64)
    g = rng.standard_normal(64).astype(np.float32)
    args = (_t(g).to(dtype), _t(s).to(dtype), _t(y).to(dtype), 0, 3)
    got = two_loop(*args, use_pallas=True)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  two_loop(*args).float().numpy())
