"""The torch port's cached two-loop against the JAX package: SQN's
collapsed scalar-H0 branch, oLBFGS's uncollapsed one and adaQN's
diagonal-H0 branches (the interleaved layout and oLBFGS's branch in more
cases: ``tests/test_torch_interleaved.py``, ``tests/test_torch_olbfgs.py``).

The pair memory is built by the JAX package's own commits and carried
across with ``convert``, so this isolates the direction.  On the CPU the
port's kernel wrappers run their plain PyTorch versions.
Tolerance: float32 with different summation orders over n = 300 and the
2m = 8 rows (rtol 3e-5, atol 1e-5 on directions of order 1-10); the
``count == 0`` case must return ``g`` (``diag * g`` with a diagonal H0)
exactly.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core.state import BFGSMemory as JaxMemory  # noqa: E402
from stochqn_tpu.ops.pairs import commit_pair as jax_commit  # noqa: E402
from stochqn_tpu.ops.pairs import conditional_flush as jax_flush  # noqa: E402
from stochqn_tpu.ops.two_loop import two_loop_cached as jax_two_loop  # noqa: E402
from stochqn_tpu_torch.convert import bfgs_memory_from_numpy  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel  # noqa: E402
from stochqn_tpu_torch.core.state import BFGSMemory  # noqa: E402
from stochqn_tpu_torch.ops import pairs, two_loop  # noqa: E402
from stochqn_tpu_torch.ops.two_loop import (_chrono_perm,  # noqa: E402
                                            two_loop_cached)

M, N = 4, 300


def _jax_mem(n_commits, flush=False, direction_cache=True):
    rng = np.random.default_rng(21)
    mem = JaxMemory.create(M, N, jnp.float32)
    for _ in range(n_commits):
        s = rng.standard_normal(N).astype(np.float32)
        y = (s + 0.3 * rng.standard_normal(N)).astype(np.float32)
        mem, _ = jax_commit(mem.replace(s_pending=jnp.asarray(s)),
                            jnp.asarray(y), 1e-4, 0.0,
                            direction_cache=direction_cache)
    if flush:
        mem = jax_flush(mem, jnp.asarray(True))
    return mem


def _to_torch(mem):
    return bfgs_memory_from_numpy({f.name: np.asarray(getattr(mem, f.name))
                                   for f in dataclasses.fields(mem)},
                                  device="cpu")


@pytest.mark.parametrize("n_commits", [1, 3, 4, 6])   # 6 overfills the ring
@pytest.mark.parametrize("h0", [0.0, 0.5])
def test_collapsed_matches_jax(n_commits, h0):
    jmem = _jax_mem(n_commits)
    g = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, h0=h0,
                                   collapsed=True))
    launches = two_loop_kernel.LAUNCHES
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem), h0=h0,
                          collapsed=True)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-5)
    assert two_loop_kernel.LAUNCHES == launches   # CPU: plain version only


@pytest.mark.parametrize("flush", [False, True])
def test_empty_memory_returns_gradient(flush):
    """count == 0 returns g, also when a flush left a stale c0/cg behind."""
    jmem = _jax_mem(3 if flush else 0, flush=flush)
    g = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem),
                          collapsed=True)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, collapsed=True))
    np.testing.assert_array_equal(got.numpy(), g)
    np.testing.assert_array_equal(want, g)


@pytest.mark.parametrize("head,count", [(0, 0), (1, 3), (3, 4), (0, 4),
                                        (2, 2)])
def test_chrono_perm_matches_jax(head, count):
    from stochqn_tpu.ops.two_loop import _chrono_perm as jax_perm
    got = _chrono_perm(M, torch.tensor(head), torch.tensor(count))
    want = np.asarray(jax_perm(M, jnp.int32(head), jnp.int32(count)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kwargs", [dict(collapsed=False),
                                    dict(collapsed=False, h0=0.5)])
def test_unported_branches_raise(kwargs):
    """The scalar-H0 uncollapsed branch, the last to be ported (with
    oLBFGS), no longer raises: it matches the JAX package's on a memory
    committed without the collapsed cache, as oLBFGS commits."""
    jmem = _jax_mem(2, direction_cache=False)
    g = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, **kwargs))
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem), **kwargs)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-5)


def _diag(signed, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(N) if signed
            else rng.uniform(0.1, 2.0, N)).astype(np.float32)


ROUTES = {
    # port kwargs, JAX kwargs (the kernel route: JAX's Pallas kernel in
    # interpret mode)
    "matvec": (dict(coupling="matvec"), dict(coupling="matvec")),
    "gram": (dict(coupling="gram"), dict(coupling="gram")),
    "kernel": (dict(use_pallas=True),
               dict(use_pallas=True, pallas_interpret=True)),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("n_commits", [1, 3, 6])   # 6 overfills the ring
def test_diag_branches_match_jax(n_commits, signed, route):
    jmem = _jax_mem(n_commits, direction_cache=False)
    g = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    d = _diag(signed)
    port_kw, jax_kw = ROUTES[route]
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, diag=jnp.asarray(d),
                                   **jax_kw))
    launches = two_loop_kernel.PROJECT_ADAQN_LAUNCHES
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem),
                          diag=torch.from_numpy(d), **port_kw)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-5)
    assert two_loop_kernel.PROJECT_ADAQN_LAUNCHES == launches   # CPU


@pytest.mark.parametrize("route", list(ROUTES))
def test_diag_empty_memory_returns_diag_times_gradient(route):
    jmem = _jax_mem(3, flush=True, direction_cache=False)
    g = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    d = _diag(True)
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem),
                          diag=torch.from_numpy(d), **ROUTES[route][0])
    np.testing.assert_array_equal(got.numpy(), d * g)


def _spy_kernel(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args)
        return two_loop_kernel.project_adaqn(*args)
    monkeypatch.setattr(two_loop, "project_adaqn", spy)
    return calls


def _port_mem(storage, commits=3):
    rng = np.random.default_rng(6)
    mem = BFGSMemory.create(M, N, torch.float32, storage_dtype=storage)
    for _ in range(commits):
        s = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        y = s + 0.3 * torch.from_numpy(
            rng.standard_normal(N).astype(np.float32))
        mem, _ = pairs.commit_pair(mem.replace(s_pending=s), y, 1e-8, 0.0)
    return mem


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_route_needs_float32_storage(monkeypatch, storage):
    """``use_pallas=True`` takes the projection kernel only for float32
    grad and float32 pairs, decided before any launch; bfloat16 pairs take
    the plain matvec route (as ``test_bf16_pairs_with_pallas_falls_back``
    in ``tests/test_pallas_kernels.py`` for the JAX package)."""
    calls = _spy_kernel(monkeypatch)
    mem = _port_mem(storage)
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32))
    forced = two_loop_cached(g, mem, diag=d, use_pallas=True)
    plain = two_loop_cached(g, mem, diag=d)
    assert len(calls) == (1 if storage == torch.float32 else 0)
    np.testing.assert_allclose(forced.numpy(), plain.numpy(), rtol=3e-5,
                               atol=1e-5)
    if storage == torch.bfloat16:
        np.testing.assert_array_equal(forced.numpy(), plain.numpy())


def test_bad_coupling_and_interleaved_diag_raise():
    mem = _to_torch(_jax_mem(2))
    with pytest.raises(ValueError, match="coupling"):
        two_loop_cached(torch.zeros(N), mem, diag=torch.ones(N),
                        coupling="dense")
    interleaved = types.SimpleNamespace(sy=torch.zeros(2 * M, N))
    with pytest.raises(ValueError, match="diagonal H0"):
        two_loop_cached(torch.zeros(N), interleaved, diag=torch.ones(N))


def _jax_mem64(n_commits):
    rng = np.random.default_rng(21)
    mem = JaxMemory.create(M, N, jnp.float64)
    for _ in range(n_commits):
        s = rng.standard_normal(N)
        y = s + 0.3 * rng.standard_normal(N)
        mem, _ = jax_commit(mem.replace(s_pending=jnp.asarray(s)),
                            jnp.asarray(y), 1e-4, 0.0, direction_cache=True)
    return mem


@pytest.mark.parametrize("n_commits", [1, 4, 6])   # 6 overfills the ring
@pytest.mark.parametrize("h0", [0.0, 0.5])
def test_collapsed_float64_matches_jax(n_commits, h0):
    """A float64 memory takes the collapsed branch's plain route (no
    direction kernel takes float64) and matches the JAX package under
    ``jax_enable_x64`` to float64 rounding (rtol 1e-10)."""
    jmem = _jax_mem64(n_commits)
    g = np.random.default_rng(4).standard_normal(N)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, h0=h0,
                                   collapsed=True))
    assert want.dtype == np.float64
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem), h0=h0,
                          collapsed=True)
    assert got.dtype == torch.float64 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kwargs", [dict(collapsed=True),
                                    dict(diag=True, coupling="matvec"),
                                    dict(diag=True, coupling="gram")],
                         ids=["collapsed", "diag_matvec", "diag_gram"])
def test_float64_grad_against_float32_pairs_promotes_like_jax(kwargs):
    """``_mem_mm`` promotes mixed float64 / float32 operands to the
    accumulation dtype, as ``jnp.matmul(..., preferred_element_type=...)``
    does: a float64 gradient against a float32 memory computes what the
    JAX package computes (float32 cache, so float32 tolerance)."""
    jmem = _jax_mem(5)
    g = np.random.default_rng(4).standard_normal(N)
    kwargs = dict(kwargs)
    jkw, tkw = dict(kwargs), dict(kwargs)
    if kwargs.get("diag"):
        d = _diag(False).astype(np.float64)
        jkw["diag"], tkw["diag"] = jnp.asarray(d), torch.from_numpy(d)
    want = np.asarray(jax_two_loop(jnp.asarray(g), jmem, **jkw))
    got = two_loop_cached(torch.from_numpy(g), _to_torch(jmem), **tkw)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-5)
    a = torch.from_numpy(g)
    b = torch.ones(N, 2, dtype=torch.float32)
    assert two_loop._mem_mm(a, b, torch.float64).dtype == torch.float64
