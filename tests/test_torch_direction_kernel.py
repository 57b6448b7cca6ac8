"""The direction kernel's plain PyTorch version against the JAX package's
Pallas ``direction_streamed`` (interpret mode), the wrapper's checks, and —
on a machine with an NVIDIA GPU — the CUDA kernel against the plain version.

Tolerances are those of ``tests/test_pallas_kernels.py`` for the same
kernel (rtol 3e-5, atol 1e-4): float32 accumulation in different orders
over n columns and 2m rows.  bfloat16 storage is rounded the same way on
both sides (round to nearest even from the same float32 values) and
upcast before any arithmetic, so it takes the same tolerance.  ``c`` is
scaled by 1 / n, so the tolerance holds at every n and m here: the sums
``W g`` grow like sqrt(n), ``u = c (W g)`` shrinks like 1 / sqrt(n), and
``d`` stays of the order of ``gamma * g``.

The shapes cover what the CUDA kernel treats apart: n with each remainder
mod 4 (and mod 8 for bfloat16), since a row of the pair memory starts
``r * n`` elements after the first and the kernel copies each row in whole
aligned 16-byte vectors, keeping the row's own offset; m up to the largest the kernels take; and n that
the card's shared memory holds wholly, in part and hardly at all between
the kernel's two uses of the pairs, on each side of every boundary of the
kernel's plan: parked whole, parked in part with every re-read column
marked to stay in L2, and with that mark capped by the card's L2.
"""
import numpy as np
import pytest
import torch

from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk
from stochqn_tpu_torch.utils import metrics

RTOL, ATOL = 3e-5, 1e-4
M = 4


def _inputs(n, m=M, seed=0):
    rng = np.random.default_rng(seed + n)
    s = rng.standard_normal((m, n)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal((2 * m, 2 * m)) / n).astype(np.float32)
    gamma = np.float32(0.7)
    return s, y, g, c, gamma


def _torch_args(s, y, g, c, gamma, storage, device="cpu"):
    return (torch.from_numpy(s).to(device, storage),
            torch.from_numpy(y).to(device, storage),
            torch.from_numpy(g).to(device),
            torch.from_numpy(c).to(device),
            torch.tensor(gamma, device=device))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [M, 20])
# not tile multiples; 1000 ... 1003 have every remainder mod 4
@pytest.mark.parametrize("n", [700, 900, 1000, 1001, 1002, 1003, 1500])
def test_ref_matches_pallas_interpret(n, m, storage):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from stochqn_tpu.ops.pallas.two_loop_kernel import direction_streamed

    s, y, g, c, gamma = _inputs(n, m=m)
    want = np.asarray(direction_streamed(
        jnp.asarray(s).astype(storage), jnp.asarray(y).astype(storage),
        jnp.asarray(g), jnp.asarray(c), jnp.asarray(gamma), tile_n=256,
        interpret=True))
    launches = tlk.LAUNCHES
    args = _torch_args(s, y, g, c, gamma, getattr(torch, storage))
    got = tlk.direction_streamed(*args)
    assert tlk.LAUNCHES == launches     # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(),
                                  tlk.direction_streamed_ref(*args).numpy())


def _bad_args(case):
    s, y, g, c, gamma = _torch_args(*_inputs(64), torch.float32)
    if case == "float64_storage":
        s, y = s.double(), y.double()
    elif case == "mixed_storage":
        y = y.to(torch.bfloat16)
    elif case == "f16_grad":
        g = g.to(torch.float16)
    elif case == "grad_shape":
        g = g[:-1]
    elif case == "c_shape":
        c = c[:-1]
    elif case == "gamma_vector":
        gamma = torch.ones(2)
    elif case == "noncontiguous":
        s = torch.from_numpy(np.asfortranarray(s.numpy()))
    elif case == "too_many_pairs":
        s = torch.zeros(33, 64)
        y = torch.zeros(33, 64)
        c = torch.zeros(66, 66)
    elif case == "mixed_device":
        g = g.to("meta")
    return s, y, g, c, gamma


@pytest.mark.parametrize("case,exc", [
    ("float64_storage", TypeError), ("mixed_storage", TypeError),
    ("f16_grad", TypeError), ("grad_shape", ValueError),
    ("c_shape", ValueError), ("gamma_vector", ValueError),
    ("noncontiguous", ValueError), ("too_many_pairs", ValueError),
    ("mixed_device", ValueError)])
def test_wrapper_rejects_bad_arguments(case, exc):
    with pytest.raises(exc, match="direction_streamed"):
        tlk.direction_streamed(*_bad_args(case))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; runs on the card only)")
    return torch.device("cuda")


# (m, n): every remainder of n mod 8 at every m; the flagship n, which an
# H100 parks wholly at m = 10 and in part at m = 20 and 32; an n of which it
# parks an eighth; the Criteo cell's pairs, 80 MB in float32.
CUDA_SHAPES = ([(m, n) for m in (1, 4, 10, 20, 32)
                for n in (700, 900, 1000, 1500, 1501, 1502, 1503, 1504,
                          1505, 1506, 1507)]
               + [(m, 292_083) for m in (4, 10, 20, 32)]
               + [(32, 1_000_003), (10, 1_000_000)])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", CUDA_SHAPES)
def test_kernel_matches_ref_on_cuda(cuda_device, m, n, storage):
    args = _torch_args(*_inputs(n, m=m), storage, cuda_device)
    launches = tlk.LAUNCHES
    got = tlk.direction_streamed(*args)
    torch.cuda.synchronize()
    assert tlk.LAUNCHES == launches + 1       # one launch per direction
    want = tlk.direction_streamed_ref(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    again = tlk.direction_streamed(*args)
    assert torch.equal(got, again)            # the same bits twice


@pytest.mark.cuda
def test_kernel_parks_by_the_cards_shared_memory(cuda_device):
    """What parks comes from the device's properties: all of a small n,
    more columns in bfloat16 than in float32, fewer with more pairs."""
    parked = tlk.direction_streamed_parked
    assert parked(10, 1500, torch.float32, cuda_device) == 1500
    n = 4_000_000
    f32, bf16 = (parked(20, n, t, cuda_device)
                 for t in (torch.float32, torch.bfloat16))
    assert 0 < parked(32, n, torch.float32, cuda_device) < f32 < bf16 < n


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [700, 1503, 292_083])
def test_bf16_gradient_matches_ref_on_cuda(cuda_device, n, storage):
    """A bfloat16 gradient (a bfloat16 iterate's): one launch on its
    upcast, against the plain version on the same upcast inputs, and the
    float32-gradient call's bits."""
    s, y, g, c, gamma = _torch_args(*_inputs(n, m=M), storage, cuda_device)
    g16 = g.to(torch.bfloat16)
    launches = tlk.LAUNCHES
    got = tlk.direction_streamed(s, y, g16, c, gamma)
    torch.cuda.synchronize()
    assert tlk.LAUNCHES == launches + 1 and got.dtype == torch.float32
    want = tlk.direction_streamed_ref(s, y, g16.float(), c, gamma)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tlk.direction_streamed(s, y, g16.float(), c,
                                                   gamma))


def test_replay_adds_the_captured_bytes():
    """A graph's replay counts its launches and adds the bytes its capture
    recorded to the port's counters."""
    metrics.reset()
    launches = tlk.LAUNCHES
    tlk.count_replay({"LAUNCHES": 2}, {"direction_l2_held_bytes": 5,
                                       "direction_reread_bytes": 3})
    tlk.count_replay({"LAUNCHES": 2}, {"direction_l2_held_bytes": 5,
                                       "direction_reread_bytes": 3})
    counters = metrics.snapshot()["counters"]
    assert tlk.LAUNCHES == launches + 4
    assert (counters["direction_l2_held_bytes"],
            counters["direction_reread_bytes"],
            counters["direction_parked_bytes"]) == (10, 6, 0)
    metrics.reset()


def _first(pred, lo, hi):
    """The least n in (lo, hi] with pred(n), pred false at lo and true at
    hi (both monotone in n)."""
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if pred(mid) else (mid, hi)
    return hi


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 10, 32])
def test_kernel_on_each_side_of_the_plans_boundaries(cuda_device, m,
                                                     storage):
    """The plan's split of the columns adds up to n, and the kernel agrees
    with its plain version and gives the same bits twice on each side of
    where the pairs stop parking whole and where the columns read again
    stop all being marked to stay in L2."""
    def split(n):
        return tlk.direction_streamed_split(m, n, storage, cuda_device)
    top = 64_000_000 // m
    whole = _first(lambda n: split(n)["parked"] < n, 1, top) - 1
    capped = _first(lambda n: split(n)["reread"] > 0, whole, top)
    sides = {whole: "whole", whole + 1: "held", capped - 1: "held",
             capped: "capped"}
    for n, kind in sides.items():
        got = split(n)
        assert sum(got.values()) == n
        assert {"whole": got["parked"] == n,
                "held": 0 < got["l2_held"] and got["reread"] == 0,
                "capped": got["reread"] > 0}[kind], (n, kind, got)
        args = _torch_args(*_inputs(n, m=m), storage, cuda_device)
        d = tlk.direction_streamed(*args)
        want = tlk.direction_streamed_ref(*args)
        np.testing.assert_allclose(d.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(d, tlk.direction_streamed(*args))


@pytest.mark.cuda
def test_criteo_rereads_under_a_third_without_the_hint(cuda_device):
    """At the Criteo cell's pairs (m = 10, n = 1,000,000, float32) under a
    third of W is read again from device memory, and each launch adds its
    split's bytes to the port's counters."""
    m, n = 10, 1_000_000
    split = tlk.direction_streamed_split(m, n, torch.float32, cuda_device)
    assert sum(split.values()) == n and split["reread"] < n / 3
    assert split["parked"] > 0 and split["l2_held"] > 0
    args = _torch_args(*_inputs(n, m=m), torch.float32, cuda_device)
    metrics.reset()
    tlk.direction_streamed(*args)
    tlk.direction_streamed(*args)
    counters = metrics.snapshot()["counters"]
    assert [counters[f"direction_{k}_bytes"] for k in
            ("parked", "l2_held", "reread")] == [
        2 * 2 * m * 4 * split[k] for k in ("parked", "l2_held", "reread")]
    metrics.reset()
