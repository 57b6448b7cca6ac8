#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each failure raises and exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), torch / CUDA versions and
   the float32 matmul settings (TF32 off, "highest").  No CUDA: exit 1.
2. Build the direction kernel from ``stochqn_tpu_torch/csrc`` with nvcc.
3. The kernel against its plain PyTorch version on the card, on a real
   commit cache (12 commits into a ring of m = 10), at n = 900, 1,500 and
   292,083, for float32 and bfloat16 pair storage; then both timed at the
   flagship shape with CUDA events.
4. The main path: ``FusedTrainer("SQN")`` at BibTeX shape (1,836 features,
   159 classes, batches of 50, 120 batches, m = 10, L = 20) on bench.py's
   data, 2 epochs through ``epochs``.  Checks: no host sync inside,
   finite ``x``, valid info codes, lower loss, one kernel launch per step,
   and the JAX package's result (below).  Then three more epochs, each timed, and the main path's
   layers timed one by one.
5. Device against CPU on a small problem (the CPU runs the plain version).

The last two lines are the kernels' JSON record and the contract line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu_torch import FusedTrainer, SQNConfig  # noqa: E402
from stochqn_tpu_torch.core.state import BFGSMemory  # noqa: E402
from stochqn_tpu_torch.fused import _flat, _sqn_boundary  # noqa: E402
from stochqn_tpu_torch.models import losses  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402
from stochqn_tpu_torch.ops.pairs import commit_pair  # noqa: E402
from stochqn_tpu_torch.ops.two_loop import two_loop_cached  # noqa: E402

# BibTeX shape and the bench.py workload (bench.py:70-78, :131-137).
N_FEATURES, N_CLASSES, BATCH_SIZE, NUM_BATCHES = 1836, 159, 50, 120
UPD_FREQ, MEM_SIZE, REG, STEP = 20, 10, 1e-1, 1e-2
N_FLAGSHIP = (N_FEATURES + 1) * N_CLASSES          # 292,083

# The JAX package (stochqn_tpu) on the CPU, on exactly this data:
# FusedTrainer("SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=20))
# .jit_epochs() for 2 epochs at eta = 1e-2 takes the full-data loss
# (reg 0.1) from 709,638.8125 at x0 to 451,613.0; all 240 info codes are
# 200 and the ring ends with count == 10.  A 1e-6 relative change of x0
# moves that loss by about 0.1, so the port must land within 0.1%.
JAX_LOSS_X0 = 709_638.8125
JAX_LOSS_2_EPOCHS = 451_613.0
LOSS_RTOL = 1e-3

# Kernel vs plain version: the tolerance of tests/test_pallas_kernels.py
# for the same kernel.  Both read the same stored pairs and accumulate in
# float32, in different orders.
KERNEL_RTOL, KERNEL_ATOL = 3e-5, 1e-4
# Device vs CPU on the small problem: 16 quasi-Newton steps, float32 in
# different orders on each side (as in tests/test_torch_fused_sqn.py).
PARITY_RTOL, PARITY_ATOL = 1e-4, 2e-5

VALID_INFO = {200, 201, 202, 203}


def phase(title):
    print(f"\n== {title}", flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# A spin of this many SM clock cycles (about 0.2 s at the H100's clock)
# holds the stream while the host enqueues the work that device_ms times.
SPIN_CYCLES = 400_000_000


def device_ms(fn, iters, flush=None):
    """Device milliseconds per ``fn()``, timed with CUDA events.

    Eager PyTorch enqueues small kernels more slowly than the device runs
    them, so events recorded as the host goes would time the host.  A spin
    kernel (``torch.cuda._sleep``) holds the stream until the host has
    enqueued everything; the events then time the device alone.  Without
    ``flush``: the mean over ``iters`` calls back to back (their data warm
    in L2).  With ``flush`` (a buffer larger than L2, overwritten before
    each call): the median of single calls that find L2 cold.  Raises if
    the host took longer to enqueue than the spin lasted, which also
    happens when the launches overflow the driver's queue of about a
    thousand pending kernels: keep ``iters`` times the kernels per call
    well below that."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def event():
        return torch.cuda.Event(enable_timing=True)
    spin_start, spin_end = event(), event()
    marks = [(event(), event()) for _ in range(1 if flush is None else iters)]
    t0 = time.perf_counter()
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    spin_end.record()
    if flush is None:
        marks[0][0].record()
        for _ in range(iters):
            fn()
        marks[0][1].record()
    else:
        for start, end in marks:
            flush.zero_()
            start.record()
            fn()
            end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if enqueue_ms >= spin_start.elapsed_time(spin_end):
        raise RuntimeError(f"device_ms: the host needed {enqueue_ms:.1f} ms "
                           "to enqueue, longer than the spin; raise "
                           "SPIN_CYCLES")
    times = [a.elapsed_time(b) for a, b in marks]
    return times[0] / iters if flush is None else statistics.median(times)


def host_ms(fn, iters):
    """Wall milliseconds per ``fn()`` on the host clock, over ``iters``
    calls ending in a synchronize: what a caller of ``fn`` waits."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# ---------------------------------------------------------------------------
def committed_memory(n, storage, dev, gen, commits=12, m=MEM_SIZE):
    """A ring of m pairs filled by the port's own commits (more than m, so
    the ring wraps), with the collapsed-direction cache."""
    mem = BFGSMemory.create(m, n, torch.float32, storage_dtype=storage,
                            device=dev)
    accepted = 0
    for _ in range(commits):
        s = torch.randn(n, device=dev, generator=gen)
        y = s + 0.3 * torch.randn(n, device=dev, generator=gen)
        mem, acc = commit_pair(mem.replace(s_pending=s), y, 1e-4, 0.0,
                               direction_cache=True)
        accepted += int(acc)
    check(accepted == commits and int(mem.count) == m,
          f"{commits} commits accepted into the ring (n={n}, {storage})")
    return mem


def kernel_phase(dev):
    phase("3. direction kernel vs plain version on the card")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    timing = {}
    for n in (900, 1500, N_FLAGSHIP):
        for storage in (torch.float32, torch.bfloat16):
            mem = committed_memory(n, storage, dev, gen)
            g = torch.randn(n, device=dev, generator=gen)
            c = mem.c0 + mem.gamma * mem.cg
            args = (mem.s, mem.y, g, c, mem.gamma)
            got = tlk.direction_streamed(*args)
            want = tlk.direction_streamed_ref(*args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_abs = float(err.max())
            max_rel = float((err / want.abs().clamp_min(1e-30)).max())
            close = bool(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                        atol=KERNEL_ATOL))
            worst = max(worst, max_abs)
            check(close, f"n={n} {str(storage)[6:]}: max_abs_err={max_abs:.3e} "
                  f"max_rel_err={max_rel:.3e} within rtol={KERNEL_RTOL} "
                  f"atol={KERNEL_ATOL}")
            if n == N_FLAGSHIP:
                flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

                def kern():
                    return tlk.direction_streamed(*args)

                def plain():
                    return tlk.direction_streamed_ref(*args)
                # in turns: plain, kernel, kernel, plain
                p1, k1, k2, p2 = (device_ms(f, 50)
                                  for f in (plain, kern, kern, plain))
                name = str(storage)[6:]
                timing[name] = dict(
                    ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                    cold_ms=device_ms(kern, 30, flush),
                    cold_plain_ms=device_ms(plain, 30, flush),
                    host_ms=host_ms(kern, 200),
                    plain_host_ms=host_ms(plain, 200))
                t = timing[name]
                print(f"  time n={n} {name}, device: kernel {k1:.4f}/{k2:.4f}"
                      f" ms, plain {p1:.4f}/{p2:.4f} ms (back to back, W warm"
                      f" in L2); L2 flushed: kernel {t['cold_ms']:.4f} ms, "
                      f"plain {t['cold_plain_ms']:.4f} ms", flush=True)
                print(f"  time n={n} {name}, host wall per call: kernel "
                      f"{t['host_ms']:.4f} ms, plain {t['plain_host_ms']:.4f}"
                      " ms", flush=True)
    return worst, timing


# ---------------------------------------------------------------------------
def bench_data(dev):
    """bench.py's data, made the same way from numpy's default_rng(1)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((NUM_BATCHES, BATCH_SIZE, N_FEATURES)).astype(
        np.float32)
    labels = rng.integers(0, N_CLASSES, (NUM_BATCHES, BATCH_SIZE))
    Y = np.eye(N_CLASSES, dtype=np.float32)[labels]
    x0 = rng.standard_normal(N_FLAGSHIP).astype(np.float32)
    return (torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev),
            torch.from_numpy(x0).to(dev))


def grad_fn(x, batch):
    return losses.multinomial_logistic_grad(x, batch[0], batch[1], None, REG)


def main_path_phase(dev):
    phase("4. main path: FusedTrainer('SQN') at BibTeX shape, 2 epochs")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(x, Xf, Yf, None, REG))

    trainer = FusedTrainer("SQN", SQNConfig.create(
        mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ), grad_fn)
    state = trainer.init(x0)
    loss0 = full_loss(state.x)
    check(abs(loss0 - JAX_LOSS_X0) <= 1e-5 * JAX_LOSS_X0,
          f"loss at x0 {loss0:.4f} is the JAX package's {JAX_LOSS_X0} "
          "(same data)")
    data = (X, Y)
    steps = 2 * NUM_BATCHES

    torch.cuda.synchronize()
    tlk.LAUNCHES = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")     # a host sync inside raises
    state, infos = trainer.epochs(state, data, STEP, nepochs=2, aligned=True)
    torch.cuda.set_sync_debug_mode(0)
    check(True, "no host sync inside epochs (sync debug mode 'error')")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = tlk.LAUNCHES
    print(f"  2 epochs ({steps} steps) in {first_s:.3f} s, first call "
          "included", flush=True)

    infos_l = infos.cpu().flatten().tolist()
    loss2 = float(full_loss(state.x))
    count = int(state.mem.count)
    check(launches == steps,
          f"direction kernel launched {launches} times for {steps} steps")
    check(bool(torch.isfinite(state.x).all()), "x is finite")
    check(len(infos_l) == steps and set(infos_l) <= VALID_INFO,
          f"{len(infos_l)} info codes, all valid: {sorted(set(infos_l))}")
    check(loss2 < loss0, f"loss fell: {loss0:.4f} -> {loss2:.4f}")
    rel = abs(loss2 - JAX_LOSS_2_EPOCHS) / JAX_LOSS_2_EPOCHS
    check(rel <= LOSS_RTOL,
          f"loss after 2 epochs {loss2:.4f} vs JAX package "
          f"{JAX_LOSS_2_EPOCHS} (CPU): rel diff {rel:.3e} <= {LOSS_RTOL}")
    check(set(infos_l) == {200}, f"all {steps} info codes are 200")
    check(count == MEM_SIZE, f"ring count == {MEM_SIZE}")

    epoch_ips = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.epochs(state, data, STEP, nepochs=1, aligned=True)
        torch.cuda.synchronize()
        epoch_ips.append(NUM_BATCHES / (time.perf_counter() - t0))
    ips = statistics.median(epoch_ips)
    print(f"  steady epochs: {', '.join(f'{v:.1f}' for v in epoch_ips)} "
          f"iters/s; median {ips:.1f} iters/s", flush=True)
    check(bool(torch.isfinite(state.x).all()), "x finite after 5 epochs")

    # The layers of one step and one boundary, each timed alone.
    batch = (X[0], Y[0])
    big = _flat((X[:UPD_FREQ], Y[:UPD_FREQ]))
    g = grad_fn(state.x, batch)
    bstate = state.replace(niter=state.niter + UPD_FREQ)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    layers = {
        "minibatch gradient": (lambda: grad_fn(state.x, batch), 20),
        "two_loop_cached": (lambda: two_loop_cached(g, state.mem,
                                                    collapsed=True), 20),
        "boundary (jvp HVP + commit)": (
            lambda: _sqn_boundary(trainer.cfg, grad_fn, bstate, big, bad), 3),
    }
    for name, (fn, iters) in layers.items():
        print(f"  layer {name}: device {device_ms(fn, iters):.4f} ms, host "
              f"wall {host_ms(fn, iters):.4f} ms", flush=True)
    print(f"  step at the median rate: {1e3 / ips:.4f} ms", flush=True)
    return launches, ips


# ---------------------------------------------------------------------------
def parity_phase(dev):
    phase("5. device vs CPU, small problem (f=12, c=5, bs=4, B=8, m=3, L=4)")
    f, c, bs, nb, m, L = 12, 5, 4, 8, 3, 4
    rng = np.random.default_rng(3)
    X = rng.standard_normal((nb, bs, f)).astype(np.float32)
    Y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (nb, bs))]
    x0 = (0.1 * rng.standard_normal((f + 1) * c)).astype(np.float32)
    trainer = FusedTrainer("SQN", SQNConfig.create(mem_size=m,
                                                   bfgs_upd_freq=L), grad_fn)
    out = []
    for where in (torch.device("cpu"), dev):
        data = (torch.from_numpy(X).to(where), torch.from_numpy(Y).to(where))
        st = trainer.init(torch.from_numpy(x0).to(where))
        before = tlk.LAUNCHES
        st, infos = trainer.epochs(st, data, 0.05, nepochs=2, aligned=True)
        out.append((st.x.cpu().numpy(), infos.cpu().numpy(),
                    tlk.LAUNCHES - before))
    (x_cpu, i_cpu, n_cpu), (x_dev, i_dev, n_dev) = out
    check(n_cpu == 0 and n_dev == 2 * nb,
          f"kernel launches: CPU {n_cpu}, card {n_dev}")
    check(np.array_equal(i_cpu, i_dev), "same info codes")
    err = float(np.max(np.abs(x_cpu - x_dev)))
    check(np.allclose(x_dev, x_cpu, rtol=PARITY_RTOL, atol=PARITY_ATOL),
          f"x agrees: max_abs_err={err:.3e} within rtol={PARITY_RTOL} "
          f"atol={PARITY_ATOL}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    phase("1. card and settings")
    card = nvidia_smi()
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}",
          flush=True)

    phase("2. build the direction kernel")
    t0 = time.perf_counter()
    path = tlk.build()
    built = tlk.build_log
    print(f"  {path.relative_to(os.path.dirname(os.path.abspath(__file__)))}"
          f" ready in {time.perf_counter() - t0:.2f} s"
          + (f" (nvcc {built[0]:.2f} s)" if built else " (already built)"))
    if built:
        print("  " + built[1].strip().replace("\n", "\n  "), flush=True)

    max_abs, timing = kernel_phase(dev)
    launches, ips = main_path_phase(dev)
    parity_phase(dev)

    f32 = timing["float32"]
    print(json.dumps({"kernels": [{
        "name": "direction_streamed",
        "route": "cuda",
        "source": "stochqn_tpu_torch/csrc/direction_streamed.cu",
        "replaces": "stochqn_tpu/ops/pallas/two_loop_kernel.py:309",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "cold_ms": f32["cold_ms"],
        "cold_plain_ms": f32["cold_plain_ms"],
        "host_ms": f32["host_ms"],
        "plain_host_ms": f32["plain_host_ms"],
        "bf16": timing["bfloat16"],
        "iters_per_s": ips,
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
