#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each failure raises and exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), torch / CUDA versions and
   the float32 matmul settings (TF32 off, "highest").  No CUDA: exit 1.
2. Build both kernels (direction, adaQN projection) from
   ``stochqn_tpu_torch/csrc``, one nvcc per source, started together.
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
6. The adaQN projection kernel against its plain version on the card, on
   full committed rings (m = 4 and 10) at n = 700, 1,000, 1,500 and
   292,083, with a positive and a signed diagonal; at n = 292,083 both
   against a float64 plain version; then both timed at the flagship shape.
7. The adaQN main path: ``FusedTrainer("adaQN")`` at BibTeX shape on
   the same data (fisher_size 100, RMSProp 0.9, eta 0.1), 2 epochs
   through ``epochs``, with ``use_pallas=True`` (the projection kernel)
   and with the plain ``matvec`` default.  Checks: no host sync inside,
   one projection launch per step, the JAX package's info codes and ring
   counts, the guard's f where the float32 paths still agree, and the
   kernel route against the plain one; then the plain route in float64
   against the JAX package's float64 run at every boundary (see
   ``F64_RTOL``).  Then both routes timed in turns, and the adaQN layers
   timed one by one.
8. adaQN device against CPU on a small problem.

The last two lines are the kernels' JSON record and the contract line
``{"ok": true, "device": {...}}``; the card's ``nvidia-smi`` line is
printed before them.
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

from stochqn_tpu_torch import AdaQNConfig, FusedTrainer, SQNConfig  # noqa: E402
from stochqn_tpu_torch.core.state import AdaQNState, BFGSMemory  # noqa: E402
from stochqn_tpu_torch.fused import (_adaqn_boundary, _flat,  # noqa: E402
                                     _sqn_boundary)
from stochqn_tpu_torch.models import losses  # noqa: E402
from stochqn_tpu_torch.ops.accumulators import diag_rescal  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402
from stochqn_tpu_torch.ops.pairs import commit_pair, fisher_y  # noqa: E402
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

# adaQN on the same data, as the JAX package runs it on the CPU:
# FusedTrainer("adaQN", AdaQNConfig.create(mem_size=10, fisher_size=100,
# bfgs_upd_freq=20, rmsprop_weight=0.9, coupling=...)) with obj_fn = the
# multinomial loss (reg 0.1), .jit_epochs() for 2 epochs at eta = 0.1.  At
# the AdaGrad default nearly every guard rejects on this data and the ring
# stays empty, so this config keeps the two-loop on pairs
# (benchmarks/all_optimizers.py:61-70).  The Fisher buffer (117 MB) is in
# ring mode.  Every run below ends with these codes at the 12 boundaries
# ({200: 234, 201: 6} over all steps), one live pair and 20 Fisher rows.
ADAQN_KW = dict(mem_size=MEM_SIZE, fisher_size=100, bfgs_upd_freq=UPD_FREQ,
                rmsprop_weight=0.9)
ADAQN_STEP = 1e-1
JAX_ADAQN_INFOS = {200: 234, 201: 6}
JAX_ADAQN_BOUNDARY_INFOS = [200, 200, 201, 200, 201, 200, 200, 201, 201, 201,
                            201, 200]
# Loss after 2 epochs in float32, with coupling "gram" (the kernel route's
# math) and "matvec" (the default route).
JAX_ADAQN_LOSS = {"kernel": 117_689.0390625, "matvec": 117_735.6328125}
# The same program in float64 (jax_enable_x64; the two couplings agree to
# 1e-10): the guard's f at the 12 boundaries, and the loss after 2 epochs.
JAX_F64_GUARD_F = (23430.0262, 17330.610467, 110073.574852, 15818.688403,
                   102513.708388, 14357.352147, 6540.564948, 75952.319173,
                   13100.030439, 7391.540352, 11766.631849, 3335.811903)
JAX_F64_LOSS = 117_004.87579
# The float32 trajectory amplifies its roundings: the JAX package's own
# float32 run is 3.4e-5 from its float64 run at the first boundaries, 0.5%
# at the fifth, and 0.58% in the loss after 2 epochs, so a float32 run that
# sums in any other order cannot be held within 0.1% of the JAX float32
# loss.  The port is held to the JAX package where the float32 paths still
# agree, and in float64 all the way:
# - float64 (the plain route on the same inputs in float64): the guard's f
#   at every boundary and the loss after 2 epochs within F64_RTOL of the
#   JAX float64 run (the port on the CPU: 1.4e-7 at worst);
# - float32, each route: the boundary info codes exactly; the guard's f at
#   the first EARLY_BOUNDARIES boundaries within EARLY_RTOL of the float64
#   values (the JAX float32 run: 3.4e-5 at worst, the port on the CPU:
#   3.9e-6); the loss after 2 epochs within FINAL_RTOL of the float64 loss
#   (the JAX float32 run: 0.58%);
# - the kernel route against the plain matvec route on the card: the
#   guard's f at the first ROUTE_BOUNDARIES boundaries within ROUTE_RTOL (a
#   projection that drops (Y o D) g, or scales S g by 1.1, moves them by
#   3e-5 or more).
F64_RTOL = 1e-6
EARLY_BOUNDARIES, EARLY_RTOL = 3, 5e-5
FINAL_RTOL = 1e-2
ROUTE_BOUNDARIES, ROUTE_RTOL = 4, 5e-6

# adaQN projection kernel vs plain version at n <= 1,500: the tolerance of
# tests/test_pallas_kernels.py for the same kernel.  At n = 292,083 a fixed
# absolute tolerance does not fit sums of that length: both are held
# against a float64 plain version within 1e-5 of the sum of the terms'
# magnitudes (a float32 sum in any blocked order carries at most a few
# hundred roundings of 6e-8 relative to that sum).
ADAQN_RTOL, ADAQN_ATOL = 2e-5, 1e-4
ADAQN_BOUND_REL = 1e-5


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
    tlk.LAUNCHES = tlk.PROJECT_ADAQN_LAUNCHES = 0
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
    check(tlk.PROJECT_ADAQN_LAUNCHES == 0,
          "the adaQN projection kernel is not on the SQN path")

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


# ---------------------------------------------------------------------------
def projection_f64(s, y, diag, g):
    """(values, magnitudes) of the projection in float64 on the card:
    the three products, and the same of the absolute values."""
    s, y, diag, g = (t.double() for t in (s, y, diag, g))
    w, yd = torch.cat([s, y]), y * diag
    vals = (w @ g, yd @ g, yd @ y.T)
    mags = (w.abs() @ g.abs(), yd.abs() @ g.abs(), yd.abs() @ y.abs().T)
    return vals, mags


def adaqn_kernel_phase(dev):
    phase("6. adaQN projection kernel vs plain version on the card")
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = worst_share = 0.0
    timing = None
    for n in (700, 1000, 1500, N_FLAGSHIP):
        for m in (4, MEM_SIZE):
            mem = committed_memory(n, torch.float32, dev, gen,
                                   commits=m + 2, m=m)
            g = torch.randn(n, device=dev, generator=gen)
            for signed in (False, True):
                diag = (torch.randn(n, device=dev, generator=gen) if signed
                        else 0.1 + 1.9 * torch.rand(n, device=dev,
                                                    generator=gen))
                args = (mem.s, mem.y, diag, g)
                got = tlk.project_adaqn(*args)
                want = tlk.project_adaqn_ref(*args)
                torch.cuda.synchronize()
                what = f"n={n} m={m} {'signed' if signed else 'positive'}"
                max_abs = max(float((a - b).abs().max())
                              for a, b in zip(got, want))
                worst = max(worst, max_abs)
                check(bool(torch.equal(got[2], got[2].T)),
                      f"{what}: ydy symmetric")
                if n != N_FLAGSHIP:
                    close = all(torch.allclose(a, b, rtol=ADAQN_RTOL,
                                               atol=ADAQN_ATOL)
                                for a, b in zip(got, want))
                    check(close, f"{what}: kernel vs plain max_abs_err="
                          f"{max_abs:.3e} within rtol={ADAQN_RTOL} "
                          f"atol={ADAQN_ATOL}")
                    continue
                vals, mags = projection_f64(*args)
                for who, res in (("kernel", got), ("plain", want)):
                    ratio = max(float(((r.double() - v).abs()
                                       / (ADAQN_BOUND_REL * mag)).max())
                                for r, v, mag in zip(res, vals, mags))
                    if who == "kernel":
                        worst_share = max(worst_share, ratio)
                    check(ratio <= 1.0,
                          f"{what}: {who} vs float64 within "
                          f"{ADAQN_BOUND_REL} x sum|terms| (worst entry "
                          f"at {ratio:.3f} of it); kernel vs plain "
                          f"max_abs_err={max_abs:.3e}")
                if m == MEM_SIZE and not signed:
                    timing = time_projection(dev, args)
    return worst, worst_share, timing


def time_projection(dev, args):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def kern():
        return tlk.project_adaqn(*args)

    def plain():
        return tlk.project_adaqn_ref(*args)
    p1, k1, k2, p2 = (device_ms(f, 50) for f in (plain, kern, kern, plain))
    t = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
             cold_ms=device_ms(kern, 30, flush),
             cold_plain_ms=device_ms(plain, 30, flush),
             host_ms=host_ms(kern, 200), plain_host_ms=host_ms(plain, 200))
    print(f"  time n={N_FLAGSHIP} m={MEM_SIZE}, device: kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms (back to "
          f"back, warm in L2); L2 flushed: kernel {t['cold_ms']:.4f} ms, "
          f"plain {t['cold_plain_ms']:.4f} ms", flush=True)
    print(f"  time n={N_FLAGSHIP} m={MEM_SIZE}, host wall per call: kernel "
          f"{t['host_ms']:.4f} ms, plain {t['plain_host_ms']:.4f} ms",
          flush=True)
    return t


def obj_fn(x, batch):
    return losses.multinomial_logistic_loss(x, batch[0], batch[1], None, REG)


def guard_ratios(fvals, boundary_infos):
    """f / f_prev at every boundary after the first, replaying the guard:
    f_prev moves to f on each accepted boundary."""
    ratios, f_prev = [], fvals[0]
    for f, info in zip(fvals[1:], boundary_infos[1:]):
        ratios.append(f / f_prev)
        if info != 201:
            f_prev = f
    return ratios


def max_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def adaqn_two_epochs(name, x0, data, use_pallas):
    """A trainer of the smoke's adaQN config, and 2 epochs of it from
    ``x0`` through ``epochs(aligned=True)`` under sync debug mode
    'error'.  Returns the trainer, the state, the info codes (all, and at
    the boundaries), the guard's f at each boundary and the two kernels'
    launch counts."""
    fvals = []

    def recording_obj_fn(x, batch):
        f = obj_fn(x, batch)
        fvals.append(f)         # a device tensor: no sync
        return f
    trainer = FusedTrainer("adaQN", AdaQNConfig.create(
        **ADAQN_KW, use_pallas=use_pallas), grad_fn, obj_fn=recording_obj_fn)
    # trainer.init (adaqn.init) takes float32 only: the float64 run makes
    # its state directly
    state = (trainer.init(x0) if x0.dtype == torch.float32 else
             AdaQNState.create(x0, MEM_SIZE, ADAQN_KW["fisher_size"]))
    torch.cuda.synchronize()
    tlk.LAUNCHES = tlk.PROJECT_ADAQN_LAUNCHES = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")     # a host sync inside raises
    state, infos = trainer.epochs(state, data, ADAQN_STEP, nepochs=2,
                                  aligned=True)
    torch.cuda.set_sync_debug_mode(0)
    launches = (tlk.PROJECT_ADAQN_LAUNCHES, tlk.LAUNCHES)
    check(True, f"{name}: no host sync inside epochs (sync debug mode "
          "'error')")
    torch.cuda.synchronize()
    print(f"  {name}: 2 epochs ({2 * NUM_BATCHES} steps) in "
          f"{time.perf_counter() - t0:.3f} s, first call included",
          flush=True)
    infos_l = infos.cpu().flatten().tolist()
    f_host = torch.stack(fvals).cpu().tolist()
    fvals.clear()
    return (trainer, state, infos_l, infos_l[UPD_FREQ - 1::UPD_FREQ],
            f_host, launches)


def adaqn_main_path_phase(dev):
    phase("7. adaQN main path: FusedTrainer('adaQN', use_pallas=True) at "
          "BibTeX shape, 2 epochs")
    X, Y, x0 = bench_data(dev)
    data = (X, Y)
    steps = 2 * NUM_BATCHES

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(
            x, X.reshape(-1, N_FEATURES).to(x.dtype),
            Y.reshape(-1, N_CLASSES).to(x.dtype), None, REG))

    results = {}
    for route, use_pallas in (("kernel", True), ("matvec", None)):
        trainer, state, infos_l, binfos, f, (launches, other) = \
            adaqn_two_epochs(route, x0, data, use_pallas)
        ratios = guard_ratios(f, binfos)
        edge = trainer.cfg.max_incr
        print(f"  {route}: guard f/f_prev at the {len(ratios)} later "
              f"boundaries: {', '.join(f'{r:.4f}' for r in ratios)}; "
              f"nearest to {edge}: "
              f"{min(ratios, key=lambda r: abs(r - edge)):.4f}", flush=True)
        want_launches = steps if use_pallas else 0
        check(launches == want_launches and other == 0,
              f"{route}: projection kernel launched {launches} times for "
              f"{steps} steps, direction kernel {other} times")
        check(bool(torch.isfinite(state.x).all()), f"{route}: x is finite")
        hist = {c: infos_l.count(c) for c in sorted(set(infos_l))}
        check(hist == JAX_ADAQN_INFOS and binfos == JAX_ADAQN_BOUNDARY_INFOS,
              f"{route}: info histogram {hist}, boundary codes {binfos}: "
              "the JAX package's")
        count, fcount = int(state.mem.count), int(state.fisher.count)
        check(count == 1 and fcount == 20 and not state.fisher.shift,
              f"{route}: mem.count {count} == 1, fisher.count {fcount} == "
              f"20, Fisher ring in ring mode (shift={state.fisher.shift})")
        print(f"  {route}: guard f at the boundaries: "
              f"{', '.join(f'{v:.4f}' for v in f)}", flush=True)
        early = max_rel(f[:EARLY_BOUNDARIES],
                        JAX_F64_GUARD_F[:EARLY_BOUNDARIES])
        check(early <= EARLY_RTOL,
              f"{route}: guard f at boundaries 1-{EARLY_BOUNDARIES} vs the "
              f"JAX package's float64 run: max rel diff {early:.3e} <= "
              f"{EARLY_RTOL}")
        loss2 = full_loss(state.x)
        rel64 = abs(loss2 - JAX_F64_LOSS) / JAX_F64_LOSS
        want = JAX_ADAQN_LOSS[route]
        print(f"  {route}: loss after 2 epochs {loss2:.4f}; JAX package "
              f"float32 {want} (rel diff {abs(loss2 - want) / want:.3e}), "
              f"float64 {JAX_F64_LOSS} (rel diff {rel64:.3e})", flush=True)
        check(rel64 <= FINAL_RTOL,
              f"{route}: loss after 2 epochs within {FINAL_RTOL} of the JAX "
              f"package's float64 loss: {rel64:.3e}")
        results[route] = dict(launches=launches, loss=loss2, f=f,
                              trainer=trainer, state=state)

    route_diff = max_rel(results["kernel"]["f"][:ROUTE_BOUNDARIES],
                         results["matvec"]["f"][:ROUTE_BOUNDARIES])
    check(route_diff <= ROUTE_RTOL,
          f"kernel route vs plain matvec route: guard f at boundaries "
          f"1-{ROUTE_BOUNDARIES} max rel diff {route_diff:.3e} <= "
          f"{ROUTE_RTOL}")

    # float64: the plain route on the same inputs, against the JAX
    # package's float64 run
    _, state, _, binfos, f, launches = adaqn_two_epochs(
        "float64", x0.double(), (X.double(), Y.double()), None)
    check(launches == (0, 0) and binfos == JAX_ADAQN_BOUNDARY_INFOS,
          f"float64: no kernel launched, boundary codes {binfos}: the JAX "
          "package's")
    rel_f = max_rel(f, JAX_F64_GUARD_F)
    loss64 = full_loss(state.x)
    rel64 = abs(loss64 - JAX_F64_LOSS) / JAX_F64_LOSS
    check(rel_f <= F64_RTOL and rel64 <= F64_RTOL,
          f"float64: guard f at all 12 boundaries (max rel diff {rel_f:.3e})"
          f" and the loss after 2 epochs {loss64:.4f} (rel diff "
          f"{rel64:.3e}) agree with the JAX package's float64 run within "
          f"{F64_RTOL}")

    # Steady epochs of both routes, in turns (kernel, matvec, matvec,
    # kernel, ...), so that both see the same card and host.
    rates = {route: [] for route in results}
    for route in ("kernel", "matvec", "matvec", "kernel", "kernel",
                  "matvec"):
        r = results[route]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r["state"], _ = r["trainer"].epochs(r["state"], data, ADAQN_STEP,
                                            nepochs=1, aligned=True)
        torch.cuda.synchronize()
        rates[route].append(NUM_BATCHES / (time.perf_counter() - t0))
    for route, r in results.items():
        r["ips"] = statistics.median(rates[route])
        print(f"  {route}: steady epochs (in turns): "
              f"{', '.join(f'{v:.1f}' for v in rates[route])} iters/s; "
              f"median {r['ips']:.1f} iters/s", flush=True)
        check(bool(torch.isfinite(r["state"].x).all()),
              f"{route}: x finite after 5 epochs")

    adaqn_layers(dev, X, Y, results)
    return results["kernel"]["launches"], {
        r: v["ips"] for r, v in results.items()}


def adaqn_layers(dev, X, Y, results):
    """The layers of one adaQN step and one boundary, each timed alone.
    Run last: the Fisher append and the boundary write ring rows of the
    state in place."""
    trainer, state = results["kernel"]["trainer"], results["kernel"]["state"]
    cfg = trainer.cfg
    batch = (X[0], Y[0])
    big = _flat((X[:UPD_FREQ], Y[:UPD_FREQ]))
    g = grad_fn(state.x, batch)
    diag, _ = diag_rescal(g, state.grad_sum_sq, cfg.scal_reg,
                          cfg.rmsprop_weight)
    s_cand = state.x_sum * (1.0 / UPD_FREQ) - state.x_avg_prev
    bstate = state.replace(niter=state.niter + UPD_FREQ)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    layers = {
        "minibatch gradient": (lambda: grad_fn(state.x, batch), 20),
        "AdaGrad/RMSProp rescale": (
            lambda: diag_rescal(g, state.grad_sum_sq, cfg.scal_reg,
                                cfg.rmsprop_weight), 20),
        "Fisher append (ring row, in place)": (
            lambda: state.fisher.append(g), 20),
        "projection kernel": (
            lambda: tlk.project_adaqn(state.mem.s, state.mem.y, diag, g), 20),
        "projection, plain version": (
            lambda: tlk.project_adaqn_ref(state.mem.s, state.mem.y, diag, g),
            20),
        "two_loop_cached, kernel route": (
            lambda: two_loop_cached(g, state.mem, diag=diag,
                                    use_pallas=True), 20),
        "two_loop_cached, matvec route": (
            lambda: two_loop_cached(g, state.mem, diag=diag,
                                    coupling="matvec"), 20),
        "fisher_y (F^T F s / count)": (
            lambda: fisher_y(state.fisher, s_cand), 20),
        "guard f-eval (obj_fn on the 1,000-row big batch)": (
            lambda: obj_fn(state.x, big), 20),
        "boundary (guard + fisher_y + commit)": (
            lambda: _adaqn_boundary(cfg, grad_fn, obj_fn, bstate, big, big,
                                    bad), 3),
    }
    for name, (fn, iters) in layers.items():
        print(f"  layer {name}: device {device_ms(fn, iters):.4f} ms, host "
              f"wall {host_ms(fn, iters):.4f} ms", flush=True)
    for route, r in results.items():
        print(f"  {route}: step at the median rate: {1e3 / r['ips']:.4f} ms",
              flush=True)


def adaqn_parity_phase(dev):
    phase("8. adaQN device vs CPU, small problem (f=12, c=5, bs=4, B=8, "
          "m=3, fisher 10, L=4, use_pallas=True)")
    f, c, bs, nb, m, L = 12, 5, 4, 8, 3, 4
    rng = np.random.default_rng(2)
    X = rng.standard_normal((nb, bs, f)).astype(np.float32)
    Y = np.eye(c, dtype=np.float32)[np.argmax(
        X @ rng.standard_normal((f, c)), axis=-1)]
    x0 = (0.1 * rng.standard_normal((f + 1) * c)).astype(np.float32)
    trainer = FusedTrainer("adaQN", AdaQNConfig.create(
        mem_size=m, fisher_size=10, bfgs_upd_freq=L, use_pallas=True),
        grad_fn, obj_fn=obj_fn)
    out = []
    for where in (torch.device("cpu"), dev):
        data = (torch.from_numpy(X).to(where), torch.from_numpy(Y).to(where))
        st = trainer.init(torch.from_numpy(x0).to(where))
        before = tlk.PROJECT_ADAQN_LAUNCHES
        st, infos = trainer.epochs(st, data, 0.1, nepochs=2, aligned=True)
        out.append((st.x.cpu().numpy(), infos.cpu().numpy(),
                    tlk.PROJECT_ADAQN_LAUNCHES - before))
    (x_cpu, i_cpu, n_cpu), (x_dev, i_dev, n_dev) = out
    check(n_cpu == 0 and n_dev == 2 * nb,
          f"projection kernel launches: CPU {n_cpu}, card {n_dev}")
    check(np.array_equal(i_cpu, i_dev),
          f"same info codes: {i_dev.flatten().tolist()}")
    check((i_dev.flatten()[2 * L - 1::L] == 200).any(),
          "a later boundary committed a pair")
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

    phase("2. build the kernels")
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
    adaqn_max_abs, adaqn_share, adaqn_timing = adaqn_kernel_phase(dev)
    adaqn_launches, adaqn_ips = adaqn_main_path_phase(dev)
    adaqn_parity_phase(dev)

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
    }, {
        "name": "project_adaqn",
        "route": "cuda",
        "source": "stochqn_tpu_torch/csrc/project_adaqn.cu",
        "replaces": "stochqn_tpu/ops/pallas/two_loop_kernel.py:390",
        "launches": adaqn_launches,
        "max_abs_err": adaqn_max_abs,
        "worst_err_share_of_f64_bound": adaqn_share,
        **adaqn_timing,
        "iters_per_s": adaqn_ips["kernel"],
        "plain_route_iters_per_s": adaqn_ips["matvec"],
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
