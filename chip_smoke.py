#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --kernels`` runs only the kernel phases 3, 6, 9,
10 and 23, for work on a kernel; it prints no contract line.)

Phases (each failure raises and exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), torch / CUDA versions and
   the float32 matmul settings (TF32 off, "highest").  No CUDA: exit 1.
2. Build the four kernels (both directions, both projections) from
   ``stochqn_tpu_torch/csrc``, one nvcc per source, started together;
   ptxas's report must name every kernel and no spill.
3. The streamed direction kernel against its plain PyTorch version on the
   card, on a real
   commit cache (12 commits into a ring of m = 10), at n = 900, 1,500 and
   292,083, for float32 and bfloat16 pair storage; then both timed at the
   flagship shape with CUDA events, and again at m = 20 (the shape phase 11
   gives it, which no H100 parks whole) beside the bound at that shape;
   with float32 pairs beside the library sequence ``W @ g``, ``C @ wg``,
   ``addmv`` (phase 10's: in float32 the kernel computes ``direction``'s
   function; no one call reads bfloat16 pairs against a float32 ``g``).
   Then kernel against plain and the same bits twice at m = 1, 10, 20, 32
   and n = 2,001 ... 2,008 (every 16-byte phase of the rows), and at n that
   the card's shared memory parks wholly, partly and hardly at all.
4. The main path: ``FusedTrainer("SQN")`` at BibTeX shape (1,836 features,
   159 classes, batches of 50, 120 batches, m = 10, L = 20) on bench.py's
   data, 2 epochs through ``epochs``, from a numpy ``x0`` with no device
   named.  Checks: the state is on the card, no host sync inside,
   finite ``x``, valid info codes, lower loss, one launch per step of the
   direction kernel the gate chose (the one-read kernel where the card's
   shared memory parks the pairs, else the streamed one), and the JAX
   package's result (below).  Then steady epochs of the gate's route and
   of the streamed route forced, timed in turns, and the main path's layers
   timed one by one.
5. Device against CPU on a small problem (the CPU runs the plain version).
6. The adaQN projection kernel against its plain version on the card, on
   full committed rings (m = 4 and 10) at n = 700, 1,000, 1,500 and
   292,083, with a positive and a signed diagonal; at n = 292,083 both
   against a float64 plain version; then both timed at the flagship shape.
   Then kernel against plain and the same bits twice at m = 1, 10, 23, 32 and
   n = 2,001 ... 2,004, positive and signed diagonal.
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
9. The ``project`` kernel against its plain version on the card at
   n = 700, 1,000, 1,500, 2,048 and 292,083, m = 5 and 10, and at
   n = 292,083 also m = 20; at n = 292,083 both against a float64 plain
   version; timed at the flagship shape beside the plain version and the
   library pair ``W @ g``, ``W @ W.T``.  Then kernel against plain, the
   same bits twice and a symmetric Gram at m = 1, 10, 14, 20, 23, 32 and
   n = 2,001 ... 2,008 (every 16-byte phase of the rows), and the kernel
   timed at m = 20 and m = 32 beside its bound and the library pair there.
10. The one-read ``direction`` kernel against its plain version and
    against the streamed kernel on a real commit cache at n = 900, 1,500,
    292,083 (where the card's cap admits it) and the largest n within the
    cap, and at m = 1, 10, 32 and n = 2,001 ... 2,008 (every 16-byte phase
    of the rows), the same bits twice; the first n over the cap must
    raise; then timed at the flagship shape beside the plain version and
    the library sequence ``W @ g``, ``C @ wg``, ``addmv``, both direction
    kernels in turns, and by n from 900 to 292,083 (the floor at n = 900
    and the cap go into the kernels' record).
11. The free-mode SQN path at full width: ``SQN_free(mem_size=10,
    bfgs_upd_freq=20, use_float=True)`` driven by a request loop for one
    epoch of the same data, gradients and Hessian-vector products from
    ``losses`` on the card.  Checks: the request order, every
    ``iteration_info``, one launch per step of the direction kernel the
    gate chose and none of a plain version, after every commit the
    uncached oracle ``two_loop(use_pallas=True)`` (the ``project``
    kernel) against the cached direction, ``x`` against
    ``FusedTrainer("SQN")`` on the same batches, and the JAX package's
    loss (below).  Then three rounds with ``mem_size=20``, whose pairs no
    H100 parks: one launch per step of the streamed kernel, and the same
    oracle audit after its two commits (``project`` at m = 20).
12. The free-mode adaQN path for three boundaries: ``adaQN_free`` in
    float64, the function values it asks for against the JAX package's
    float64 run; and in float32 with ``use_pallas=True`` in its config, one
    projection launch per step.
13. oLBFGS at BibTeX shape (m = 10, eta 1e-2, as
    ``benchmarks/all_optimizers.py:40-52`` runs it):
    ``FusedTrainer("oLBFGS")`` for 2 epochs through ``epochs``, from a numpy ``x0`` with no device
    named, in block layout and with ``pairs_interleaved=True``, under sync
    debug mode "error".  Checks: the state on the card, no kernel and no
    plain version launched (no kernel serves oLBFGS), finite ``x``, every
    info code 200, 10 live pairs, the JAX package's loss (below).  Then
    both layouts timed in turns, the device's idle share from a profiler
    trace, and the layers of a step one by one (the gradient, the
    uncollapsed ``two_loop_cached`` per layout, ``commit_pair`` in block,
    shift and ring mode with the bytes each commit holds at its peak).
    Then ``oLBFGS_free`` in a request loop for one epoch: the request
    order, every ``iteration_info``, the JAX package's loss after one
    epoch, ``x`` against the fused engine on the same batches.
14. ``FusedTrainer("SQN")`` with ``pairs_interleaved=True`` at the flagship
    shape, 2 epochs: one launch per step of the direction kernel the gate
    chose, on the views ``sy[:m]`` / ``sy[m:]``, and no plain version; the
    JAX package's loss; ``x`` against the block layout's run; both layouts
    timed in turns.  Then 3 rounds at ``mem_size=20`` on
    ``direction_streamed``, with the same launch check and loss.
15. The generic per-step layout at the flagship shape: fused SQN for 2
    epochs with ``aligned=False`` (one host read, ``niter``) against the
    chunked run, bit for bit; 2 epochs on the first 110 batches
    (``B % L != 0``: the boundary window wraps into unconsumed batches)
    and an epoch resumed 10 steps into a round, each against the JAX
    package's loss; both layouts timed in turns with their idle shares;
    fused adaQN (kernel route) on the generic path against its chunked run
    bit for bit, the JAX codes, and in float64 every guard f within 1e-6.
16. bfloat16 storage: fused SQN with ``pairs_bf16=True`` in block layout
    and interleaved, every direction on ``direction_streamed``'s bfloat16
    variant and no plain version; oLBFGS with bfloat16 interleaved pairs,
    in float32 and again in float64 math; adaQN with ``fisher_bf16=True``
    on the projection kernel; each against the JAX package's bfloat16 run
    (gates beside ``BF16_RTOL``); bf16 and
    float32 SQN timed in turns, idle shares, the collapsed direction's
    device time.
17. The drivers: ``epochs_scheduled`` for 3 epochs on permutations from
    ``default_rng(2)`` at ``step_size_sqrt`` steps against the JAX
    package's ``jit_epochs_scheduled``; ``run_epochs`` with a shuffle
    generator against ``epochs_scheduled`` on the permutations it drew,
    bit for bit, with one host read (``niter``); ``stream_rounds`` of numpy minibatches through
    ``prefetch_to_device`` against ``epochs``, bit for bit; oLBFGS with
    ``paired_grads=True`` against the sequential layout (codes; ``x`` in
    float64), timed in turns.
18. The front ends on the same draws flattened to 6,000 rows, numpy in
    and no device named (``tools/jax_front_end_references.py`` prints the
    JAX numbers): (a) ``StochasticLogisticRegression`` fused SQN, every
    epoch under sync debug mode "error", one launch per step of the
    direction kernel the gate chose and no plain version, the JAX loss;
    (b) the guided ``SQN`` on the protocol engine for an epoch (the request
    order, one launch per step, ``x`` against the fused engine on the same
    batches, the JAX loss); (c) the guided ``SQN`` fused, one scheduled
    dispatch of 2 shuffled epochs, the JAX loss; (d) the model's adaQN
    with ``use_pallas=True`` (``project_adaqn`` per step; float32 within
    1e-2 and float64 within 1e-6 of the JAX float64 loss); (e) the model's
    oLBFGS; (f) the model's SQN on a CSR matrix against its densified copy;
    (g) ``minimize`` from a numpy ``x0`` and ``MLPClassifier(hidden=(64,))``;
    (h) ``OLBFGS`` as a ``torch.optim.Optimizer`` for 20 steps; (i)
    ``save_state`` mid-protocol, ``load_state`` into a fresh ``SQN_free``,
    the next 10 requests bit for bit; (j) the model's fused fit in turns
    with bare ``FusedTrainer`` runs of the same steps, and the host wall of
    a protocol request.
19. The sharded paths (``stochqn_tpu_torch.parallel``) at the same shape:
    (a) in this process, an NCCL group of one rank and a (1, 1) mesh:
    fused SQN for 2 epochs gives phase 4's bits, one launch per step of the
    gate's kernel, and in the recorder one all-reduce of n * 4 bytes per
    base step and per boundary; then through ``jit_epochs`` (CUDA graphs
    that hold NCCL's kernels) fused SQN, adaQN on ``project_adaqn`` and
    ``StochasticLogisticRegression(mesh=make_mesh(1, 1))``: the eager
    runs' bits (SQN phase 4's), the kernel counted 120 times a replay, the
    recorder's log on the replays the eager log, op for op.  Where the
    machine has the cards, clusters of one card a rank over NCCL: (2, 1)
    SQN and adaQN, (1, 3) SQN and oLBFGS on the split route, each through
    ``jit_epochs`` against the same cluster's eager epochs bit for bit,
    with (b)-(d)'s gates and budgets, and SQN's graph and eager iters/s in
    turns; with fewer cards a line says that they did not run.  Then
    clusters of this script, one process per rank (``--rank``), all ranks
    on cuda:0 over gloo (NCCL refuses two ranks on one GPU; the tensors
    stay on the card): (b) a (2, 1) mesh, data-parallel fused SQN: x
    bit-identical on both ranks, each launching the gate's kernel per
    step, (a)'s budget with group size 2, the JAX loss within 0.1%,
    ``jit_epochs()`` raising, naming gloo; (c) the same mesh, adaQN with
    ``use_pallas=True`` (``project_adaqn`` per step on each rank): phase
    7's boundary codes and guard f at the first boundaries; (d) a (1, 3)
    mesh (n = 3 x 97,361),
    parameter-sharded fused SQN and oLBFGS: the split route every SQN step,
    no kernel launched, the CPU tests' collective budget, the JAX losses
    within 0.1%; (e) the (2, 1) mesh, ``StochasticLogisticRegression``
    with ``reg_param=0.1`` within 1e-5 of its unsharded fit (the penalty
    counted once); (f) ``save_sharded`` after (d)'s first epoch,
    ``load_sharded`` into 3 fresh ranks and one more epoch: (d)'s bits;
    (g) iters/s of (b) and (d) and of one rank in this process before and
    after the clusters, and the host share of an epoch spent in
    collectives, each labelled as gloo on one card.
20. A bfloat16 iterate at the same shape: fused SQN from a bfloat16
    ``x0`` for 2 epochs on bfloat16 data and on float32 data, under sync
    debug mode "error", and ``SQN_free(dtype=torch.bfloat16)`` for one
    epoch of phase 11's loop.  Checks: bfloat16 ``x`` and pairs with a
    float32 Gram on the card, one ``direction_streamed`` launch per base
    step (on the gradient's upcast) and no plain version, the JAX
    package's codes and live pairs, the loss within twice the JAX
    bfloat16 run's distance to its float32 run (``rule_gate``); then the
    kernel on a bfloat16 gradient against its plain version and against
    the float32-gradient call (the same bits), and both timed in turns,
    warm and with L2 flushed.
21. The native C++ tier (``native_backend``, built with g++ from
    ``native/src``; a failed build fails the run): ``oLBFGS_free``,
    ``SQN_free`` (Hessian-vector and gradient-difference pairs) and
    ``adaQN_free`` with ``backend="native"`` in float64 in lockstep with
    the card's ``backend="torch"`` float64 on a small quadratic (the same
    tasks and infos, ``x`` within ``NATIVE_RTOL`` / ``NATIVE_ATOL``); then
    ``SQN_free(backend="native", use_float=True)`` for one epoch at
    BibTeX shape with gradients computed on the card (phase 11's codes and
    loss gate), and the host wall per ``run_optimizer`` call of the native
    core and the card's backend, in turns.

22. The single-dispatch programs (``jit_epochs`` and the others: each
    epoch one replay of a CUDA graph) at the same shape, each against the
    eager ``epochs`` from one numpy ``x0``, every tensor of the state and
    every info code the same bits, the eager run's kernel launches equal
    to the replays' and nothing else launched but each graph's warm-up
    epoch: (a) fused SQN for 20 epochs (the JAX loss after 2 on the
    cached graph); (b) oLBFGS in block and interleaved shift layout (its
    output buffer copied back each replay), the JAX losses; (c) adaQN's
    kernel route (``project_adaqn`` captured) and matvec route, and in
    float64 the JAX codes and loss within ``F64_RTOL``; each timed against
    the eager loop in turns from fresh states, with the call's peak
    memory, the device's idle share and, from a profiler trace of one
    replay, its device time by kernel name and the kernel's launches, time
    a launch and share of the replay; (d) ``jit_epochs_scheduled`` on phase
    17's schedule against the eager ``epochs_scheduled`` and the JAX loss,
    a second call at another step on the cached graph, ``donate`` False
    (the input unchanged) and True (the graph's own buffers back, passed
    in again without a copy); (e) phase 18's model and guided fused fits
    each replayed a graph for their 2 epochs; (f) fused SQN on a (1, 1)
    NCCL mesh through ``jit_epochs`` against its eager epochs bit for bit,
    then the mesh's eager and graph runs and the unsharded graph timed in
    turns, their idle shares, and from a profiler trace of one replay of
    each graph the device time of NCCL's kernels and of the copies (the
    mesh's ``sum_data`` clones).  It prints a ``graphs:`` line of its
    records.

23. The grouped product of a mixture of experts (``csrc/grouped_mm.cu``)
    at the shapes ``sqn_dsv2lite.graph`` gives it: 4,096 tokens routed
    top-6 of 64 by a random router through the model's own ``route`` and
    ``dispatch`` (a real routing, no dropped token), 8 experts held, the
    24,576-row buffer; ``W_up`` ``[8, 2,048, 1,408]`` and ``W_down``
    ``[8, 1,408, 2,048]``.  Forward, backward (``dx`` through the
    transposed weight, ``dw`` the weight-gradient kernel) and the
    forward-mode rule, and the jvp of a gradient through both kernels,
    each against the plain per-group version on the same inputs within
    ``GMM_RTOL`` of the largest entry (near float32 rounding: TF32 reads
    ~1e-3); one launch a product.  Both kernels timed beside the plain
    per-expert ``torch.mm`` loop and the bound.  Then the main path:
    a small DeepSeek-V2 (the cell's structure at small widths) trained by
    ``PytreeTrainer("SQN", donate=True, boundary_per_batch=True)
    .jit_epochs()`` for 2 epochs in one call, every launch count set to 0
    right before it: the grouped products counted equal
    ``GMM_PER_STEP`` a step and MoE layer (the gradient's and the jvp's,
    recomputations included) and the direction kernel one a step.  Also
    run by ``--kernels``.

The last two lines are the kernels' JSON record and the contract line
``{"ok": true, "device": {...}}``; the card's ``nvidia-smi`` line is
printed before them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               OLBFGS, OLBFGSConfig, SQN, SQN_free, SQNConfig,
                               StochasticLogisticRegression, adaQN_free,
                               graphs, load_state, minimize, oLBFGS_free,
                               save_state)
from stochqn_tpu_torch.core.state import (BFGSMemory,  # noqa: E402
                                          BFGSMemoryInterleaved,
                                          SHIFT_MAX_BYTES)
from stochqn_tpu_torch.fused import (_adaqn_boundary, _flat,  # noqa: E402
                                     _sqn_boundary, olbfgs_step)
from stochqn_tpu_torch.models import losses  # noqa: E402
from stochqn_tpu_torch.models.mlp import (MLPClassifier,  # noqa: E402
                                          init_mlp_params, mlp_loss)
from stochqn_tpu_torch.ops.accumulators import diag_rescal  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402
from stochqn_tpu_torch.ops.pairs import commit_pair, fisher_y  # noqa: E402
from stochqn_tpu_torch.ops import two_loop as two_loop_mod  # noqa: E402
from stochqn_tpu_torch.ops.two_loop import (two_loop,  # noqa: E402
                                            two_loop_cached)
from stochqn_tpu_torch.utils.data import (prefetch_to_device,  # noqa: E402
                                          stream_rounds)
from stochqn_tpu_torch.utils.schedules import step_size_sqrt  # noqa: E402

# BibTeX shape and the bench.py workload (bench.py:70-78, :131-137).
N_FEATURES, N_CLASSES, BATCH_SIZE, NUM_BATCHES = 1836, 159, 50, 120
UPD_FREQ, MEM_SIZE, REG, STEP = 20, 10, 1e-1, 1e-2
N_FLAGSHIP = (N_FEATURES + 1) * N_CLASSES          # 292,083
M20 = 20     # the mem_size whose pairs no H100 parks whole at n = 292,083
# The pairs of the benchmark's cells that run direction_streamed, m = 10:
# sqn_criteo.graph's (float32, 80 MB) and sqn_dsv2lite.graph's (bfloat16,
# 21.4 GB).
N_CRITEO, N_DSV2LITE = 1_000_000, 535_060_992

# The JAX package (stochqn_tpu) on the CPU, on exactly this data:
# FusedTrainer("SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=20))
# .jit_epochs() for 2 epochs at eta = 1e-2 takes the full-data loss
# (reg 0.1) from 709,638.8125 at x0 to 451,613.0; all 240 info codes are
# 200 and the ring ends with count == 10.  A 1e-6 relative change of x0
# moves that loss by about 0.1, so the port must land within 0.1%.
JAX_LOSS_X0 = 709_638.8125
JAX_LOSS_2_EPOCHS = 451_613.0
LOSS_RTOL = 1e-3
# The JAX package's protocol tier on the CPU, on the same data:
# SQN_free(mem_size=10, bfgs_upd_freq=20, use_float=True) in a request loop
# at eta = 1e-2, minibatch b for the b-th calc_grad, the round's 20
# minibatches merged (example axis major, as the fused engine merges them)
# for calc_hess_vec, gradients and closed-form Hessian-vector products from
# stochqn_tpu.models.losses under jit.  One epoch: 121 calc_grad and 5
# calc_hess_vec requests, every iteration_info no_problems_encountered,
# 5 live pairs, full-data loss 515,562.25.  After 3 rounds (60 steps): 2
# calc_hess_vec requests, 2 live pairs, loss 616,679.375; with 2 pairs the
# direction does not depend on mem_size, so the mem_size = 20 run below is
# held to the same number.
JAX_FREE_SQN_LOSS_1_EPOCH = 515_562.25
JAX_FREE_SQN_LOSS_3_ROUNDS = 616_679.375
# adaQN_free(**ADAQN_KW) in float64 (jax_enable_x64) in the same loop at
# eta = 0.1, the function value on the round's merged minibatches: it asks
# for f at the points where the fused engine's guard evaluates it, and the
# first three values are JAX_F64_GUARD_F[:3] below to all printed digits;
# the third boundary is a func_increased rejection.
FREE_ADAQN_BOUNDARIES = 3

# oLBFGS on the same data, as the JAX package runs it on the CPU
# (benchmarks/all_optimizers.py:40-52): FusedTrainer("oLBFGS",
# OLBFGSConfig.create(mem_size=10[, pairs_interleaved=True])).jit_epochs()
# for 2 epochs at eta = 1e-2 takes the full-data loss from 709,638.8125 to
# JAX_OLBFGS_LOSS in float32; all 240 info codes are 200 and the memory
# ends with 10 live pairs.  The same program in float64 (jax_enable_x64,
# float64 data and x0) ends at JAX_OLBFGS_F64_LOSS in both layouts (they
# agree to 2e-14).  The float32 runs are 1.8e-4 (block) and 2.8e-4
# (interleaved) from it, under 0.1%, so float32 is held within LOSS_RTOL
# of the JAX float32 run of the same layout, as SQN is.  (The two float32
# layouts part by 1e-3 of max |x| in x, so x is not compared across them.)
# After one epoch, block, float32: JAX_OLBFGS_LOSS_1_EPOCH.
JAX_OLBFGS_LOSS = {"block": 109_646.078125, "interleaved": 109_635.265625}
JAX_OLBFGS_F64_LOSS = 109_665.92084595401
JAX_OLBFGS_LOSS_1_EPOCH = 544_529.8125
# FusedTrainer("SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=20,
# pairs_interleaved=True)), the same run: 451,613.0 after 2 epochs, as in
# block layout (JAX_LOSS_2_EPOCHS), every info code 200; its x is within
# 1.2e-5 of the block run's (max |x| 3.8), inside PARITY_RTOL /
# PARITY_ATOL.  After 3 rounds (the first 60 batches): 616,679.375 at
# mem_size 10 and 20 alike (2 live pairs), JAX_FREE_SQN_LOSS_3_ROUNDS.

# The card's peaks for the kernels' bounds: NVIDIA's data sheet for the
# H100 SXM, device memory rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# Kernel vs plain version: the tolerance of tests/test_pallas_kernels.py
# for the same kernel.  Both read the same stored pairs and accumulate in
# float32, in different orders.
KERNEL_RTOL, KERNEL_ATOL = 3e-5, 1e-4
# Device vs CPU on the small problem: 16 quasi-Newton steps, float32 in
# different orders on each side (as in tests/test_torch_fused_sqn.py).
PARITY_RTOL, PARITY_ATOL = 1e-4, 2e-5

VALID_INFO = {200, 201, 202, 203}


def reset_launches():
    """Set every kernel's launch count to 0 (before a path is driven)."""
    tlk.LAUNCHES = tlk.DIRECTION_LAUNCHES = 0
    tlk.PROJECT_LAUNCHES = tlk.PROJECT_ADAQN_LAUNCHES = 0


def read_launches():
    return {"direction_streamed": tlk.LAUNCHES,
            "direction": tlk.DIRECTION_LAUNCHES,
            "project": tlk.PROJECT_LAUNCHES,
            "project_adaqn": tlk.PROJECT_ADAQN_LAUNCHES}


def spy_plain():
    """Count the calls of the kernels' plain versions (on the card a call
    would be a fallback).  Returns the list of calls and a function that
    puts the plain versions back."""
    calls = []
    plain = {name: getattr(tlk, name) for name in
             ("direction_ref", "direction_streamed_ref", "project_ref",
              "project_adaqn_ref")}
    for name, fn in plain.items():
        setattr(tlk, name, lambda *a, _n=name, _f=fn: (
            calls.append(_n), _f(*a))[1])

    def restore():
        for name, fn in plain.items():
            setattr(tlk, name, fn)
    return calls, restore


def gate_choice(m, n, dev):
    """The direction kernel ``two_loop_cached(collapsed=True)`` takes for
    float32 pairs of this shape on this card, and the other one."""
    names = ("direction", "direction_streamed")
    return names if tlk.direction_fits(m, n, dev) else names[::-1]

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

# Phases 15-17: the JAX package on the CPU on the same data, each run in
# float32 and (phases 15 and 17) again in float64 with jax_enable_x64 and
# float64 data and x0, to see how far float32 rounding moves the loss
# (tools/jax_references.py [--f64] prints every number below).
# - FusedTrainer("SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=20))
#   with jax.jit(trainer.epoch, static_argnames=("aligned",)) at eta 1e-2:
#   two epochs of aligned=False on the first 110 batches (B % L = 10: the
#   window of the boundary after step 10 of each epoch but the first wraps
#   into the epoch's unconsumed batches) end at JAX_GENERIC_110_LOSS, all
#   220 codes 200, 10 live pairs; float64 461,146.92 (2.0e-6 away);
# - aligned=False on the first 10 batches, then one epoch of all 120
#   (starting 10 steps into a round): JAX_RESUME_LOSS, all 130 codes 200,
#   5 live pairs; float64 508,591.42 (1.7e-6 away);
# - jit_epochs_scheduled() for 3 epochs on (X, Y) flattened to 6,000
#   rows, orders = np.random.default_rng(2).permutation(6000) drawn once
#   per epoch in turn, step sizes step_size_sqrt(1e-2, epoch), batch_size
#   50, aligned=True: JAX_SCHEDULED_LOSS, all 360 codes 200, 10 live
#   pairs; float64 439,595.13 (2.7e-6 away).
# All three are held within LOSS_RTOL, as the aligned SQN run is.
JAX_GENERIC_110_LOSS = 461_146.0
JAX_RESUME_LOSS = 508_590.5625
JAX_SCHEDULED_LOSS = 439_593.9375
# bfloat16 storage, float32 runs as above, 2 epochs on all 120 batches:
# SQN pairs_bf16=True, block and interleaved (eta 1e-2, aligned=True);
# oLBFGS pairs_bf16=True, pairs_interleaved=True (eta 1e-2); adaQN
# ADAQN_KW with fisher_bf16=True and coupling "gram" (the kernel route's
# math; eta 0.1).  Every run keeps the codes of its float32 run (SQN and
# oLBFGS all 200, 10 live pairs; adaQN JAX_ADAQN_BOUNDARY_INFOS, one
# live pair, 20 Fisher rows).  Each run's own distance to its float32 run
# (JAX_LOSS_2_EPOCHS, JAX_OLBFGS_LOSS["interleaved"], JAX_ADAQN_LOSS
# ["kernel"]): SQN block 5.5e-6, interleaved 9.1e-6, oLBFGS 6.7e-2 (the
# rounded pairs steer every oLBFGS step), adaQN 1.2e-5.  The rule phase 7
# uses for adaQN float32 (its gate, 1e-2, is about twice the JAX
# package's own float32-to-float64 distance, 0.58%) sets each gate at
# twice that distance, but never tighter than the gate of the run's
# float32 path: LOSS_RTOL for SQN and oLBFGS, FINAL_RTOL for adaQN.
# For oLBFGS that gate (0.14) checks convergence only; the float32 run
# would pass it too.  In float32, bfloat16 oLBFGS forks on summation
# order (tools/bf16_olbfgs_fork.py, on the CPU): after the first commit
# 1,555 of the 5.8M stored entries round to another bfloat16 neighbour
# than the JAX package's, rho is then 1e-3 and gamma 5e-4 apart, and x
# after 20 steps is 3.2e-4 from the JAX run, as far as the JAX run with
# float32 pairs (3.4e-4).  The JAX package forks from itself the same
# way: the same 240 steps as one-batch epochs (another XLA program) end
# at 101,710.45, 13.1% from its 120-batch run
# (tools/jax_references.py).  So the semantics are held in float64
# (float64 data, x0 and math, the pairs still bfloat16), where both
# packages' sums agree to ~1e-16 and no stored row flips: the JAX run,
# 120-batch or one-batch epochs alike, ends at JAX_OLBFGS_BF16_F64_LOSS,
# all codes 200, 10 live pairs; the port on the CPU 1.7e-15 from it, the
# JAX run with float64 pairs 5.9e-3 away.  Held within F64_RTOL, as phase
# 15 holds adaQN in float64.
JAX_BF16_LOSS = {"sqn_block": 451_610.53125,
                 "sqn_interleaved": 451_608.96875,
                 "olbfgs_interleaved": 117_016.171875,
                 "adaqn_fisher": 117_687.609375}
BF16_RTOL = {"sqn_block": LOSS_RTOL, "sqn_interleaved": LOSS_RTOL,
             "olbfgs_interleaved": 0.14, "adaqn_fisher": FINAL_RTOL}
JAX_OLBFGS_BF16_F64_LOSS = 109_025.26315829599
# Phase 20, a bfloat16 iterate, on the same data: the JAX package on the
# CPU (tools/jax_references.py --bf16-iterate prints every number below):
# - FusedTrainer("SQN", SQNConfig.create(mem_size=10, bfgs_upd_freq=20))
#   from x0 in bfloat16, jax.jit(trainer.epoch) twice at eta 1e-2 (a
#   Python float), aligned=True: 605,439.1875 on bfloat16 data and on
#   float32 data alike (the losses cast the data to the parameters'
#   dtype inside each product), all 240 codes 200, 10 live pairs, x and
#   the pair rows bfloat16, the Gram float32.  The float32 run ends at
#   JAX_LOSS_2_EPOCHS: a bfloat16 x rounds most of a 1e-2 step away, so
#   the bfloat16 run is 34% above it;
# - SQN_free(mem_size=10, bfgs_upd_freq=20, dtype=jnp.bfloat16) for one
#   epoch in phase 11's request loop, every point handed to the jitted
#   losses in bfloat16: 620,068.375, 121 calc_grad and 5 calc_hess_vec
#   requests, every iteration_info no_problems_encountered, 5 live pairs
#   (float32: JAX_FREE_SQN_LOSS_1_EPOCH).
# The two packages round elementwise ops alike but sum products in their
# own orders, so the same bits are not expected.  The rule
# (tests/test_torch_bf16_iterate.py): the codes exact, and the loss within
# twice the JAX bfloat16 run's distance to the JAX float32 run.
JAX_BF16_ITERATE_LOSS = 605_439.1875
JAX_FREE_SQN_BF16_LOSS_1_EPOCH = 620_068.375
# Phase 21, the native C++ tier in float64 against the card's torch
# backend in lockstep: tests/test_native.py's tolerance.
NATIVE_RTOL, NATIVE_ATOL = 1e-8, 1e-10
# oLBFGS paired gradients against the sequential layout: the same steps,
# held in float64 to tests/test_fused.py:418's tolerances.
PAIRED_RTOL, PAIRED_ATOL = 1e-6, 1e-9
# Phase 18, the front ends, on the same draws flattened to 6,000 rows: the
# JAX package on the CPU (tools/jax_front_end_references.py [--f64] prints
# every number below, float32 and float64):
# - StochasticLogisticRegression(**FE_MODEL_KW) (the model's defaults
#   reg_param 1e-3 and step_size 0.1, w0 from np.random.seed(1)), the
#   model's objective on all rows (mean log-loss + 0.5e-3 ||coef||^2)
#   after 2 epochs: SQN (bfgs_upd_freq=20) 3.3075080 (float64 3.3075112,
#   9.7e-7 away), 10 live pairs; oLBFGS 3.2403793 (float64 3.2393468,
#   3.2e-4 away), both held within LOSS_RTOL of the float32 run;
# - adaQN with fisher_size=100, rmsprop_weight=0.9, step_size=0.1,
#   bfgs_upd_freq=20: float64 113.74461810931375 (held within F64_RTOL),
#   float32 with coupling "gram" (the kernel route's math) 113.74084
#   (3.3e-5 from float64); the port's float32 kernel route is held within
#   FINAL_RTOL of the float64 loss, as phase 7 holds adaQN;
# - the guided SQN(x0, grad, obj, hess_vec, batches_per_epoch=120,
#   step_size=1e-2, mem_size=10, bfgs_upd_freq=20, use_float=True),
#   default shuffle (numpy's, shared by both packages) and "auto" decay,
#   summed loss (reg 0.1) on all rows: the protocol engine, 1 epoch,
#   515,010.97 (float64 515,011.92, 1.8e-6 away), 5 live pairs; the fused
#   engine, 2 epochs in one scheduled dispatch, 469,410.44 (float64
#   469,411.41, 2.1e-6 away), 10 live pairs; both held within LOSS_RTOL.
FE_MODEL_KW = dict(engine="fused", valset_frac=None,
                   batches_per_epoch=NUM_BATCHES, nepochs=2,
                   shuffle_data=False, decr_step_size=None, mem_size=MEM_SIZE)
FE_MODEL_STEP = 1e-1
JAX_FE_LOSS = {"logistic_sqn": 3.3075079917907715,
               "logistic_olbfgs": 3.2403793334960938,
               "guided_protocol_sqn_1_epoch": 515_010.96875,
               "guided_fused_sqn_2_epochs": 469_410.4375}
JAX_FE_ADAQN_LOSS = 113.7408447265625
JAX_FE_ADAQN_F64_LOSS = 113.74461810931375
# (f): a CSR matrix of the same shape from default_rng(1), FE_DENSITY of
# its entries standard normal, held against the fit of its densified copy
# (index_add's atomics sum the sparse gradients in another order on every
# run) within FE_SPARSE_RTOL, in the loss and in x relative to max |x|.
# The port on the CPU: 2.0e-6 in x, the same loss to all printed digits.
FE_DENSITY = 0.01
FE_SPARSE_RTOL = 1e-4
# (g): at its default step 0.1 the MLP climbs on this unscaled data (the
# JAX package's MLPClassifier(hidden=(64,)), 2 epochs on the CPU: mean
# log-loss 6.05 -> 41.04), at 0.01 it falls (6.05 -> 3.37); the phase
# takes 0.01 and checks that the loss falls and stays finite.
FE_MLP_STEP = 1e-2


@contextlib.contextmanager
def host_reads():
    """Collects the host syncs made inside the block (sync debug mode
    'warn' warns at each); the list is filled when the block ends."""
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(0)
    seen.extend(str(w.message) for w in caught
                if "synchroniz" in str(w.message))


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


def time_kernel(what, kern, plain, library=None):
    """Device and host times of a kernel wrapper, its plain version and,
    where there is one, the library call(s) computing the same function:
    back to back (inputs warm in L2), in turns (plain, kernel, kernel,
    plain), then with L2 flushed before each call, then host wall."""
    dev = torch.device("cuda")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    p1, k1, k2, p2 = (device_ms(f, 50) for f in (plain, kern, kern, plain))
    t = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
             cold_ms=device_ms(kern, 30, flush),
             cold_plain_ms=device_ms(plain, 30, flush),
             host_ms=host_ms(kern, 200), plain_host_ms=host_ms(plain, 200),
             library_ms=None)
    print(f"  time {what}, device: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms (back to back, inputs warm in L2); L2 "
          f"flushed: kernel {t['cold_ms']:.4f} ms, plain "
          f"{t['cold_plain_ms']:.4f} ms", flush=True)
    print(f"  time {what}, host wall per call: kernel {t['host_ms']:.4f} ms, "
          f"plain {t['plain_host_ms']:.4f} ms", flush=True)
    if library is not None:
        t["library_ms"] = device_ms(library, 50)
        t["cold_library_ms"] = device_ms(library, 30, flush)
        print(f"  time {what}, library call(s): {t['library_ms']:.4f} ms "
              f"warm, {t['cold_library_ms']:.4f} ms with L2 flushed",
              flush=True)
    return t


def bound(nbytes, flops):
    """``bound_ms`` and ``bound_by``: the least time the card could take,
    the larger of the bytes (each input read once, each output written
    once) over the memory rate and the float32 operations over the
    float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def direction_bound(m, n, storage_bytes=4, grad_bytes=4):
    """d = gamma g + W^T (C (W g)): W, g, C and gamma read, d written."""
    nbytes = (2 * m * n * storage_bytes + grad_bytes * n
              + 4 * (4 * m * m + 1) + 4 * n)
    return bound(nbytes, 8 * m * n + 2 * n + 8 * m * m)


def project_bound(m, n):
    """W g and W W^T: S, Y and g read, 2m + 4m^2 sums written; the
    products of W g and of the Gram's upper triangle (it is symmetric)."""
    nbytes = 4 * ((2 * m + 1) * n + 2 * m + 4 * m * m)
    return bound(nbytes, 2 * n * (2 * m + m * (2 * m + 1)))


def project_adaqn_bound(m, n):
    """W g, (Y o D) g, (Y o D) Y^T: S, Y, d and g read, 3m + m^2 sums
    written; the products, and Y o D formed once."""
    nbytes = 4 * ((2 * m + 2) * n + 3 * m + m * m)
    return bound(nbytes, n * (4 * m + m + 2 * m + 2 * m * m))


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
                name = str(storage)[6:]
                timing[name] = time_kernel(
                    f"n={n} {name}",
                    lambda: tlk.direction_streamed(*args),
                    lambda: tlk.direction_streamed_ref(*args),
                    streamed_library(mem, args))
    worst20, timing["m20"] = streamed_m20(dev, gen)
    worst_cells, timing["cells"] = streamed_cells(dev, gen)
    return max(worst, worst20, worst_cells, streamed_shapes(dev, gen)), timing


def streamed_library(mem, args):
    """The library sequence of :func:`direction_library` for float32 pairs,
    where the streamed kernel computes ``direction``'s function; None for
    bfloat16 pairs: no one call reads them against a float32 ``g`` without
    an upcast of the pairs, which the kernel does not do."""
    if mem.s.dtype != torch.float32:
        return None
    return direction_library(torch.cat([mem.s, mem.y]), *args[2:])


def random_direction_args(m, n, storage, dev, gen):
    """Pairs, gradient, ``c`` (scaled by 1 / n, as in the tests, so that one
    tolerance serves every n) and gamma, made on the card."""
    s = torch.randn(m, n, device=dev, generator=gen)
    y = s + 0.3 * torch.randn(m, n, device=dev, generator=gen)
    return (s.to(storage), y.to(storage),
            torch.randn(n, device=dev, generator=gen),
            torch.randn(2 * m, 2 * m, device=dev, generator=gen) / n,
            torch.full((), 0.7, device=dev))


def streamed_shapes(dev, gen):
    """The streamed kernel against its plain version, and the same bits
    twice, over what it treats apart: n with every remainder mod 4 (and mod
    8: a 16-byte vector holds 8 bfloat16 values) at m = 1, 10, 20 and 32,
    since every row of the pairs has its own 16-byte phase; and n that this
    card's shared memory parks wholly, in part and hardly at all."""
    worst = 0.0
    shapes = [(m, n, None) for m in (1, 10, M20, 32) for n in range(2001, 2009)]
    shapes += [(MEM_SIZE, N_FLAGSHIP, "wholly"), (M20, N_FLAGSHIP, "partly"),
               (32, N_FLAGSHIP, "partly"), (32, 4_000_000, "hardly")]
    for m, n, parks in shapes:
        for storage in (torch.float32, torch.bfloat16):
            name = str(storage)[6:]
            args = random_direction_args(m, n, storage, dev, gen)
            got = tlk.direction_streamed(*args)
            again = tlk.direction_streamed(*args)
            want = tlk.direction_streamed_ref(*args)
            torch.cuda.synchronize()
            max_abs = float((got - want).abs().max())
            worst = max(worst, max_abs)
            ok = bool(torch.equal(got, again)) and bool(torch.allclose(
                got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL))
            what = (f"m={m} n={n} {name}: the same bits twice, max_abs_err="
                    f"{max_abs:.3e} within rtol={KERNEL_RTOL} "
                    f"atol={KERNEL_ATOL}")
            if parks is None:
                if not ok:
                    check(False, what)
                continue
            parked = tlk.direction_streamed_parked(m, n, storage, dev)
            check(ok, f"{what}; {parked} of {n} columns park "
                  f"({100 * parked / n:.1f}%)")
            if storage == torch.float32 or parks == "hardly":
                share = {"wholly": parked == n,
                         "partly": 0.25 * n < parked < n,
                         "hardly": 0 < parked < 0.1 * n}[parks]
                check(share, f"m={m} n={n} {name} parks {parks}")
    check(True, "direction_streamed agrees with its plain version and gives "
          "the same bits twice at m in {1, 10, 20, 32}, n = 2001 ... 2008, "
          "both storages")
    return worst


def split_line(m, n, storage, dev):
    """The plan's split of W's columns at this shape, as a line."""
    split = tlk.direction_streamed_split(m, n, storage, dev)
    check(sum(split.values()) == n, f"m={m} n={n} {str(storage)[6:]}: the "
          f"split adds up to n: {split}")
    return ", ".join(f"{k} {v} ({100 * v / n:.1f}%)"
                     for k, v in split.items())


def direction_by_blocks(s, y, g, c, gamma, block=1 << 25):
    """:func:`tlk.direction_streamed_ref`'s math over blocks of columns, for
    pairs whose float32 copy the card cannot hold."""
    m, n = s.shape
    wg = torch.zeros(2 * m, device=g.device)
    for j in range(0, n, block):
        w = torch.cat([s[:, j:j + block], y[:, j:j + block]]).float()
        wg += w @ g[j:j + block]
    u = c @ wg
    d = torch.empty_like(g)
    for j in range(0, n, block):
        w = torch.cat([s[:, j:j + block], y[:, j:j + block]]).float()
        d[j:j + block] = gamma * g[j:j + block] + u @ w
    return d


def streamed_cells(dev, gen):
    """The streamed kernel at the pairs of the benchmark cells that run it,
    m = 10: Criteo's (float32, n = 1,000,000) against its plain version
    and the same bits twice, timed beside the plain version, the library
    sequence and its bound; DeepSeek-V2-Lite's (bfloat16, n = 535,060,992)
    against the plain math over blocks of columns and the same bits twice,
    timed beside its bound.  Each with the plan's split of W's columns:
    parked in shared memory, read again from L2, read again from device
    memory."""
    worst, out = 0.0, {}
    args = random_direction_args(MEM_SIZE, N_CRITEO, torch.float32, dev, gen)
    got = tlk.direction_streamed(*args)
    again = tlk.direction_streamed(*args)
    want = tlk.direction_streamed_ref(*args)
    torch.cuda.synchronize()
    worst = float((got - want).abs().max())
    check(bool(torch.equal(got, again)) and bool(torch.allclose(
        got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)),
          f"m={MEM_SIZE} n={N_CRITEO} float32: the same bits twice, "
          f"max_abs_err={worst:.3e} within rtol={KERNEL_RTOL} "
          f"atol={KERNEL_ATOL}")
    print(f"  split at m={MEM_SIZE} n={N_CRITEO} float32: "
          f"{split_line(MEM_SIZE, N_CRITEO, torch.float32, dev)}", flush=True)
    t = time_kernel(f"m={MEM_SIZE} n={N_CRITEO} float32",
                    lambda: tlk.direction_streamed(*args),
                    lambda: tlk.direction_streamed_ref(*args),
                    direction_library(torch.cat(args[:2]), *args[2:]))
    t.update(direction_bound(MEM_SIZE, N_CRITEO))
    print(f"  bound at m={MEM_SIZE} n={N_CRITEO} float32: "
          f"{t['bound_ms']:.5f} ms by {t['bound_by']}; kernel at "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of it warm, "
          f"{100 * t['bound_ms'] / t['cold_ms']:.1f}% with L2 flushed",
          flush=True)
    out["criteo"] = t
    del args, got, again, want

    s = torch.randn(MEM_SIZE, N_DSV2LITE, device=dev, generator=gen,
                    dtype=torch.bfloat16)
    y = s + 0.3 * torch.randn(MEM_SIZE, N_DSV2LITE, device=dev,
                              generator=gen, dtype=torch.bfloat16)
    args = (s, y, torch.randn(N_DSV2LITE, device=dev, generator=gen),
            torch.randn(2 * MEM_SIZE, 2 * MEM_SIZE, device=dev,
                        generator=gen) / N_DSV2LITE,
            torch.full((), 0.7, device=dev))
    got = tlk.direction_streamed(*args)
    same = bool(torch.equal(got, tlk.direction_streamed(*args)))
    want = direction_by_blocks(*args)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    worst = max(worst, max_abs)
    check(same and bool(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)),
          f"m={MEM_SIZE} n={N_DSV2LITE} bfloat16: the same bits twice, "
          f"max_abs_err={max_abs:.3e} within rtol={KERNEL_RTOL} "
          f"atol={KERNEL_ATOL}")
    del got, want
    print(f"  split at m={MEM_SIZE} n={N_DSV2LITE} bfloat16: "
          f"{split_line(MEM_SIZE, N_DSV2LITE, torch.bfloat16, dev)}",
          flush=True)
    t = {"ms": device_ms(lambda: tlk.direction_streamed(*args), 5),
         **direction_bound(MEM_SIZE, N_DSV2LITE, 2)}
    print(f"  time m={MEM_SIZE} n={N_DSV2LITE} bfloat16: kernel "
          f"{t['ms']:.3f} ms; bound {t['bound_ms']:.3f} ms by "
          f"{t['bound_by']}: the kernel at "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of it", flush=True)
    out["dsv2lite"] = t
    return worst, out


def streamed_m20(dev, gen):
    """The streamed kernel at the shape its driven path gives it (free-mode
    SQN with ``mem_size=20``, phase 11): n = 292,083, m = 20, which no H100
    parks whole.  Kernel against plain version, then both timed, per
    storage, beside the bound at this shape."""
    worst, out = 0.0, {}
    for storage in (torch.float32, torch.bfloat16):
        name = str(storage)[6:]
        mem = committed_memory(N_FLAGSHIP, storage, dev, gen,
                               commits=M20 + 2, m=M20)
        g = torch.randn(N_FLAGSHIP, device=dev, generator=gen)
        args = (mem.s, mem.y, g, mem.c0 + mem.gamma * mem.cg, mem.gamma)
        got = tlk.direction_streamed(*args)
        again = tlk.direction_streamed(*args)
        want = tlk.direction_streamed_ref(*args)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        worst = max(worst, max_abs)
        check(bool(torch.equal(got, again)),
              f"m={M20} n={N_FLAGSHIP} {name}: the same bits twice")
        check(bool(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL)),
              f"m={M20} n={N_FLAGSHIP} {name}: max_abs_err={max_abs:.3e} "
              f"within rtol={KERNEL_RTOL} atol={KERNEL_ATOL}")
        t = time_kernel(f"m={M20} n={N_FLAGSHIP} {name}",
                        lambda: tlk.direction_streamed(*args),
                        lambda: tlk.direction_streamed_ref(*args),
                        streamed_library(mem, args))
        t.update(direction_bound(M20, N_FLAGSHIP, mem.s.element_size()))
        print(f"  bound at m={M20} n={N_FLAGSHIP} {name}: "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']}; kernel at "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of it warm, "
              f"{100 * t['bound_ms'] / t['cold_ms']:.1f}% with L2 flushed",
              flush=True)
        out[name] = t
    return worst, out


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
    # x0 as a user has it, a numpy array and no device named: on the card
    state = trainer.init(x0.cpu().numpy())
    check(state.x.device.type == "cuda" and state.mem.s.device.type == "cuda"
          and bool(torch.equal(state.x, x0)),
          "FusedTrainer.init(numpy x0) with no device puts the state on the "
          "card")
    loss0 = full_loss(state.x)
    check(abs(loss0 - JAX_LOSS_X0) <= 1e-5 * JAX_LOSS_X0,
          f"loss at x0 {loss0:.4f} is the JAX package's {JAX_LOSS_X0} "
          "(same data)")
    data = (X, Y)
    steps = 2 * NUM_BATCHES

    chosen, other = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    print(f"  the gate takes {chosen} for m={MEM_SIZE}, n={N_FLAGSHIP} on "
          f"this card (direction's cap: n <= "
          f"{tlk.direction_max_n(MEM_SIZE, dev)})", flush=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")     # a host sync inside raises
    state, infos = trainer.epochs(state, data, STEP, nepochs=2, aligned=True)
    torch.cuda.set_sync_debug_mode(0)
    counts = read_launches()
    check(True, "no host sync inside epochs (sync debug mode 'error')")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts.pop(chosen)
    print(f"  2 epochs ({steps} steps) in {first_s:.3f} s, first call "
          "included", flush=True)
    check(not any(counts.values()),
          f"no other kernel is on this SQN path: {counts}")

    infos_l = infos.cpu().flatten().tolist()
    loss2 = float(full_loss(state.x))
    count = int(state.mem.count)
    check(launches == steps,
          f"{chosen} kernel launched {launches} times for {steps} steps")
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
    x_2_epochs = state.x.clone()       # phase 19 (a) runs this on a mesh

    # Steady epochs of the gate's route and of the streamed kernel forced
    # (the gate's cap check answered "no"), in turns, so that both see the
    # same card and host.  One state: the routes compute the same function.
    rates = {chosen: [], other: []}
    gate_fits = two_loop_mod.direction_fits
    order = (chosen, other, other, chosen, chosen, other)
    for route in (order if chosen == "direction" else (chosen,) * 3):
        two_loop_mod.direction_fits = (
            gate_fits if route == "direction" else lambda m, n, d: False)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.epochs(state, data, STEP, nepochs=1, aligned=True)
        torch.cuda.synchronize()
        rates[route].append(NUM_BATCHES / (time.perf_counter() - t0))
        two_loop_mod.direction_fits = gate_fits
        check(read_launches()[route] == NUM_BATCHES,
              f"steady epoch on {route}: one launch per step")
    for route, vals in rates.items():
        if vals:
            print(f"  steady epochs on {route} (in turns): "
                  f"{', '.join(f'{v:.1f}' for v in vals)} iters/s; median "
                  f"{statistics.median(vals):.1f} iters/s", flush=True)
    ips = statistics.median(rates[chosen])
    streamed_ips = (statistics.median(rates["direction_streamed"])
                    if rates["direction_streamed"] else None)
    check(bool(torch.isfinite(state.x).all()), "x finite after the steady "
          "epochs")

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
    return {chosen: launches}, ips, streamed_ips, x_2_epochs


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
        reset_launches()
        st, infos = trainer.epochs(st, data, 0.05, nepochs=2, aligned=True)
        out.append((st.x.cpu().numpy(), infos.cpu().numpy(),
                    tlk.LAUNCHES + tlk.DIRECTION_LAUNCHES))
    (x_cpu, i_cpu, n_cpu), (x_dev, i_dev, n_dev) = out
    check(n_cpu == 0 and n_dev == 2 * nb,
          f"direction kernel launches: CPU {n_cpu}, card {n_dev}")
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
    return max(worst, projection_shapes(dev, gen)), worst_share, timing


def projection_shapes(dev, gen):
    """The projection kernel against its plain version, and the same bits
    twice, at n with every remainder mod 4 (every row of the pairs then has
    its own 16-byte phase) and m = 1, 10, 23 and 32 (one and two units per
    warp, one and several unit groups), with a positive and a signed
    diagonal."""
    worst = 0.0
    for m in (1, MEM_SIZE, 23, 32):
        for n in range(2001, 2005):
            s = torch.randn(m, n, device=dev, generator=gen)
            y = s + 0.3 * torch.randn(m, n, device=dev, generator=gen)
            g = torch.randn(n, device=dev, generator=gen)
            for signed in (False, True):
                diag = (torch.randn(n, device=dev, generator=gen) if signed
                        else 0.1 + 1.9 * torch.rand(n, device=dev,
                                                    generator=gen))
                got = tlk.project_adaqn(s, y, diag, g)
                again = tlk.project_adaqn(s, y, diag, g)
                want = tlk.project_adaqn_ref(s, y, diag, g)
                torch.cuda.synchronize()
                max_abs = max(float((a - b).abs().max())
                              for a, b in zip(got, want))
                worst = max(worst, max_abs)
                ok = (all(torch.equal(a, b) for a, b in zip(got, again))
                      and bool(torch.equal(got[2], got[2].T))
                      and all(torch.allclose(a, b, rtol=ADAQN_RTOL,
                                             atol=ADAQN_ATOL)
                              for a, b in zip(got, want)))
                if not ok:
                    check(False, f"m={m} n={n} "
                          f"{'signed' if signed else 'positive'}: the same "
                          f"bits twice, ydy symmetric, max_abs_err="
                          f"{max_abs:.3e} within rtol={ADAQN_RTOL} "
                          f"atol={ADAQN_ATOL}")
    check(True, "project_adaqn agrees with its plain version and gives the "
          "same bits twice at m in {1, 10, 23, 32}, n = 2001 ... 2004, "
          f"positive and signed d (worst max_abs_err={worst:.3e})")
    return worst


def time_projection(dev, args):
    return time_kernel(f"n={N_FLAGSHIP} m={MEM_SIZE}",
                       lambda: tlk.project_adaqn(*args),
                       lambda: tlk.project_adaqn_ref(*args))


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


def adaqn_two_epochs(name, x0, data, use_pallas, aligned=True, **cfg_kw):
    """A trainer of the smoke's adaQN config (with ``cfg_kw``), and 2
    epochs of it from ``x0`` through ``epochs(aligned=aligned)``: with
    ``aligned=True`` under sync debug mode 'error', else counting the
    host reads (one: ``niter``, before the first epoch).  Returns the
    trainer, the state, the info codes (all, and at the boundaries), the
    guard's f at each boundary and the launch counts (the projection
    kernel's, all the others')."""
    fvals = []

    def recording_obj_fn(x, batch):
        f = obj_fn(x, batch)
        fvals.append(f)         # a device tensor: no sync
        return f
    trainer = FusedTrainer("adaQN", AdaQNConfig.create(
        **ADAQN_KW, use_pallas=use_pallas, **cfg_kw), grad_fn,
        obj_fn=recording_obj_fn)
    state = trainer.init(x0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    if aligned:
        torch.cuda.set_sync_debug_mode("error")     # a host sync raises
        state, infos = trainer.epochs(state, data, ADAQN_STEP, nepochs=2,
                                      aligned=True)
        torch.cuda.set_sync_debug_mode(0)
        check(True, f"{name}: no host sync inside epochs (sync debug mode "
              "'error')")
    else:
        with host_reads() as reads:
            state, infos = trainer.epochs(state, data, ADAQN_STEP, nepochs=2,
                                          aligned=aligned)
        check(len(reads) == 1, f"{name}: {len(reads)} host read in 2 epochs "
              f"with aligned={aligned} (niter, once; sync debug mode 'warn')")
    counts = read_launches()
    launches = (counts.pop("project_adaqn"), sum(counts.values()))
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
              f"{steps} steps, the other kernels {other} times")
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


# ---------------------------------------------------------------------------
def project_library(w, g):
    """The library pair that computes ``project``'s outputs from a ready
    ``W = [S; Y]``."""
    return lambda: (w @ g, w @ w.T)


def direction_library(w, g, c, gamma):
    """The library sequence that computes ``direction``'s output from a
    ready ``W = [S; Y]``: three cuBLAS calls, since no one call computes
    the function (a yardstick, as ``project``'s library pair is)."""
    return lambda: torch.addmv(gamma * g, w.T, c @ (w @ g))


def project_kernel_phase(dev):
    phase("9. project kernel vs plain version on the card")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = worst_share = 0.0
    timing = None
    for n in (700, 1000, 1500, 2048, N_FLAGSHIP):
        for m in (5, MEM_SIZE) + ((M20,) if n == N_FLAGSHIP else ()):
            mem = committed_memory(n, torch.float32, dev, gen,
                                   commits=m + 2, m=m)
            g = torch.randn(n, device=dev, generator=gen)
            args = (mem.s, mem.y, g)
            got = tlk.project(*args)
            want = tlk.project_ref(*args)
            torch.cuda.synchronize()
            what = f"n={n} m={m}"
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
            worst = max(worst, max_abs)
            check(bool(torch.equal(got[1], got[1].T)),
                  f"{what}: gram symmetric")
            if n != N_FLAGSHIP:
                close = all(torch.allclose(a, b, rtol=ADAQN_RTOL,
                                           atol=ADAQN_ATOL)
                            for a, b in zip(got, want))
                check(close, f"{what}: kernel vs plain max_abs_err="
                      f"{max_abs:.3e} within rtol={ADAQN_RTOL} "
                      f"atol={ADAQN_ATOL}")
                continue
            w = torch.cat([mem.s, mem.y]).double()
            g64 = g.double()
            vals = (w @ g64, w @ w.T)
            mags = (w.abs() @ g64.abs(), w.abs() @ w.abs().T)
            for who, res in (("kernel", got), ("plain", want)):
                ratio = max(float(((r.double() - v).abs()
                                   / (ADAQN_BOUND_REL * mag)).max())
                            for r, v, mag in zip(res, vals, mags))
                if who == "kernel":
                    worst_share = max(worst_share, ratio)
                check(ratio <= 1.0,
                      f"{what}: {who} vs float64 within {ADAQN_BOUND_REL} x "
                      f"sum|terms| (worst entry at {ratio:.3f} of it); "
                      f"kernel vs plain max_abs_err={max_abs:.3e}")
            if m == MEM_SIZE:
                timing = time_kernel(
                    f"n={n} m={m}", lambda: tlk.project(*args),
                    lambda: tlk.project_ref(*args),
                    project_library(torch.cat([mem.s, mem.y]), g))
    worst = max(worst, project_shapes(dev, gen))
    for m in (M20, 32):
        timing[f"m{m}"] = project_large_m(dev, gen, m)
    return worst, worst_share, timing


def project_shapes(dev, gen):
    """The ``project`` kernel against its plain version, the same bits twice
    and a symmetric Gram, at n with every remainder mod 8 (every row of the
    pairs then has its own 16-byte phase) and m = 1, 10, 14, 20, 23 and 32
    (g as a row of the last row block and as a unit of its own, with and
    without staging warps, one and several unit groups)."""
    worst = 0.0
    for m in (1, MEM_SIZE, 14, M20, 23, 32):
        for n in range(2001, 2009):
            s = torch.randn(m, n, device=dev, generator=gen)
            y = s + 0.3 * torch.randn(m, n, device=dev, generator=gen)
            g = torch.randn(n, device=dev, generator=gen)
            got = tlk.project(s, y, g)
            again = tlk.project(s, y, g)
            want = tlk.project_ref(s, y, g)
            torch.cuda.synchronize()
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
            worst = max(worst, max_abs)
            ok = (all(torch.equal(a, b) for a, b in zip(got, again))
                  and bool(torch.equal(got[1], got[1].T))
                  and all(torch.allclose(a, b, rtol=ADAQN_RTOL,
                                         atol=ADAQN_ATOL)
                          for a, b in zip(got, want)))
            if not ok:
                check(False, f"m={m} n={n}: the same bits twice, gram "
                      f"symmetric, max_abs_err={max_abs:.3e} within rtol="
                      f"{ADAQN_RTOL} atol={ADAQN_ATOL}")
    check(True, "project agrees with its plain version, gives the same bits "
          "twice and a symmetric Gram at m in {1, 10, 14, 20, 23, 32}, "
          f"n = 2001 ... 2008 (worst max_abs_err={worst:.3e})")
    return worst


def project_large_m(dev, gen, m):
    """``project`` timed at n = 292,083 and a large m (m = 20 is the shape
    the ``mem_size=20`` audits of phase 11 give it), beside the plain
    version, the library pair and the bound at this shape."""
    s = torch.randn(m, N_FLAGSHIP, device=dev, generator=gen)
    y = s + 0.3 * torch.randn(m, N_FLAGSHIP, device=dev, generator=gen)
    g = torch.randn(N_FLAGSHIP, device=dev, generator=gen)
    t = time_kernel(f"n={N_FLAGSHIP} m={m}", lambda: tlk.project(s, y, g),
                    lambda: tlk.project_ref(s, y, g),
                    project_library(torch.cat([s, y]), g))
    t.update(project_bound(m, N_FLAGSHIP))
    print(f"  bound at m={m} n={N_FLAGSHIP}: {t['bound_ms']:.5f} ms by "
          f"{t['bound_by']}; kernel at {100 * t['bound_ms'] / t['ms']:.1f}% "
          f"of it warm, {100 * t['bound_ms'] / t['cold_ms']:.1f}% with L2 "
          "flushed", flush=True)
    return t


def direction_kernel_phase(dev):
    phase("10. one-read direction kernel vs plain version and vs the "
          "streamed kernel on the card")
    gen = torch.Generator(device=dev).manual_seed(3)
    max_n = tlk.direction_max_n(MEM_SIZE, dev)
    print(f"  this card parks n <= {max_n} at m={MEM_SIZE} "
          f"({tlk.direction_max_n(20, dev)} at m=20)", flush=True)
    check(max_n > 0, "the card can launch the one-read kernel")
    worst = 0.0
    timing = None
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for n in sorted({900, 1500, N_FLAGSHIP, max_n}):
        if n > max_n:
            print(f"  n={n} is over this card's cap: left to the streamed "
                  "kernel", flush=True)
            continue
        mem = committed_memory(n, torch.float32, dev, gen)
        g = torch.randn(n, device=dev, generator=gen)
        args = (mem.s, mem.y, g, mem.c0 + mem.gamma * mem.cg, mem.gamma)
        got = tlk.direction(*args)
        again = tlk.direction(*args)
        want = tlk.direction_ref(*args)
        streamed = tlk.direction_streamed(*args)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        worst = max(worst, max_abs)
        check(bool(torch.equal(got, again)), f"n={n}: the same bits twice")
        check(bool(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL)),
              f"n={n}: kernel vs plain max_abs_err={max_abs:.3e} within "
              f"rtol={KERNEL_RTOL} atol={KERNEL_ATOL}")
        check(bool(torch.allclose(got, streamed, rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL)),
              f"n={n}: vs the streamed kernel max_abs_err="
              f"{float((got - streamed).abs().max()):.3e}")
        if n == N_FLAGSHIP:
            timing = time_kernel(
                f"n={n} m={MEM_SIZE}", lambda: tlk.direction(*args),
                lambda: tlk.direction_ref(*args),
                direction_library(torch.cat([mem.s, mem.y]), *args[2:]))
            timing["library_calls"] = (
                "W @ g; C @ wg; torch.addmv(gamma * g, W.T, u), W formed "
                "beforehand: three cuBLAS calls, no one call computes the "
                "function")
            timing["cap_n"] = {f"m{m}": tlk.direction_max_n(m, dev)
                               for m in (1, MEM_SIZE, M20, 32)}
            # both direction kernels in turns, warm and with L2 flushed
            turns = {"direction": [], "direction_streamed": []}
            cold = {"direction": [], "direction_streamed": []}
            for name in ("direction_streamed", "direction", "direction",
                         "direction_streamed"):
                fn = getattr(tlk, name)
                turns[name].append(device_ms(lambda: fn(*args), 50))
                cold[name].append(device_ms(lambda: fn(*args), 30, flush))
            for name in turns:
                print(f"  in turns, {name}: warm "
                      f"{'/'.join(f'{v:.4f}' for v in turns[name])} ms, L2 "
                      f"flushed {'/'.join(f'{v:.4f}' for v in cold[name])} "
                      "ms", flush=True)
            timing["streamed_ms"] = statistics.mean(
                turns["direction_streamed"])
            timing["streamed_cold_ms"] = statistics.mean(
                cold["direction_streamed"])
    # n = 2,001 ... 2,008: the rows, g and each block's first column take
    # every phase against the 16-byte boundary of the bulk copies
    for m in (1, MEM_SIZE, 32):
        for n in range(2001, 2009):
            args = random_direction_args(m, n, torch.float32, dev, gen)
            got = tlk.direction(*args)
            again = tlk.direction(*args)
            want = tlk.direction_ref(*args)
            streamed = tlk.direction_streamed(*args)
            torch.cuda.synchronize()
            max_abs = float((got - want).abs().max())
            worst = max(worst, max_abs)
            if not (torch.equal(got, again)
                    and torch.allclose(got, want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
                    and torch.allclose(got, streamed, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)):
                check(False, f"m={m} n={n}: the same bits twice, "
                      f"max_abs_err={max_abs:.3e} vs plain, "
                      f"{float((got - streamed).abs().max()):.3e} vs the "
                      f"streamed kernel, within rtol={KERNEL_RTOL} "
                      f"atol={KERNEL_ATOL}")
    check(True, "direction agrees with its plain version and the streamed "
          "kernel and gives the same bits twice at m in {1, 10, 32}, "
          "n = 2001 ... 2008")
    # Both kernels by n: what grows with the bytes, and what is there at
    # any size (the launches, the grid barrier, the chain of latencies).
    sweep = {}
    for n in (900, 29_208, 146_041, N_FLAGSHIP):
        if n > max_n:
            continue
        args = (torch.randn(MEM_SIZE, n, device=dev, generator=gen),
                torch.randn(MEM_SIZE, n, device=dev, generator=gen),
                torch.randn(n, device=dev, generator=gen),
                torch.randn(2 * MEM_SIZE, 2 * MEM_SIZE, device=dev,
                            generator=gen) / n,
                torch.ones((), device=dev))
        sweep[n] = {name: (device_ms(lambda: fn(*args), 50),
                           device_ms(lambda: fn(*args), 30, flush))
                    for name, fn in (("direction", tlk.direction),
                                     ("direction_streamed",
                                      tlk.direction_streamed))}
        print(f"  by n, n={n}: " + "; ".join(
            f"{name} {1e3 * warm:.2f} us warm, {1e3 * cold:.2f} us L2 "
            f"flushed" for name, (warm, cold) in sweep[n].items()),
            flush=True)
    if timing is not None:
        timing["us_by_n"] = {
            str(n): {name: [round(1e3 * v, 3) for v in pair]
                     for name, pair in row.items()}
            for n, row in sweep.items()}
        # the floor: what a launch costs at any size, warm and L2 flushed
        timing["floor_us"] = timing["us_by_n"]["900"]["direction"]
    n = max_n + 1
    over = (torch.zeros(MEM_SIZE, n, device=dev),
            torch.zeros(MEM_SIZE, n, device=dev), torch.zeros(n, device=dev),
            torch.zeros(2 * MEM_SIZE, 2 * MEM_SIZE, device=dev),
            torch.ones((), device=dev))
    before = tlk.DIRECTION_LAUNCHES
    try:
        tlk.direction(*over)
    except ValueError as e:
        check(tlk.DIRECTION_LAUNCHES == before,
              f"n={n}, the first over the cap, raises before any launch: "
              f"{e}")
    else:
        check(False, f"n={n} is over the cap and must raise")
    return worst, timing


# ---------------------------------------------------------------------------
def device_busy_ms(fn):
    """Milliseconds the device spends in kernels and copies during
    ``fn()``, from a profiler trace; None if the trace shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages())
    return total_us / 1e3 if total_us > 0 else None


def hess_vec_fn(x, v, batch):
    return losses.multinomial_logistic_hessvec(x, v, batch[0], batch[1],
                                               None, REG)


class FreeLoop:
    """A request loop on the smoke's batches: minibatch b answers the b-th
    ``calc_grad`` and the ``calc_grad_same_batch`` after it, the round's
    merged minibatches every boundary request.
    Points come back from the optimizer as numpy arrays and go to the card;
    gradients, Hessian-vector products and function values are computed
    there and handed over as device tensors."""

    def __init__(self, opt, X, Y, x0, step, audit=None, resume=None,
                 point_dtype=None):
        """``resume``: ``(req, b)``, a pending request and the minibatch
        count of a loop that was stopped, to continue it on ``opt`` (whose
        state is that loop's) from ``x0``, with no priming call.
        ``point_dtype``: the dtype the points go to the card in (the
        data's by default; a bfloat16 optimizer's points in bfloat16, as
        the JAX package hands its bfloat16 arrays to the losses)."""
        self.opt, self.X, self.Y, self.step = opt, X, Y, step
        self.point_dtype = X.dtype if point_dtype is None else point_dtype
        self.x = np.array(x0.cpu().numpy() if isinstance(x0, torch.Tensor)
                          else x0, copy=True)
        self.audit = audit
        self.tasks, self.infos, self.fvals, self.audits = [], [], [], []
        self.call_ms = {}
        self.b = -1
        if resume is None:
            self.req = self._run()
        else:
            self.req, self.b = resume

    def _run(self):
        t0 = time.perf_counter()
        req = self.opt.run_optimizer(self.x, self.step)
        ms = (time.perf_counter() - t0) * 1e3
        self.tasks.append(req["task"])
        self.infos.append(req["info"]["iteration_info"])
        if len(self.tasks) > 1:     # the time of the call that did the work
            self.call_ms.setdefault(self.tasks[-2], []).append(ms)
        return req

    def _at(self, a):
        return torch.from_numpy(a).to(self.X.device, self.point_dtype)

    def answer(self):
        """Answer the pending request and run the optimizer to its next."""
        task, at = self.req["task"], self.req["requested_on"]
        if task == "calc_grad":
            self.b += 1
            b = self.b % NUM_BATCHES
            g = grad_fn(self._at(at), (self.X[b], self.Y[b]))
            if self.audit is not None:
                self.audit(self, g)
            self.opt.update_gradient(g)
        elif task == "calc_grad_same_batch":
            b = self.b % NUM_BATCHES
            self.opt.update_gradient(grad_fn(self._at(at),
                                             (self.X[b], self.Y[b])))
        else:
            r = (self.b % NUM_BATCHES) // UPD_FREQ
            rows = slice(r * UPD_FREQ, (r + 1) * UPD_FREQ)
            big = _flat((self.X[rows], self.Y[rows]))
            if task == "calc_hess_vec":
                self.opt.update_hess_vec(hess_vec_fn(
                    self._at(at[0]), self._at(at[1]), big))
            elif task == "calc_fun_val_batch":
                f = obj_fn(self._at(at), big)
                self.fvals.append(f)
                self.opt.update_function(f)
            else:
                raise SystemExit(f"chip_smoke: FAILED: unexpected task {task}")
        self.req = self._run()

    def run(self, steps):
        """Answer requests until ``steps`` iterations are done and the
        boundary work after the last one too."""
        while not (self.req["task"] == "calc_grad"
                   and self.opt.niter >= steps):
            self.answer()


def expected_sqn_tasks(steps):
    """calc_grad before every step; calc_hess_vec after every boundary but
    the first; the calc_grad request that ends the run."""
    tasks = []
    for i in range(1, steps + 1):
        tasks.append("calc_grad")
        if i % UPD_FREQ == 0 and i > UPD_FREQ:
            tasks.append("calc_hess_vec")
    return tasks + ["calc_grad"]


def free_sqn_phase(dev):
    phase("11. free-mode SQN at BibTeX shape: SQN_free request loop, 1 epoch")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(
            torch.as_tensor(x, device=dev), Xf, Yf, None, REG))

    plain_calls, restore_plain = spy_plain()

    def audit(loop, g):
        """After an accepted commit: the uncached oracle through the
        project kernel against the cached direction the next step takes
        (the same call on the same inputs)."""
        if not (loop.tasks[-2:] == ["calc_hess_vec", "calc_grad"]
                and loop.infos[-1] == "no_problems_encountered"):
            return
        mem = loop.opt.state.mem
        keep = tlk.DIRECTION_LAUNCHES, tlk.LAUNCHES
        used = two_loop_cached(g, mem, collapsed=True)
        tlk.DIRECTION_LAUNCHES, tlk.LAUNCHES = keep
        oracle = two_loop(g, mem.s, mem.y, mem.head, mem.count,
                          use_pallas=True)
        scale = float(used.abs().max())
        err = float((oracle - used).abs().max())
        loop.audits.append(err / scale)
        check(bool(torch.allclose(oracle, used, rtol=KERNEL_RTOL,
                                  atol=KERNEL_RTOL * scale)),
              f"after commit {len(loop.audits)} ({int(mem.count)} pairs of "
              f"{mem.s.shape[0]}): "
              f"two_loop(use_pallas=True) vs the cached direction "
              f"max_abs_err={err:.3e} (max |d| {scale:.3e}) within rtol="
              f"{KERNEL_RTOL} of the entry plus {KERNEL_RTOL} of max |d|")

    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    opt = SQN_free(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ, use_float=True)
    check(opt.device.type == "cuda", f"SQN_free runs on {opt.device} by "
          "default")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = FreeLoop(opt, X, Y, x0, STEP, audit)
    loop.run(NUM_BATCHES)
    # the last boundary's commit, on the gradient the pending request asks
    audit(loop, grad_fn(loop._at(loop.req["requested_on"]), (X[0], Y[0])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    audits = loop.audits
    print(f"  1 epoch ({NUM_BATCHES} steps, {len(loop.tasks)} requests) in "
          f"{wall:.3f} s, first call and the {len(audits)} audits included",
          flush=True)
    check(loop.tasks == expected_sqn_tasks(NUM_BATCHES),
          f"request order: {NUM_BATCHES + 1} calc_grad, "
          f"{loop.tasks.count('calc_hess_vec')} calc_hess_vec after the "
          "later boundaries")
    check(set(loop.infos) == {"no_problems_encountered"},
          f"every iteration_info is no_problems_encountered "
          f"({len(loop.infos)} calls), as in the JAX package's run")
    launches = {chosen: counts.pop(chosen), "project": counts.pop("project")}
    check(launches[chosen] == NUM_BATCHES and not any(counts.values()),
          f"{chosen} launched {launches[chosen]} times for {NUM_BATCHES} "
          f"steps; the other direction kernel and project_adaqn: {counts}")
    check(launches["project"] == len(audits) == 5,
          f"project launched {launches['project']} times, once per audit "
          "after the 5 commits")
    check(not plain_calls, "no plain version ran on the card "
          f"({len(plain_calls)} calls)")
    count = int(opt.state.mem.count)
    check(count == 5, f"ring count {count} == 5")
    loss1 = full_loss(loop.x)
    rel = abs(loss1 - JAX_FREE_SQN_LOSS_1_EPOCH) / JAX_FREE_SQN_LOSS_1_EPOCH
    check(rel <= LOSS_RTOL,
          f"loss after 1 epoch {loss1:.4f} vs the JAX package's SQN_free "
          f"{JAX_FREE_SQN_LOSS_1_EPOCH} (CPU): rel diff {rel:.3e} <= "
          f"{LOSS_RTOL}")

    trainer = FusedTrainer("SQN", SQNConfig.create(
        mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ), grad_fn,
        hess_vec_fn=hess_vec_fn)
    fstate, _ = trainer.epochs(trainer.init(x0), (X, Y), STEP, nepochs=1,
                               aligned=True)
    x_fused = fstate.x.cpu().numpy()
    err = float(np.max(np.abs(loop.x - x_fused)))
    check(np.allclose(loop.x, x_fused, rtol=PARITY_RTOL, atol=PARITY_ATOL),
          f"x vs FusedTrainer('SQN') on the same batches: max_abs_err="
          f"{err:.3e} within rtol={PARITY_RTOL} atol={PARITY_ATOL}")

    for task, ms in sorted(loop.call_ms.items()):
        print(f"  run_optimizer answering {task}: host wall median "
              f"{statistics.median(ms):.4f} ms over {len(ms)} calls "
              f"(min {min(ms):.4f}, max {max(ms):.4f})", flush=True)
    # a second epoch, steady: whole-loop rate, and the device's share of it
    t0 = time.perf_counter()
    loop.audit = None
    loop.run(2 * NUM_BATCHES)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    print(f"  steady epoch of the request loop (run_optimizer, transfers, "
          f"gradients): {NUM_BATCHES / steady:.1f} iters/s", flush=True)
    busy = device_busy_ms(lambda: loop.run(2 * NUM_BATCHES + UPD_FREQ))
    t0 = time.perf_counter()
    loop.run(2 * NUM_BATCHES + 2 * UPD_FREQ)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    print("  one round of the request loop: wall "
          f"{round_ms:.2f} ms, device busy "
          + ("not measured (the trace shows no device time)" if busy is None
             else f"{busy:.2f} ms under the profiler "
             f"({100 * busy / round_ms:.1f}% of the wall without it)"),
          flush=True)
    free_ips = NUM_BATCHES / steady
    # run_optimizer alone: ten calc_grad answers inside one round, fed a
    # gradient computed beforehand (a timing, after every check above)
    g_fixed = grad_fn(loop._at(loop.x), (X[0], Y[0]))

    def ten_calls():
        for _ in range(10):
            opt.update_gradient(g_fixed)
            opt.run_optimizer(loop.x, STEP)
    busy = device_busy_ms(ten_calls)
    print("  run_optimizer answering calc_grad, device busy per call: "
          + ("not measured (the trace shows no device time)" if busy is None
             else f"{busy / 10:.4f} ms (profiler, 10 calls)"), flush=True)

    # mem_size = 20: 47.9 MB of pairs and gradient, over any H100's cap
    m20 = M20
    check(not tlk.direction_fits(m20, N_FLAGSHIP, dev),
          f"m={m20}, n={N_FLAGSHIP} is over the one-read kernel's cap "
          f"({tlk.direction_max_n(m20, dev)})")
    opt20 = SQN_free(mem_size=m20, bfgs_upd_freq=UPD_FREQ, use_float=True)
    reset_launches()
    loop20 = FreeLoop(opt20, X, Y, x0, STEP, audit)
    loop20.run(3 * UPD_FREQ)
    # the last boundary's commit, as above
    audit(loop20, grad_fn(loop20._at(loop20.req["requested_on"]),
                          (X[0], Y[0])))
    counts = read_launches()
    streamed = counts.pop("direction_streamed")
    launches["project_m20"] = counts.pop("project")
    check(streamed == 3 * UPD_FREQ and not any(counts.values()),
          f"mem_size={m20}: direction_streamed launched {streamed} times "
          f"for {3 * UPD_FREQ} steps; direction and project_adaqn: {counts}")
    check(launches["project_m20"] == len(loop20.audits) == 2,
          f"mem_size={m20}: project launched {launches['project_m20']} "
          "times, once per audit after the 2 commits")
    check(loop20.tasks == expected_sqn_tasks(3 * UPD_FREQ)
          and set(loop20.infos) == {"no_problems_encountered"},
          f"mem_size={m20}: request order and iteration_info")
    check(not plain_calls, "no plain version ran on the card "
          f"({len(plain_calls)} calls)")
    loss20 = full_loss(loop20.x)
    rel = abs(loss20 - JAX_FREE_SQN_LOSS_3_ROUNDS) / JAX_FREE_SQN_LOSS_3_ROUNDS
    check(rel <= LOSS_RTOL and int(opt20.state.mem.count) == 2,
          f"mem_size={m20}: loss after 3 rounds {loss20:.4f} vs the JAX "
          f"package's {JAX_FREE_SQN_LOSS_3_ROUNDS}: rel diff {rel:.3e} <= "
          f"{LOSS_RTOL}; 2 live pairs")
    restore_plain()
    launches["direction_streamed"] = streamed
    return launches, free_ips, max(audits + loop20.audits)


def free_adaqn_phase(dev):
    phase("12. free-mode adaQN at BibTeX shape: adaQN_free request loop, "
          f"{FREE_ADAQN_BOUNDARIES} boundaries")
    X, Y, x0 = bench_data(dev)
    steps = FREE_ADAQN_BOUNDARIES * UPD_FREQ
    want_infos = JAX_ADAQN_BOUNDARY_INFOS[:FREE_ADAQN_BOUNDARIES]
    want_f = JAX_F64_GUARD_F[:FREE_ADAQN_BOUNDARIES]
    launches = 0
    for name, use_float, rtol in (("float64", False, F64_RTOL),
                                  ("float32, use_pallas=True", True,
                                   EARLY_RTOL)):
        opt = adaQN_free(**ADAQN_KW, use_float=use_float)
        data = (X, Y, x0) if use_float else (X.double(), Y.double(),
                                             x0.double())
        if use_float:
            opt._cfg = dataclasses.replace(opt._cfg, use_pallas=True)
        reset_launches()
        t0 = time.perf_counter()
        loop = FreeLoop(opt, *data, ADAQN_STEP)
        loop.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        got = counts.pop("project_adaqn")
        check(got == (steps if use_float else 0)
              and not any(counts.values()),
              f"{name}: project_adaqn launched {got} times for {steps} "
              f"steps; the other kernels: {counts}")
        f = torch.stack(loop.fvals).cpu().tolist()
        rel = max_rel(f, want_f)
        check(len(f) == len(want_f) and rel <= rtol,
              f"{name}: the {len(f)} function values it asked for, "
              f"{', '.join(f'{v:.4f}' for v in f)}, vs the JAX package's "
              f"float64 run: max rel diff {rel:.3e} <= {rtol}")
        # the info of a boundary comes with the request after its f (or,
        # at the first, after its last step)
        binfos = [loop.infos[i + 1] for i, t in enumerate(loop.tasks)
                  if t == "calc_fun_val_batch"]
        names = {200: "no_problems_encountered", 201: "func_increased"}
        check(binfos == [names[c] for c in want_infos],
              f"{name}: boundary infos {binfos}: the JAX package's")
        check(loop.tasks.count("calc_grad") == steps + 1
              and bool(np.isfinite(loop.x).all()),
              f"{name}: {steps} steps in {wall:.3f} s, x finite")
        launches += got
        for task, ms in sorted(loop.call_ms.items()):
            print(f"  {name}: run_optimizer answering {task}: host wall "
                  f"median {statistics.median(ms):.4f} ms over {len(ms)} "
                  "calls", flush=True)
    return launches


# ---------------------------------------------------------------------------
def interleaved_committed(n, dev, gen, shift, commits=12, m=MEM_SIZE):
    """An interleaved memory of m pairs in the given commit mode, filled by
    the port's own oLBFGS-style commits (no collapsed cache)."""
    mem = BFGSMemoryInterleaved.create(m, n, shift=shift, device=dev)
    for _ in range(commits):
        s = torch.randn(n, device=dev, generator=gen)
        y = s + 0.3 * torch.randn(n, device=dev, generator=gen)
        mem, _ = commit_pair(mem.replace(s_pending=s), y, 1e-4, 0.0)
    return mem


def peak_extra_bytes(fn):
    """Device bytes ``fn()`` holds at its peak beyond what was allocated
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def olbfgs_phase(dev):
    phase("13. oLBFGS: FusedTrainer('oLBFGS') at BibTeX shape, 2 epochs, "
          "block and interleaved; then oLBFGS_free")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    data = (X, Y)
    steps = 2 * NUM_BATCHES

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(
            torch.as_tensor(x, device=dev), Xf, Yf, None, REG))

    loss0 = full_loss(x0)
    plain_calls, restore_plain = spy_plain()
    runs = {}
    for layout in ("block", "interleaved"):
        trainer = FusedTrainer("oLBFGS", OLBFGSConfig.create(
            mem_size=MEM_SIZE, pairs_interleaved=layout == "interleaved"),
            grad_fn)
        state = trainer.init(x0.cpu().numpy())     # no device named
        pairs_buf = state.mem.sy if layout == "interleaved" else state.mem.s
        check(state.x.device.type == "cuda" and pairs_buf.device.type ==
              "cuda", f"{layout}: FusedTrainer.init(numpy x0) puts the state "
              "on the card")
        if layout == "interleaved":
            nbytes = state.mem.sy.numel() * 4
            check(state.mem.shift, f"interleaved: shift mode ({nbytes} bytes "
                  f"of pairs <= SHIFT_MAX_BYTES = {SHIFT_MAX_BYTES})")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")     # a host sync inside raises
        state, infos = trainer.epochs(state, data, STEP, nepochs=2)
        torch.cuda.set_sync_debug_mode(0)
        counts = read_launches()
        check(True, f"{layout}: no host sync inside epochs (sync debug mode "
              "'error')")
        torch.cuda.synchronize()
        print(f"  {layout}: 2 epochs ({steps} steps) in "
              f"{time.perf_counter() - t0:.3f} s, first call included",
              flush=True)
        check(not any(counts.values()) and not plain_calls,
              f"{layout}: no kernel ({counts}) and no plain version "
              f"({len(plain_calls)} calls) on the oLBFGS path")
        infos_l = infos.cpu().flatten().tolist()
        loss2 = full_loss(state.x)
        want = JAX_OLBFGS_LOSS[layout]
        rel = abs(loss2 - want) / want
        rel64 = abs(loss2 - JAX_OLBFGS_F64_LOSS) / JAX_OLBFGS_F64_LOSS
        check(bool(torch.isfinite(state.x).all()), f"{layout}: x is finite")
        check(len(infos_l) == steps and set(infos_l) == {200},
              f"{layout}: all {steps} info codes are 200")
        check(int(state.mem.count) == MEM_SIZE,
              f"{layout}: {MEM_SIZE} live pairs")
        check(loss2 < loss0, f"{layout}: loss fell: {loss0:.4f} -> "
              f"{loss2:.4f}")
        check(rel <= LOSS_RTOL,
              f"{layout}: loss after 2 epochs {loss2:.4f} vs the JAX "
              f"package's float32 {want} (CPU): rel diff {rel:.3e} <= "
              f"{LOSS_RTOL} (vs its float64 {JAX_OLBFGS_F64_LOSS:.5f}: "
              f"{rel64:.3e})")
        runs[layout] = [trainer, state]

    # Steady epochs of both layouts in turns, so that both see the same
    # card and host.
    rates = {"block": [], "interleaved": []}
    for layout in ("block", "interleaved", "interleaved", "block", "block",
                   "interleaved"):
        trainer, state = runs[layout]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[layout][1], _ = trainer.epochs(state, data, STEP, nepochs=1)
        torch.cuda.synchronize()
        rates[layout].append(NUM_BATCHES / (time.perf_counter() - t0))
    ips = {layout: statistics.median(v) for layout, v in rates.items()}
    for layout, vals in rates.items():
        print(f"  {layout}: steady epochs (in turns): "
              f"{', '.join(f'{v:.1f}' for v in vals)} iters/s; median "
              f"{ips[layout]:.1f} iters/s", flush=True)
        check(bool(torch.isfinite(runs[layout][1].x).all()),
              f"{layout}: x finite after the steady epochs")

    # the device's busy share of an epoch (profiler), beside the wall of
    # the same epoch without the profiler
    idle = {}
    for layout, run in runs.items():
        def one_epoch(run=run):
            run[1], _ = run[0].epochs(run[1], data, STEP, nepochs=1)
        busy = device_busy_ms(one_epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        idle[layout] = None if busy is None else 1 - busy / wall
        print(f"  {layout}: one epoch {wall:.2f} ms of wall, device busy "
              + ("not measured (the trace shows no device time)"
                 if busy is None else f"{busy:.2f} ms under the profiler: "
                 f"idle {100 * idle[layout]:.1f}%"), flush=True)

    layers = olbfgs_layers(dev, X, Y, runs)
    free = olbfgs_free_run(dev, X, Y, x0, full_loss, plain_calls)
    restore_plain()
    return dict(iters_per_s=ips, idle_share=idle, layers=layers, **free)


def olbfgs_layers(dev, X, Y, runs):
    """The layers of one oLBFGS step, each timed alone at device and host
    ms, and the commit in block, shift and ring mode.  Run after the
    epochs: the block and ring commits rewrite a row pair of the state's
    memory in place."""
    gen = torch.Generator(device=dev).manual_seed(13)
    trainer, state = runs["block"]
    cfg = trainer.cfg
    batch = (X[0], Y[0])
    g = grad_fn(state.x, batch)
    d = two_loop_cached(g, state.mem, h0=cfg.hess_init)
    s_cand = -STEP * d
    y_cand = grad_fn(state.x + s_cand, batch) - g
    ok = torch.ones((), dtype=torch.bool, device=dev)
    mems = {"block": state.mem, "shift": runs["interleaved"][1].mem,
            "ring": interleaved_committed(N_FLAGSHIP, dev, gen, shift=False)}
    check(mems["shift"].shift and not mems["ring"].shift,
          "interleaved memories in shift and in ring mode")

    def commit(mem):
        return lambda: commit_pair(mem.replace(s_pending=s_cand), y_cand,
                                   cfg.min_curvature, cfg.y_reg, enabled=ok)
    # (fn, calls per timing): few calls of the many-op ones, so that the
    # queue of pending CUDA kernels does not fill (see device_ms)
    layers = {
        "minibatch gradient (two per step)": (
            lambda: grad_fn(state.x, batch), 20),
        "two_loop_cached uncollapsed, block": (lambda: two_loop_cached(
            g, mems["block"], h0=cfg.hess_init), 20),
        "two_loop_cached uncollapsed, interleaved": (lambda: two_loop_cached(
            g, mems["shift"], h0=cfg.hess_init), 20),
        "commit_pair, block": (commit(mems["block"]), 5),
        "commit_pair, interleaved shift": (commit(mems["shift"]), 5),
        "commit_pair, interleaved ring (shift=False)": (
            commit(mems["ring"]), 5),
        "whole step (olbfgs_step), block": (lambda: olbfgs_step(
            cfg, grad_fn, state, batch, STEP), 3),
    }
    out = {}
    for name, (fn, iters) in layers.items():
        out[name] = (device_ms(fn, iters), host_ms(fn, iters))
        print(f"  layer {name}: device {out[name][0]:.4f} ms, host wall "
              f"{out[name][1]:.4f} ms", flush=True)
    pairs_mib = 2 * MEM_SIZE * N_FLAGSHIP * 4 / 2**20
    for mode in ("block", "shift", "ring"):
        extra = peak_extra_bytes(commit(mems[mode]))
        out[f"commit peak extra bytes, {mode}"] = extra
        print(f"  commit_pair, {mode}: {extra / 2**20:.1f} MiB held at its "
              f"peak beyond the state (pairs {pairs_mib:.1f} MiB)",
              flush=True)
    return out


def olbfgs_free_run(dev, X, Y, x0, full_loss, plain_calls):
    """``oLBFGS_free`` in a request loop for one epoch of the smoke's
    batches, against the fused engine on the same batches."""
    opt = oLBFGS_free(mem_size=MEM_SIZE, use_float=True)
    check(opt.device.type == "cuda", f"oLBFGS_free runs on {opt.device} by "
          "default")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = FreeLoop(opt, X, Y, x0, STEP)
    loop.run(NUM_BATCHES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f"  oLBFGS_free: 1 epoch ({NUM_BATCHES} steps, {len(loop.tasks)} "
          f"requests) in {wall:.3f} s, first call included", flush=True)
    check(loop.tasks == (["calc_grad", "calc_grad_same_batch"] * NUM_BATCHES
                         + ["calc_grad"]),
          f"oLBFGS_free request order: calc_grad, calc_grad_same_batch, ... "
          f"({len(loop.tasks)} requests)")
    check(set(loop.infos) == {"no_problems_encountered"},
          f"oLBFGS_free: every iteration_info is no_problems_encountered "
          f"({len(loop.infos)} calls)")
    check(not any(counts.values()) and not plain_calls,
          f"oLBFGS_free: no kernel ({counts}) and no plain version")
    loss1 = full_loss(loop.x)
    rel = abs(loss1 - JAX_OLBFGS_LOSS_1_EPOCH) / JAX_OLBFGS_LOSS_1_EPOCH
    check(rel <= LOSS_RTOL,
          f"oLBFGS_free: loss after 1 epoch {loss1:.4f} vs the JAX "
          f"package's {JAX_OLBFGS_LOSS_1_EPOCH} (fused, CPU): rel diff "
          f"{rel:.3e} <= {LOSS_RTOL}")
    trainer = FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=MEM_SIZE),
                           grad_fn)
    fstate, _ = trainer.epochs(trainer.init(x0), (X, Y), STEP, nepochs=1)
    x_fused = fstate.x.cpu().numpy()
    err = float(np.max(np.abs(loop.x - x_fused)))
    check(np.allclose(loop.x, x_fused, rtol=PARITY_RTOL, atol=PARITY_ATOL),
          f"oLBFGS_free x vs FusedTrainer('oLBFGS') on the same batches: "
          f"max_abs_err={err:.3e} within rtol={PARITY_RTOL} "
          f"atol={PARITY_ATOL}")
    for task, ms in sorted(loop.call_ms.items()):
        print(f"  oLBFGS_free: run_optimizer answering {task}: host wall "
              f"median {statistics.median(ms):.4f} ms over {len(ms)} calls",
              flush=True)
    t0 = time.perf_counter()
    loop.run(2 * NUM_BATCHES)
    torch.cuda.synchronize()
    free_ips = NUM_BATCHES / (time.perf_counter() - t0)
    print(f"  oLBFGS_free: steady epoch of the request loop: {free_ips:.1f} "
          "iters/s", flush=True)
    return dict(free_iters_per_s=free_ips, free_max_abs_err_vs_fused=err)


def sqn_interleaved_phase(dev):
    phase("14. FusedTrainer('SQN', pairs_interleaved=True) at BibTeX shape, "
          "2 epochs; then mem_size=20 for 3 rounds")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    data = (X, Y)
    steps = 2 * NUM_BATCHES

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(x, Xf, Yf, None, REG))

    def sqn_trainer(m, interleaved):
        return FusedTrainer("SQN", SQNConfig.create(
            mem_size=m, bfgs_upd_freq=UPD_FREQ,
            pairs_interleaved=interleaved), grad_fn)

    plain_calls, restore_plain = spy_plain()
    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    runs, counts = {}, {}
    for layout in ("interleaved", "block"):
        trainer = sqn_trainer(MEM_SIZE, layout == "interleaved")
        state = trainer.init(x0.cpu().numpy())
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        state, infos = trainer.epochs(state, data, STEP, nepochs=2,
                                      aligned=True)
        torch.cuda.set_sync_debug_mode(0)
        counts[layout] = read_launches()
        runs[layout] = [trainer, state, infos.cpu().flatten().tolist()]
    trainer, state, infos_l = runs["interleaved"]
    ilv_counts = dict(counts["interleaved"])
    launches = ilv_counts.pop(chosen)
    check(isinstance(state.mem, BFGSMemoryInterleaved) and state.mem.shift
          and state.mem.sy.device.type == "cuda",
          "interleaved: the memory is one [2m, n] buffer on the card, shift "
          "mode")
    check(launches == steps and not any(ilv_counts.values())
          and not plain_calls,
          f"interleaved: {chosen} launched {launches} times for {steps} "
          f"steps (on sy[:m], sy[m:]); the other kernels {ilv_counts}; no "
          f"plain version ({len(plain_calls)} calls)")
    check(counts["block"][chosen] == steps, f"block: {chosen} launched "
          f"{counts['block'][chosen]} times")
    loss2 = full_loss(state.x)
    rel = abs(loss2 - JAX_LOSS_2_EPOCHS) / JAX_LOSS_2_EPOCHS
    check(bool(torch.isfinite(state.x).all()) and set(infos_l) == {200}
          and int(state.mem.count) == MEM_SIZE,
          f"interleaved: x finite, all {len(infos_l)} info codes 200, "
          f"{MEM_SIZE} live pairs")
    check(rel <= LOSS_RTOL,
          f"interleaved: loss after 2 epochs {loss2:.4f} vs the JAX "
          f"package's interleaved {JAX_LOSS_2_EPOCHS} (CPU): rel diff "
          f"{rel:.3e} <= {LOSS_RTOL}")
    x_i, x_b = state.x.cpu().numpy(), runs["block"][1].x.cpu().numpy()
    err = float(np.max(np.abs(x_i - x_b)))
    check(np.allclose(x_i, x_b, rtol=PARITY_RTOL, atol=PARITY_ATOL),
          f"interleaved x vs the block layout's run: max_abs_err={err:.3e} "
          f"within rtol={PARITY_RTOL} atol={PARITY_ATOL}")

    rates = {"interleaved": [], "block": []}
    for layout in ("interleaved", "block", "block", "interleaved",
                   "interleaved", "block"):
        trainer, state, _ = runs[layout]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[layout][1], _ = trainer.epochs(state, data, STEP, nepochs=1,
                                            aligned=True)
        torch.cuda.synchronize()
        rates[layout].append(NUM_BATCHES / (time.perf_counter() - t0))
        check(read_launches()[chosen] == NUM_BATCHES,
              f"steady {layout} epoch: one {chosen} launch per step")
    ips = {layout: statistics.median(v) for layout, v in rates.items()}
    for layout, vals in rates.items():
        print(f"  {layout}: steady epochs (in turns): "
              f"{', '.join(f'{v:.1f}' for v in vals)} iters/s; median "
              f"{ips[layout]:.1f} iters/s", flush=True)

    # mem_size = 20: over the one-read kernel's cap, so direction_streamed
    m20 = M20
    check(not tlk.direction_fits(m20, N_FLAGSHIP, dev),
          f"m={m20}, n={N_FLAGSHIP} is over the one-read kernel's cap")
    trainer20 = sqn_trainer(m20, True)
    rounds = (X[:3 * UPD_FREQ], Y[:3 * UPD_FREQ])
    state20 = trainer20.init(x0)
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    state20, infos20 = trainer20.epochs(state20, rounds, STEP, nepochs=1,
                                        aligned=True)
    torch.cuda.set_sync_debug_mode(0)
    c20 = read_launches()
    streamed = c20.pop("direction_streamed")
    check(streamed == 3 * UPD_FREQ and not any(c20.values())
          and not plain_calls,
          f"mem_size={m20} interleaved: direction_streamed launched "
          f"{streamed} times for {3 * UPD_FREQ} steps; the other kernels "
          f"{c20}; no plain version")
    loss20 = full_loss(state20.x)
    rel = abs(loss20 - JAX_FREE_SQN_LOSS_3_ROUNDS) / JAX_FREE_SQN_LOSS_3_ROUNDS
    check(rel <= LOSS_RTOL and int(state20.mem.count) == 2
          and set(infos20.flatten().tolist()) == {200},
          f"mem_size={m20} interleaved: loss after 3 rounds {loss20:.4f} vs "
          f"the JAX package's {JAX_FREE_SQN_LOSS_3_ROUNDS}: rel diff "
          f"{rel:.3e} <= {LOSS_RTOL}; 2 live pairs; info codes 200")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state20, _ = trainer20.epochs(state20, rounds, STEP, nepochs=1,
                                  aligned=True)
    torch.cuda.synchronize()
    ips20 = 3 * UPD_FREQ / (time.perf_counter() - t0)
    print(f"  mem_size={m20} interleaved: 3 more rounds at {ips20:.1f} "
          "iters/s", flush=True)
    restore_plain()
    return ({chosen: launches}, streamed, ips, ips20)


# ---------------------------------------------------------------------------
def in_turns(runs, epoch, steps=NUM_BATCHES):
    """Steady epochs of two runs (name -> [trainer, state]) in turns (a,
    b, b, a, a, b), so that both see the same card and host; ``epoch(name,
    trainer, state)`` returns the new state.  Returns each run's median
    iters/s."""
    a, b = runs
    rates = {name: [] for name in runs}
    for name in (a, b, b, a, a, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name][1] = epoch(name, *runs[name])
        torch.cuda.synchronize()
        rates[name].append(steps / (time.perf_counter() - t0))
    ips = {name: statistics.median(v) for name, v in rates.items()}
    for name, vals in rates.items():
        print(f"  {name}: steady epochs (in turns): "
              f"{', '.join(f'{v:.1f}' for v in vals)} iters/s; median "
              f"{ips[name]:.1f} iters/s", flush=True)
        check(bool(torch.isfinite(runs[name][1].x).all()),
              f"{name}: x finite after the steady epochs")
    return ips


def idle_shares(runs, epoch):
    """The device's idle share of one more epoch of each run: busy time
    from a profiler trace against the wall of the same epoch without the
    profiler.  None where the trace shows no device time."""
    idle = {}
    for name, run in runs.items():
        def one_epoch(name=name, run=run):
            run[1] = epoch(name, *run)
        busy = device_busy_ms(one_epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        idle[name] = None if busy is None else 1 - busy / wall
        print(f"  {name}: one epoch {wall:.2f} ms of wall, device busy "
              + ("not measured (the trace shows no device time)"
                 if busy is None else f"{busy:.2f} ms under the profiler: "
                 f"idle {100 * idle[name]:.1f}%"), flush=True)
    return idle


def sqn_trainer(**cfg_kw):
    return FusedTrainer("SQN", SQNConfig.create(
        mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ, **cfg_kw), grad_fn)


def same_state(a, b):
    """Every tensor of two states of one kind is the same bits."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            if not same_state(va, vb):
                return False
        elif isinstance(va, torch.Tensor) and not torch.equal(va, vb):
            return False
    return True


def loss_gate(what, loss, want, rtol):
    rel = abs(loss - want) / want
    check(rel <= rtol, f"{what}: loss {loss:.4f} vs the JAX package's {want} "
          f"(CPU): rel diff {rel:.3e} <= {rtol}")


def generic_phase(dev):
    phase("15. the generic per-step layout at BibTeX shape: aligned=False "
          "against chunked, B = 110, a mid-round resume, adaQN")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    data = (X, Y)
    steps = 2 * NUM_BATCHES

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(x, Xf, Yf, None, REG))

    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    plain_calls, restore_plain = spy_plain()
    trainer = sqn_trainer()
    runs, launches = {}, {}
    for layout, aligned in (("chunked", True), ("generic", False)):
        state = trainer.init(x0)
        torch.cuda.synchronize()
        reset_launches()
        with host_reads() as reads:
            state, infos = trainer.epochs(state, data, STEP, nepochs=2,
                                          aligned=aligned)
        counts = read_launches()
        launches[layout] = counts.pop(chosen)
        want_reads = 0 if aligned else 1
        check(len(reads) == want_reads and launches[layout] == steps
              and not any(counts.values()) and not plain_calls,
              f"{layout} (aligned={aligned}): {len(reads)} host reads in 2 "
              f"epochs ({want_reads}: niter); {chosen} launched "
              f"{launches[layout]} times for {steps} steps, the others "
              f"{counts}, no plain version")
        runs[layout] = [trainer, state, infos]
    (_, sc, ic), (_, sg, ig) = runs["chunked"], runs["generic"]
    check(torch.equal(ic, ig) and same_state(sc, sg),
          "generic layout (aligned=False) on 120 batches: every tensor of "
          "the state and every info code the same bits as the chunked run")
    loss_gate("generic, 2 epochs", full_loss(sg.x), JAX_LOSS_2_EPOCHS,
              LOSS_RTOL)

    # B = 110: a fresh state asserted aligned reads nothing; both epochs
    # take the generic layout (110 % 20 != 0), the second from step 10 of
    # a round
    d110 = (X[:110], Y[:110])
    state = trainer.init(x0)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    state, infos = trainer.epochs(state, d110, STEP, nepochs=2, aligned=True)
    torch.cuda.set_sync_debug_mode(0)
    launches["b110"] = read_launches()[chosen]
    infos_l = infos.cpu().flatten().tolist()
    check(launches["b110"] == 220 and set(infos_l) == {200}
          and int(state.mem.count) == MEM_SIZE,
          f"B=110, 2 epochs: no host sync (sync debug mode 'error'), "
          f"{chosen} launched {launches['b110']} times for 220 steps, all "
          f"codes 200, {MEM_SIZE} live pairs")
    loss_gate("B=110, 2 epochs", full_loss(state.x), JAX_GENERIC_110_LOSS,
              LOSS_RTOL)

    # resumed mid-round: 10 steps, then an epoch of 120 with aligned=None
    state = trainer.init(x0)
    state, _ = trainer.epoch(state, (X[:10], Y[:10]), STEP, aligned=True)
    torch.cuda.synchronize()
    reset_launches()
    with host_reads() as reads:
        state, infos = trainer.epoch(state, data, STEP)
    launches["resume"] = read_launches()[chosen]
    check(len(reads) == 1 and launches["resume"] == NUM_BATCHES
          and int(state.niter) == 130 and int(state.mem.count) == 5
          and set(infos.tolist()) == {200},
          f"resumed 10 steps into a round: {len(reads)} host read (niter), "
          f"{chosen} launched {launches['resume']} times for {NUM_BATCHES} "
          "steps, niter 130, 5 live pairs, all codes 200")
    loss_gate("resumed epoch", full_loss(state.x), JAX_RESUME_LOSS,
              LOSS_RTOL)

    # generic against chunked: steady epochs in turns, and idle shares
    def epoch(name, tr, st):
        return tr.epochs(st, data, STEP, nepochs=1,
                         aligned=name == "chunked")[0]
    turns = {name: [trainer, runs[name][1]] for name in runs}
    ips = in_turns(turns, epoch)
    idle = idle_shares(turns, epoch)

    # adaQN fisher, kernel route, on the generic path: the chunked run's
    # bits, the JAX package's codes; float64 (plain route) at every
    # boundary against the JAX package's float64 run
    ada = {}
    for layout, aligned in (("chunked", True), ("generic", False)):
        ada[layout] = adaqn_two_epochs(f"adaQN {layout}", x0, data, True,
                                       aligned=aligned)
    _, sa, ia, _, fa, _ = ada["chunked"]
    _, sb, ib, binfos, fb, (ada_launches, ada_other) = ada["generic"]
    check(ada_launches == steps and ada_other == 0,
          f"adaQN generic: project_adaqn launched {ada_launches} times for "
          f"{steps} steps, the other kernels {ada_other} times")
    hist = {c: ib.count(c) for c in sorted(set(ib))}
    check(hist == JAX_ADAQN_INFOS and binfos == JAX_ADAQN_BOUNDARY_INFOS,
          f"adaQN generic: info histogram {hist}, boundary codes {binfos}: "
          "the JAX package's")
    check(ia == ib and fa == fb and same_state(sa, sb),
          "adaQN generic: the chunked run's state, codes and guard values, "
          "bit for bit")
    early = max_rel(fb[:EARLY_BOUNDARIES], JAX_F64_GUARD_F[:EARLY_BOUNDARIES])
    check(early <= EARLY_RTOL, f"adaQN generic: guard f at boundaries "
          f"1-{EARLY_BOUNDARIES} vs the JAX float64 run: {early:.3e} <= "
          f"{EARLY_RTOL}")
    _, s64, _, b64, f64, l64 = adaqn_two_epochs(
        "adaQN generic float64", x0.double(), (X.double(), Y.double()), None,
        aligned=False)
    loss64 = float(losses.multinomial_logistic_loss(
        s64.x, Xf.double(), Yf.double(), None, REG))
    rel_f = max_rel(f64, JAX_F64_GUARD_F)
    rel64 = abs(loss64 - JAX_F64_LOSS) / JAX_F64_LOSS
    check(l64 == (0, 0) and b64 == JAX_ADAQN_BOUNDARY_INFOS
          and rel_f <= F64_RTOL and rel64 <= F64_RTOL,
          f"adaQN generic float64: no kernel, the JAX codes, guard f at all "
          f"12 boundaries (max rel diff {rel_f:.3e}) and the loss {loss64:.4f}"
          f" ({rel64:.3e}) within {F64_RTOL} of the JAX float64 run")
    restore_plain()
    return dict(launches=launches["generic"] + launches["b110"]
                + launches["resume"],
                adaqn_launches=ada_launches, iters_per_s=ips,
                idle_share=idle)


def bf16_phase(dev):
    phase("16. bfloat16 storage at BibTeX shape: SQN block and interleaved "
          "on direction_streamed, oLBFGS interleaved, adaQN fisher_bf16")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    data = (X, Y)
    steps = 2 * NUM_BATCHES

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(x, Xf, Yf, None, REG))

    plain_calls, restore_plain = spy_plain()
    runs, launches = {}, {}
    for layout in ("block", "interleaved"):
        trainer = sqn_trainer(pairs_bf16=True,
                              pairs_interleaved=layout == "interleaved")
        state = trainer.init(x0.cpu().numpy())
        rows = state.mem.sy if layout == "interleaved" else state.mem.s
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        state, infos = trainer.epochs(state, data, STEP, nepochs=2,
                                      aligned=True)
        torch.cuda.set_sync_debug_mode(0)
        counts = read_launches()
        launches[layout] = counts.pop("direction_streamed")
        infos_l = infos.cpu().flatten().tolist()
        check(rows.dtype == torch.bfloat16 and rows.device.type == "cuda"
              and launches[layout] == steps and not any(counts.values())
              and not plain_calls,
              f"SQN bf16 {layout}: pairs bfloat16 on the card, no host sync, "
              f"direction_streamed launched {launches[layout]} times for "
              f"{steps} steps on bfloat16 pairs, the others {counts}, no "
              f"plain version ({len(plain_calls)} calls)")
        check(set(infos_l) == {200} and int(state.mem.count) == MEM_SIZE,
              f"SQN bf16 {layout}: all codes 200, {MEM_SIZE} live pairs")
        name = f"sqn_{layout}"
        loss_gate(f"SQN bf16 {layout}, 2 epochs", full_loss(state.x),
                  JAX_BF16_LOSS[name], BF16_RTOL[name])
        runs[f"bf16 {layout}"] = [trainer, state]

    # bf16 against float32 (block), steady epochs in turns and idle shares
    f32 = sqn_trainer()
    st32, _ = f32.epochs(f32.init(x0), data, STEP, nepochs=2, aligned=True)
    pair = {"float32 block": [f32, st32], "bf16 block": runs["bf16 block"]}

    def epoch(name, tr, st):
        return tr.epochs(st, data, STEP, nepochs=1, aligned=True)[0]
    ips = in_turns(pair, epoch)
    idle = idle_shares(pair, epoch)
    g = grad_fn(x0, (X[0], Y[0]))
    t_dir = {}
    for name, (_, st) in pair.items():
        t_dir[name] = device_ms(
            lambda st=st: two_loop_cached(g, st.mem, collapsed=True), 50)
    print(f"  collapsed direction, device: float32 "
          f"{t_dir['float32 block']:.4f} ms, bf16 {t_dir['bf16 block']:.4f} "
          f"ms (m={MEM_SIZE}, n={N_FLAGSHIP})", flush=True)

    # oLBFGS, bf16 interleaved pairs: no kernel serves it
    ol = FusedTrainer("oLBFGS", OLBFGSConfig.create(
        mem_size=MEM_SIZE, pairs_bf16=True, pairs_interleaved=True), grad_fn)
    state = ol.init(x0)
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    state, infos = ol.epochs(state, data, STEP, nepochs=2)
    torch.cuda.set_sync_debug_mode(0)
    counts = read_launches()
    check(state.mem.sy.dtype == torch.bfloat16 and not any(counts.values())
          and set(infos.flatten().tolist()) == {200}
          and int(state.mem.count) == MEM_SIZE,
          f"oLBFGS bf16 interleaved: bfloat16 pairs, no host sync, no kernel "
          f"({counts}), all codes 200, {MEM_SIZE} live pairs")
    loss_gate("oLBFGS bf16 interleaved, 2 epochs", full_loss(state.x),
              JAX_BF16_LOSS["olbfgs_interleaved"],
              BF16_RTOL["olbfgs_interleaved"])
    # the same run in float64 math, the pairs still bfloat16: no stored
    # row flips, so the port is held to the JAX package's bfloat16 steps
    X64, Y64, x64 = X.double(), Y.double(), x0.double()
    state = ol.init(x64)
    torch.cuda.set_sync_debug_mode("error")
    state, infos = ol.epochs(state, (X64, Y64), STEP, nepochs=2)
    torch.cuda.set_sync_debug_mode(0)
    check(state.mem.sy.dtype == torch.bfloat16
          and state.x.dtype == torch.float64
          and set(infos.flatten().tolist()) == {200}
          and int(state.mem.count) == MEM_SIZE,
          "oLBFGS bf16 interleaved, float64 iterate: bfloat16 pairs, no host "
          f"sync, all codes 200, {MEM_SIZE} live pairs")
    loss_gate("oLBFGS bf16 interleaved in float64, 2 epochs",
              float(losses.multinomial_logistic_loss(
                  state.x, X64.reshape(-1, N_FEATURES),
                  Y64.reshape(-1, N_CLASSES), None, REG)),
              JAX_OLBFGS_BF16_F64_LOSS, F64_RTOL)

    # adaQN, bf16 Fisher rows, kernel route (the pairs stay float32)
    _, st, infos_l, binfos, f, (ada_launches, other) = adaqn_two_epochs(
        "adaQN fisher_bf16", x0, data, True, fisher_bf16=True)
    hist = {c: infos_l.count(c) for c in sorted(set(infos_l))}
    check(st.fisher.f.dtype == torch.bfloat16 and ada_launches == steps
          and other == 0 and hist == JAX_ADAQN_INFOS
          and binfos == JAX_ADAQN_BOUNDARY_INFOS,
          f"adaQN fisher_bf16: bfloat16 Fisher rows, project_adaqn launched "
          f"{ada_launches} times for {steps} steps (others {other}), info "
          f"histogram {hist} and boundary codes: the JAX package's")
    loss_gate("adaQN fisher_bf16, 2 epochs", full_loss(st.x),
              JAX_BF16_LOSS["adaqn_fisher"], BF16_RTOL["adaqn_fisher"])
    restore_plain()
    return dict(launches=launches, adaqn_launches=ada_launches,
                iters_per_s=ips, idle_share=idle, direction_ms=t_dir)


def drivers_phase(dev):
    phase("17. drivers at BibTeX shape: epochs_scheduled, run_epochs with a "
          "shuffle, stream_rounds, paired oLBFGS")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    data = (X, Y)
    rows = NUM_BATCHES * BATCH_SIZE

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(x, Xf, Yf, None, REG))

    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    plain_calls, restore_plain = spy_plain()
    trainer = sqn_trainer()
    launches = {}
    rng = np.random.default_rng(2)
    # the schedule on the card before the run (a copy from the host waits)
    orders = torch.from_numpy(np.stack([rng.permutation(rows)
                                        for _ in range(3)])).to(dev)
    etas = torch.tensor([step_size_sqrt(STEP, e) for e in range(3)],
                        dtype=torch.float32, device=dev)
    state = trainer.init(x0)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    state, infos = trainer.epochs_scheduled(state, (Xf, Yf), etas, orders,
                                            batch_size=BATCH_SIZE,
                                            aligned=True)
    torch.cuda.set_sync_debug_mode(0)
    counts = read_launches()
    launches["scheduled"] = counts.pop(chosen)
    check(launches["scheduled"] == 3 * NUM_BATCHES
          and not any(counts.values()) and not plain_calls
          and set(infos.flatten().tolist()) == {200}
          and int(state.mem.count) == MEM_SIZE,
          f"epochs_scheduled, 3 epochs: no host sync, {chosen} launched "
          f"{launches['scheduled']} times, others {counts}, all codes 200, "
          f"{MEM_SIZE} live pairs")
    loss_gate("epochs_scheduled, 3 epochs", full_loss(state.x),
              JAX_SCHEDULED_LOSS, LOSS_RTOL)

    # run_epochs with a shuffle is epochs_scheduled on the permutations
    # it drew
    gen = torch.Generator(device=dev).manual_seed(3)
    twin = torch.Generator(device=dev).manual_seed(3)
    state = trainer.init(x0)
    torch.cuda.synchronize()
    reset_launches()
    graphs.reset_stats()
    with host_reads() as reads:
        state, infos = trainer.run_epochs(state, data, 2, STEP,
                                          decr_step_size=step_size_sqrt,
                                          shuffle=gen)
    launches["run_epochs"] = read_launches()[chosen]
    # run_epochs is jit_epoch's program: one warm-up epoch before its
    # capture, then one replay per epoch
    warm = graph_launches("warm_launches")[chosen]
    replayed = graph_launches("replay_launches")[chosen]
    drawn = torch.stack([torch.randperm(rows, generator=twin, device=dev)
                         for _ in range(2)])
    etas2 = torch.tensor([step_size_sqrt(STEP, e) for e in range(2)],
                         dtype=torch.float32, device=dev)
    st2, infos2 = trainer.epochs_scheduled(trainer.init(x0), (Xf, Yf), etas2,
                                           drawn, batch_size=BATCH_SIZE,
                                           aligned=True)
    check(len(reads) == 1,
          f"run_epochs with a shuffle: {len(reads)} host sync in 2 epochs, "
          "the one read of niter before the first"
          + (f" ({reads[0][:80]})" if reads else ""))
    check(replayed == 2 * NUM_BATCHES and warm == NUM_BATCHES
          and launches["run_epochs"] == replayed + warm
          and graphs.STATS["replays"] == 2 and torch.equal(infos, infos2)
          and same_state(state, st2),
          f"run_epochs(shuffle=generator), 2 replays of a CUDA graph: "
          f"{chosen} launched {replayed} times by the replays and {warm} by "
          f"the warm-up epoch; the same bits as the eager epochs_scheduled "
          "on the permutations it drew")

    # stream_rounds from numpy minibatches through prefetch_to_device
    Xn, Yn = X.cpu().numpy(), Y.cpu().numpy()
    ref, ref_infos = trainer.epochs(trainer.init(x0), data, STEP, nepochs=1,
                                    aligned=True)
    state = trainer.init(x0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    state, infos = stream_rounds(trainer, state,
                                 ((Xn[i], Yn[i]) for i in range(NUM_BATCHES)),
                                 STEP)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    stream_ips = NUM_BATCHES / (time.perf_counter() - t0)
    launches["stream_rounds"] = read_launches()[chosen]
    check(launches["stream_rounds"] == NUM_BATCHES
          and torch.equal(infos, ref_infos[0]) and same_state(state, ref),
          f"stream_rounds of numpy minibatches (pinned, non_blocking "
          f"copies): no host sync, {chosen} launched "
          f"{launches['stream_rounds']} times, the same bits as epochs on the "
          f"same batches; {stream_ips:.1f} iters/s, first call included")
    check(next(prefetch_to_device([Xn[0]])).device.type == "cuda",
          "prefetch_to_device defaults to the card")

    # oLBFGS: paired gradients against the sequential layout.  A vmapped
    # pair of gradients sums in another order than two calls, so float32
    # trajectories part at rounding level and that grows over 240 steps
    # (as the block and interleaved layouts part, phase 13): float32 is
    # held to the same codes and the JAX loss, and x to the tolerances of
    # tests/test_fused.py:418 in float64, where that test runs.
    olr = {}
    for dtype in (torch.float32, torch.float64):
        d = (X.to(dtype), Y.to(dtype))
        for paired in (False, True):
            tr = FusedTrainer("oLBFGS", OLBFGSConfig.create(
                mem_size=MEM_SIZE), grad_fn, paired_grads=paired)
            torch.cuda.set_sync_debug_mode("error")
            st, inf = tr.epochs(tr.init(x0.to(dtype)), d, STEP, nepochs=2)
            torch.cuda.set_sync_debug_mode(0)
            olr[dtype, paired] = [tr, st, inf]
    g_seq = torch.stack([grad_fn(x0, (X[-1], Y[-1])),
                         grad_fn(x0, (X[0], Y[0]))])
    g_pair = torch.func.vmap(grad_fn, in_dims=(None, 0))(
        x0, (torch.stack([X[-1], X[0]]), torch.stack([Y[-1], Y[0]])))
    print(f"  vmapped pair of gradients vs two calls (float32): max abs diff "
          f"{float((g_pair - g_seq).abs().max()):.3e} (max |g| "
          f"{float(g_seq.abs().max()):.3e})", flush=True)
    pruns = {("paired" if paired else "sequential"): olr[dt, paired][:2]
             for dt, paired in olr if dt == torch.float32}

    def ol_epoch(name, tr, st):
        return tr.epochs(st, data, STEP, nepochs=1)[0]
    paired_ips = in_turns(pruns, ol_epoch)
    paired_idle = idle_shares(pruns, ol_epoch)
    for dtype in (torch.float32, torch.float64):
        (_, ss, is_), (_, sp, ip) = olr[dtype, False], olr[dtype, True]
        err = float((sp.x - ss.x).abs().max())
        print(f"  oLBFGS paired vs sequential, {dtype}: x max abs diff "
              f"{err:.3e} (max |x| {float(ss.x.abs().max()):.3e})",
              flush=True)
        check(torch.equal(ip, is_) and set(ip.flatten().tolist()) == {200},
              f"oLBFGS paired vs sequential, {dtype}: the same info codes, "
              "all 200")
    (_, sp32, _), (_, sp64, _) = olr[torch.float32, True], \
        olr[torch.float64, True]
    loss_gate("oLBFGS paired float32, 2 epochs", full_loss(sp32.x),
              JAX_OLBFGS_LOSS["block"], LOSS_RTOL)
    ss64 = olr[torch.float64, False][1]
    check(torch.allclose(sp64.x, ss64.x, rtol=PAIRED_RTOL, atol=PAIRED_ATOL),
          f"oLBFGS paired vs sequential, float64: x within rtol "
          f"{PAIRED_RTOL}, atol {PAIRED_ATOL}")
    restore_plain()
    return dict(launches=launches, stream_iters_per_s=stream_ips,
                paired_iters_per_s=paired_ips, paired_idle_share=paired_idle)


# ---------------------------------------------------------------------------
def front_end_data():
    """Phase 18's data on the host, as a user has it: bench_data's draws
    (numpy's default_rng(1), the same stream) flattened to 6,000 rows, the
    labels as integers and one-hot rows, bench.py's x0."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((NUM_BATCHES * BATCH_SIZE, N_FEATURES)).astype(
        np.float32)
    labels = rng.integers(0, N_CLASSES, NUM_BATCHES * BATCH_SIZE)
    Y = np.eye(N_CLASSES, dtype=np.float32)[labels]
    x0 = rng.standard_normal(N_FLAGSHIP).astype(np.float32)
    return X, Y, labels, x0


def model_loss(x, X, Y):
    """The logistic model's objective on all rows: the mean log-loss
    (sample weights 1/n) and 0.5 * reg_param * ||coef||^2, reg_param 1e-3
    (the model's default)."""
    x = torch.as_tensor(x, device=X.device, dtype=X.dtype)
    w = torch.full((X.shape[0],), 1.0 / X.shape[0], dtype=X.dtype,
                   device=X.device)
    return float(losses.multinomial_logistic_loss(x, X, Y, w, 1e-3))


def guided_callables(dev):
    """The guided callables of phase 18: the port's closed-form losses
    (summed, reg 0.1), computed on the card.  The protocol engine hands
    them numpy arrays, which go to the card; the fused engine hands them
    tensors on the card, used where they are."""
    def t(a):
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def grad(x, Xb, Yb, sample_weight=None):
        return losses.multinomial_logistic_grad(t(x), t(Xb), t(Yb), None, REG)

    def obj(x, Xb, Yb, sample_weight=None):
        return losses.multinomial_logistic_loss(t(x), t(Xb), t(Yb), None, REG)

    def hess_vec(x, v, Xb, Yb, sample_weight=None):
        return losses.multinomial_logistic_hessvec(t(x), t(v), t(Xb), t(Yb),
                                                   None, REG)
    return grad, obj, hess_vec


@contextlib.contextmanager
def epochs_without_host_sync():
    """Every epoch a fused driver runs inside (``FusedTrainer._epoch_at``,
    which ``epoch``, ``epochs`` and ``epochs_scheduled`` call, and which
    a CUDA graph's warm-up and capture run; and every replay of a graph)
    runs under sync debug mode "error": a host sync inside an epoch
    raises.  Yields the list of epochs run (eager, warm-up and capture
    runs as the optimizer's name, replays as "replay")."""
    orig, orig_replay = FusedTrainer._epoch_at, graphs._Graph.replay
    seen = []

    def guarded(fn, name):
        def run(self, *args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(self, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            seen.append(name or self.optimizer)
            return out
        return run
    FusedTrainer._epoch_at = guarded(orig, None)
    graphs._Graph.replay = guarded(orig_replay, "replay")
    try:
        yield seen
    finally:
        FusedTrainer._epoch_at, graphs._Graph.replay = orig, orig_replay


# The kernels' launch counters (ops.kernels.two_loop_kernel) by kernel, and
# each kernel's function name in a profiler trace.
COUNTER = {"direction_streamed": "LAUNCHES", "direction": "DIRECTION_LAUNCHES",
           "project": "PROJECT_LAUNCHES",
           "project_adaqn": "PROJECT_ADAQN_LAUNCHES"}
SYMBOL = {"direction_streamed": "direction_parked",
          "direction": "direction_one_read", "project": "project_partials",
          "project_adaqn": "adaqn_partials"}
# The graph statistics (graphs.STATS) of each path driven() drove, by its
# label.
DRIVEN_GRAPHS = {}


def graph_launches(kind):
    """The launches of each kernel that graphs.STATS holds under ``kind``
    (``warm_launches`` or ``replay_launches``)."""
    return {name: graphs.STATS[kind].get(c, 0) for name, c in COUNTER.items()}


def driven(what, fn, kernel, launches, no_sync=True):
    """Drive one path with every count at 0 and the plain versions spied
    on: ``fn()`` must launch ``kernel`` ``launches`` times in its epochs,
    eager or replayed (no kernel when ``kernel`` is None), plus what the
    warm-up epoch of each CUDA graph it captured launched, no other
    kernel and no plain version.  Returns ``fn()``'s value and the
    kernel's count read just after (warm-up launches included)."""
    torch.cuda.synchronize()
    calls, restore = spy_plain()
    reset_launches()
    graphs.reset_stats()
    with (epochs_without_host_sync() if no_sync
          else contextlib.nullcontext()) as epochs:
        out = fn()
    counts = read_launches()
    restore()
    DRIVEN_GRAPHS[what] = dict(graphs.STATS)
    warm = graph_launches("warm_launches")
    got = counts.pop(kernel) if kernel is not None else 0
    want = launches + (warm[kernel] if kernel is not None else 0)
    check(got == want and not any(counts.values()) and not calls,
          f"{what}: {kernel} launched {got} times (want {launches} in the "
          f"epochs + {want - launches} by the warm-up epochs of "
          f"{graphs.STATS['captures']} CUDA graphs), other kernels "
          f"{counts}, plain versions {len(calls)}"
          + (f", {len(epochs)} epoch runs with no host sync "
             f"({epochs.count('replay')} replays)" if no_sync else ""))
    return out, got


def loss_near(what, loss, want, rtol):
    rel = abs(loss - want) / abs(want)
    check(np.isfinite(loss) and rel <= rtol,
          f"{what}: loss {loss:.7g} vs JAX package {want:.7g} (CPU): rel "
          f"diff {rel:.3e} <= {rtol}")
    return rel


def front_end_phase(dev):
    phase("18. the front ends at BibTeX shape: StochasticLogisticRegression,"
          " guided SQN, minimize, MLP, OLBFGS, checkpoints")
    X, Y, labels, x0 = front_end_data()
    Xd, Yd = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    steps = 2 * NUM_BATCHES
    out = {"launches": {}, "losses": {}}

    # (a) the logistic model, fused SQN, no device named
    clf, out["launches"]["logistic_fused_sqn"] = driven(
        "(a) StochasticLogisticRegression SQN fused",
        lambda: StochasticLogisticRegression(
            optimizer="SQN", bfgs_upd_freq=UPD_FREQ, **FE_MODEL_KW).fit(X, Y),
        chosen, steps)
    st = clf._fused_state
    check(clf.optimizer is None and st.x.device.type == "cuda"
          and st.mem.s.device.type == "cuda" and int(st.niter) == steps,
          "(a) the fit ran on the fused engine (not the protocol loop), the "
          f"state on the card, niter {int(st.niter)}")
    loss = model_loss(clf.x_, Xd, Yd)
    out["losses"]["logistic_sqn"] = loss
    loss_near("(a) logistic SQN", loss, JAX_FE_LOSS["logistic_sqn"], LOSS_RTOL)
    check(int(st.mem.count) == MEM_SIZE, f"(a) {MEM_SIZE} live pairs")
    prob = clf.predict_proba(X[:5])
    check(prob.shape == (5, N_CLASSES) and np.isfinite(prob).all(),
          "(a) predict_proba: finite, [5, 159]")

    # (b) the guided SQN on the protocol engine, one epoch
    grad, obj, hess_vec = guided_callables(dev)

    def guided(nepochs, **kw):
        return SQN(x0, grad, obj_fun=obj, hess_vec_fun=hess_vec,
                   batches_per_epoch=NUM_BATCHES, step_size=STEP,
                   nepochs=nepochs, mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ,
                   use_float=True, verbose=False, **kw)
    proto = guided(1)
    tasks, call_ms = [], []
    run = proto.optimizer.run_optimizer

    def timed_run(x, step):
        t0 = time.perf_counter()
        req = run(x, step)
        call_ms.append((time.perf_counter() - t0) * 1e3)
        tasks.append(req["task"])
        return req
    proto.optimizer.run_optimizer = timed_run
    t0 = time.perf_counter()
    _, out["launches"]["guided_protocol_sqn"] = driven(
        "(b) guided SQN, protocol engine, 1 epoch",
        lambda: proto.fit(X, Y, engine="protocol"), chosen, NUM_BATCHES,
        no_sync=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(tasks == expected_sqn_tasks(NUM_BATCHES)[1:],
          f"(b) the request order: {len(tasks)} requests, "
          f"{tasks.count('calc_hess_vec')} calc_hess_vec")
    loss = float(obj(proto.x, X, Y))
    out["losses"]["guided_protocol_sqn_1_epoch"] = loss
    loss_near("(b) guided protocol SQN, 1 epoch", loss,
              JAX_FE_LOSS["guided_protocol_sqn_1_epoch"], LOSS_RTOL)
    one = guided(1)
    one.fit(X, Y, engine="fused")
    err = float(np.abs(proto.x - one.x).max())
    check(one._fused_dispatch_mode == "loop"
          and np.allclose(proto.x, one.x, rtol=PARITY_RTOL, atol=PARITY_ATOL),
          f"(b) x against the fused engine on the same batches: max_abs_err "
          f"{err:.3e} within rtol={PARITY_RTOL} atol={PARITY_ATOL}")
    grad_calls = [ms for ms, t in zip(call_ms[1:], tasks) if t == "calc_grad"]
    out["protocol_call_ms"] = statistics.median(call_ms)
    out["protocol_request_ms"] = 1e3 * fit_s / len(tasks)
    print(f"  (b) host wall: run_optimizer median {out['protocol_call_ms']:.4f}"
          f" ms a call ({statistics.median(grad_calls):.4f} ms answering "
          f"a calc_grad); {out['protocol_request_ms']:.4f} ms a request with "
          f"its callable, {NUM_BATCHES / fit_s:.1f} iters/s", flush=True)

    # (c) the guided SQN on the fused engine: default shuffle, "auto" decay
    fused, out["launches"]["guided_fused_sqn"] = driven(
        "(c) guided SQN, fused engine, 2 epochs",
        lambda: guided(2).fit(X, Y, engine="fused"), chosen, steps)
    check(fused._fused_dispatch_mode == "scheduled" and fused.niter == steps
          and fused.req["task"] == "calc_grad",
          f"(c) one scheduled dispatch ({fused._fused_dispatch_mode}), niter "
          f"{fused.niter}, the protocol resumes at calc_grad")
    loss = float(obj(fused.x, X, Y))
    out["losses"]["guided_fused_sqn_2_epochs"] = loss
    loss_near("(c) guided fused SQN, 2 epochs", loss,
              JAX_FE_LOSS["guided_fused_sqn_2_epochs"], LOSS_RTOL)

    # (d) adaQN through the model, the projection kernel; float64 plain
    ada_kw = dict(optimizer="adaQN", fisher_size=100, rmsprop_weight=0.9,
                  step_size=ADAQN_STEP, bfgs_upd_freq=UPD_FREQ, **FE_MODEL_KW)
    ada, out["launches"]["logistic_fused_adaqn"] = driven(
        "(d) StochasticLogisticRegression adaQN fused, use_pallas=True",
        lambda: StochasticLogisticRegression(use_pallas=True, **ada_kw).fit(
            X, Y), "project_adaqn", steps)
    loss = model_loss(ada.x_, Xd, Yd)
    out["losses"]["logistic_adaqn"] = loss
    rel32 = abs(loss - JAX_FE_ADAQN_LOSS) / JAX_FE_ADAQN_LOSS
    loss_near("(d) logistic adaQN float32 (kernel route) against the JAX "
              "float64 run", loss, JAX_FE_ADAQN_F64_LOSS, FINAL_RTOL)
    print(f"  (d) float32 against the JAX float32 run (coupling gram): "
          f"{rel32:.3e}", flush=True)
    ada64, _ = driven(
        "(d) adaQN float64 (no kernel takes float64)",
        lambda: StochasticLogisticRegression(
            use_pallas=True, dtype=torch.float64, **ada_kw).fit(X, Y),
        None, 0)
    loss = model_loss(ada64.x_, Xd.double(), Yd.double())
    out["losses"]["logistic_adaqn_f64"] = loss
    loss_near("(d) logistic adaQN float64", loss, JAX_FE_ADAQN_F64_LOSS,
              F64_RTOL)

    # (e) oLBFGS through the model (no kernel serves oLBFGS)
    olb, _ = driven("(e) StochasticLogisticRegression oLBFGS fused",
                    lambda: StochasticLogisticRegression(
                        optimizer="oLBFGS", **FE_MODEL_KW).fit(X, Y),
                    None, 0)
    loss = model_loss(olb.x_, Xd, Yd)
    out["losses"]["logistic_olbfgs"] = loss
    loss_near("(e) logistic oLBFGS", loss, JAX_FE_LOSS["logistic_olbfgs"],
              LOSS_RTOL)

    # (f) the same SQN fit on a CSR matrix, and on its densified copy
    import scipy.sparse as sp
    rng = np.random.default_rng(1)
    Xs = sp.random(X.shape[0], N_FEATURES, density=FE_DENSITY, format="csr",
                   random_state=rng, dtype=np.float32,
                   data_rvs=lambda k: rng.standard_normal(k).astype(
                       np.float32))
    sq_kw = dict(optimizer="SQN", bfgs_upd_freq=UPD_FREQ, **FE_MODEL_KW)
    sparse, out["launches"]["logistic_sparse_sqn"] = driven(
        f"(f) StochasticLogisticRegression SQN fused on a CSR matrix "
        f"({Xs.nnz} entries, at most {np.diff(Xs.indptr).max()} a row)",
        lambda: StochasticLogisticRegression(**sq_kw).fit(Xs, Y), chosen,
        steps)
    dense = StochasticLogisticRegression(**sq_kw).fit(Xs.toarray(), Y)
    Xsd = torch.from_numpy(Xs.toarray()).to(dev)
    ls, ld = model_loss(sparse.x_, Xsd, Yd), model_loss(dense.x_, Xsd, Yd)
    rel = abs(ls - ld) / ld
    err = float(np.abs(sparse.x_ - dense.x_).max())
    scale = float(np.abs(dense.x_).max())
    check(rel <= FE_SPARSE_RTOL and err <= FE_SPARSE_RTOL * scale,
          f"(f) CSR against its densified copy: loss {ls:.7g} vs {ld:.7g} "
          f"(rel {rel:.3e}), max |dx| {err:.3e} (max |x| {scale:.3g}); "
          f"within {FE_SPARSE_RTOL} relative")

    # (g) minimize with a flat numpy x0 at full width; the MLP
    def loss_fn(x, b):
        return losses.multinomial_logistic_loss(x, b[0], b[1], None, REG)
    res, out["launches"]["minimize_sqn"] = driven(
        "(g) minimize(SQN) from a numpy x0",
        lambda: minimize(loss_fn, x0, (X, Y), optimizer="SQN",
                         step_size=STEP, batch_size=BATCH_SIZE, nepochs=2,
                         mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ),
        chosen, steps)
    l0 = float(loss_fn(torch.from_numpy(x0).to(dev), (Xd, Yd)))
    l1 = float(loss_fn(res.x, (Xd, Yd)))
    check(res.x.device.type == "cuda" and np.isfinite(l1) and l1 < l0,
          f"(g) minimize on the card: loss {l0:.1f} -> {l1:.1f}")
    out["losses"]["minimize_sqn"] = l1
    mlp = MLPClassifier(hidden=(64,), nepochs=2, random_state=1,
                        step_size=FE_MLP_STEP)
    sizes = [N_FEATURES, 64, N_CLASSES]
    p0 = init_mlp_params(torch.Generator(device=dev).manual_seed(1), sizes)
    m0 = float(mlp_loss(p0, (Xd, Yd), mlp.reg_param))
    mlp.fit(X, labels)
    m1 = float(mlp_loss(mlp.params_, (Xd, Yd), mlp.reg_param))
    check(np.isfinite(m1) and m1 < m0,
          f"(g) MLPClassifier(hidden=(64,)) adaQN, 2 epochs: loss {m0:.4f} "
          f"-> {m1:.4f}, accuracy {mlp.score(X, labels):.3f}")

    # (h) OLBFGS as a torch.optim.Optimizer, 20 steps
    w = torch.nn.Parameter(torch.from_numpy(x0).to(dev))
    opt = OLBFGS([w], lr=STEP, mem_size=MEM_SIZE)
    h0 = float(loss_fn(w.detach(), (Xd, Yd)))
    for k in range(20):
        opt.zero_grad()
        rows = slice(k * BATCH_SIZE, (k + 1) * BATCH_SIZE)
        loss_fn(w, (Xd[rows], Yd[rows])).backward()
        opt.step()
    h1 = float(loss_fn(w.detach(), (Xd, Yd)))
    check(np.isfinite(h1) and h1 < h0 and int(opt.state[w]["mem"].count) > 0,
          f"(h) OLBFGS, 20 steps: loss {h0:.1f} -> {h1:.1f}, "
          f"{int(opt.state[w]['mem'].count)} live pairs")

    # (i) save_state mid-protocol, load_state into a fresh SQN_free
    import tempfile
    Xb, Yb = Xd.reshape(NUM_BATCHES, BATCH_SIZE, -1), Yd.reshape(
        NUM_BATCHES, BATCH_SIZE, -1)
    free = SQN_free(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ, use_float=True)
    loop = FreeLoop(free, Xb, Yb, x0, STEP)
    while not (loop.req["task"] == "calc_hess_vec"
               and free.niter >= 2 * UPD_FREQ):
        loop.answer()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sqn.npz")
        save_state(path, free.state)
        resume, x_saved = (loop.req, loop.b), loop.x.copy()
        after = []
        for _ in range(10):
            loop.answer()
            after.append((loop.req["task"], loop.x.copy()))
        fresh = SQN_free(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ,
                         use_float=True)
        template = FusedTrainer("SQN", SQNConfig.create(
            mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ), grad_fn).init(
            torch.zeros(N_FLAGSHIP, device=dev))
        fresh.adopt_state(load_state(path, template))
    loop2 = FreeLoop(fresh, Xb, Yb, x_saved, STEP, resume=resume)
    same = fresh.niter == 2 * UPD_FREQ
    for task, x in after:
        loop2.answer()
        same &= loop2.req["task"] == task and np.array_equal(loop2.x, x)
    check(same and torch.equal(fresh.state.x, free.state.x)
          and fresh.state.x.device.type == "cuda",
          f"(i) save_state at iteration {2 * UPD_FREQ} (calc_hess_vec "
          "pending), load_state into a fresh SQN_free on the card: the next "
          "10 requests give the uninterrupted run's tasks and bits")
    return out, clf


@contextlib.contextmanager
def epoch_walls():
    """Host wall of every epoch a fused driver runs, synchronized before
    and after (one sync per epoch of 120 steps): each eager epoch and each
    replay of a CUDA graph; a graph's warm-up and capture are not epochs
    of the fit and are not timed."""
    orig, orig_init = FusedTrainer._epoch_at, graphs._Graph.__init__
    orig_replay = graphs._Graph.replay
    walls, building = [], []

    def timed(fn):
        def run(self, *args, **kw):
            if building:
                return fn(self, *args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out
        return run

    def init(self, *args, **kw):
        building.append(self)
        try:
            orig_init(self, *args, **kw)
        finally:
            building.pop()
    FusedTrainer._epoch_at = timed(orig)
    graphs._Graph.__init__, graphs._Graph.replay = init, timed(orig_replay)
    try:
        yield walls
    finally:
        FusedTrainer._epoch_at = orig
        graphs._Graph.__init__, graphs._Graph.replay = orig_init, orig_replay


def front_end_times(dev):
    """(j) The logistic model's fused SQN fit against bare FusedTrainer
    runs of the same 240 steps, in turns, each from a fresh state: phase
    4's (jvp Hessian-vector products, summed loss) and one with the
    model's own functions on data already on the card.  Two rates each:
    the epochs alone (their walls, synchronized at each epoch's ends: the
    per-step cost) and the whole call (host clock around work that ends
    in a synchronize; the model's fit also copies X, 44 MB, to the card
    and draws w0 on the host)."""
    X, Y, _, _ = front_end_data()
    Xd, Yd = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
    np.random.seed(1)
    w0 = torch.from_numpy(np.random.normal(size=N_FLAGSHIP)).to(
        dev, torch.float32)
    cfg = SQNConfig.create(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ)
    wts = torch.full((X.shape[0],), 1.0 / X.shape[0], device=dev)
    model = FusedTrainer(
        "SQN", cfg,
        lambda x, b: losses.multinomial_logistic_grad(x, b[0], b[1], b[2],
                                                      1e-3),
        hess_vec_fn=lambda x, v, b: losses.multinomial_logistic_hessvec(
            x, v, b[0], b[1], b[2], 1e-3))
    phase4 = FusedTrainer("SQN", cfg, grad_fn)
    batched = (Xd.reshape(NUM_BATCHES, BATCH_SIZE, -1),
               Yd.reshape(NUM_BATCHES, BATCH_SIZE, -1))
    runs = {
        "logistic_fit": lambda: StochasticLogisticRegression(
            optimizer="SQN", bfgs_upd_freq=UPD_FREQ, **FE_MODEL_KW).fit(X, Y),
        "bare_model_functions": lambda: model.epochs(
            model.init(w0), batched + (wts.reshape(NUM_BATCHES, -1),),
            FE_MODEL_STEP, nepochs=2, aligned=True),
        "bare_phase4": lambda: phase4.epochs(
            phase4.init(w0), batched, STEP, nepochs=2, aligned=True),
    }
    steps = 2 * NUM_BATCHES
    rates = {k: {"epochs": [], "call": []} for k in runs}
    for name in list(runs) + list(runs)[::-1] + list(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with epoch_walls() as walls:
            runs[name]()
            torch.cuda.synchronize()
        rates[name]["call"].append(steps / (time.perf_counter() - t0))
        rates[name]["epochs"].append(steps / sum(walls))
    med = {k: {w: statistics.median(v[w]) for w in v}
           for k, v in rates.items()}
    for name, r in rates.items():
        print(f"  (j) {name} (2 epochs from a fresh state, in turns): epochs "
              f"{', '.join(f'{v:.1f}' for v in r['epochs'])} iters/s (median"
              f" {med[name]['epochs']:.1f}); whole call "
              f"{', '.join(f'{v:.1f}' for v in r['call'])} (median "
              f"{med[name]['call']:.1f})", flush=True)
    return med


# ---------------------------------------------------------------------------
# Phase 19: the sharded paths.  NCCL refuses two ranks on one GPU, so the
# multi-rank runs use gloo on CUDA tensors, every rank on cuda:0: the
# tensors stay on the card and every sum goes through the host.  Each
# cluster is this script started once per rank (--rank ...), writing its
# results into a temporary directory; a rank that fails fails the phase.
SHARD_DP = 2       # data ranks of (b), (c) and (e)
SHARD_PARAM = 3    # param ranks of (d) and (f): n = 292,083 = 3 x 97,361
# (e): the model's sharded fit against its unsharded fit on the card, in
# float32, in the model's objective (mean log-loss + 0.05 ||coef||^2).
DP_LOGISTIC_RTOL = 1e-5
DP_MODEL_KW = dict(optimizer="SQN", bfgs_upd_freq=UPD_FREQ, reg_param=0.1,
                   **FE_MODEL_KW)
GLOO_LABEL = "gloo on one card, not a multi-GPU figure"


@contextlib.contextmanager
def collective_wall():
    """Host seconds spent inside ``torch.distributed.all_reduce`` (every
    sum of the port goes through it) while the block runs."""
    orig = torch.distributed.all_reduce
    spent = [0.0]

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        spent[0] += time.perf_counter() - t0
        return out
    torch.distributed.all_reduce = timed
    try:
        yield spent
    finally:
        torch.distributed.all_reduce = orig


def log_table(log):
    """A collective log as arrays (labels, payload bytes, group sizes)."""
    return dict(labels=np.array([op.label for op in log]),
                nbytes=np.array([op.payload_bytes for op in log], np.int64),
                groups=np.array([op.group_size for op in log], np.int64))


def timed_epochs(trainer, state, data, turns=3):
    """Single epochs, synchronized: their iters/s and the share of their
    host wall spent in collectives."""
    rates, shares = [], []
    for _ in range(turns):
        torch.cuda.synchronize()
        with collective_wall() as spent:
            t0 = time.perf_counter()
            state, _ = trainer.epochs(state, data, STEP, nepochs=1,
                                      aligned=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rates.append(NUM_BATCHES / wall)
        shares.append(spent[0] / wall)
    return state, dict(iters_per_s=np.array(rates),
                       collective_share=np.array(shares))


def counted(run):
    """``run()`` with every count at 0 (the split route's too) and the
    collectives recorded; returns its value, the counts and the log."""
    from stochqn_tpu_torch.parallel import record_collectives
    torch.cuda.synchronize()
    reset_launches()
    two_loop_mod.SPLIT_ROUTE = 0
    with record_collectives() as log:
        out = run()
    torch.cuda.synchronize()
    counts = dict(read_launches(), split_route=two_loop_mod.SPLIT_ROUTE)
    return out, {k: np.int64(v) for k, v in counts.items()}, log_table(log)


def sqn_cfg():
    return SQNConfig.create(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ)


@contextlib.contextmanager
def nccl_group():
    """A one-rank NCCL process group in this process.  On the way out every
    CUDA graph that holds its kernels must already be unreferenced: they
    are collected before the group is destroyed.  A failure inside leaves
    the process at once: its traceback holds the graphs, and destroying
    the group under them can hang."""
    import tempfile
    import traceback
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "rdv"),
            world_size=1, rank=0)
        try:
            yield
        except BaseException:
            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        gc.collect()
        torch.cuda.synchronize()
        torch.distributed.destroy_process_group()


def graph_against_eager(make, x0, data, step, nepochs=2):
    """``make()``'s eager ``epochs`` and another ``make()``'s ``jit_epochs``
    (its first call captures; the second, the one counted and recorded
    (:func:`counted`), is replays only), from ``x0``.  Returns ``(same,
    state, infos, eager_counts, eager_log, counts, log)``: ``same`` whether
    the replays gave the eager run's bits in every tensor of the state and
    every info code, ``state`` and ``infos`` the replays'."""
    eager, graphed = make(), make()
    (ref, ref_infos), eager_counts, eager_log = counted(
        lambda: eager.epochs(eager.init(x0), data, step, nepochs,
                             aligned=True))
    graphed.jit_epochs()(graphed.init(x0), data, step, nepochs, aligned=True)
    graphs.reset_stats()
    (st, infos), counts, log = counted(
        lambda: graphed.jit_epochs()(graphed.init(x0), data, step, nepochs,
                                     aligned=True))
    same = bool(torch.equal(infos, ref_infos) and same_state(st, ref)
                and graphs.STATS["replays"] == nepochs
                and graphs.STATS["captures"] == 0)
    return (same, st, infos, eager_counts, eager_log, counts, log)


def same_log(a, b):
    """Two :func:`log_table` records hold the same collectives in order."""
    return all(np.array_equal(a[k], b[k]) for k in ("labels", "nbytes",
                                                    "groups"))


def rank_jobs(cluster, rank, ckpt):
    """The jobs of one rank of ``cluster``: ``{job: results}``."""
    from stochqn_tpu_torch.parallel import (gather_state, make_mesh,
                                            shard_batches)
    from stochqn_tpu_torch.utils.checkpoint import (load_sharded,
                                                    save_sharded)
    dev = torch.device("cuda", torch.cuda.current_device())
    X, Y, x0 = bench_data(dev)
    out = {}
    if cluster.startswith("nccl"):
        return nccl_rank_jobs(cluster, X, Y, x0)
    if cluster == "dp":
        mesh = make_mesh(SHARD_DP, 1)
        data = shard_batches((X, Y), mesh)

        # the penalty split over the data ranks: summed, it counts once
        def g(x, b):
            return losses.multinomial_logistic_grad(x, b[0], b[1], None,
                                                    REG / SHARD_DP)

        def f(x, b):
            return losses.multinomial_logistic_loss(x, b[0], b[1], None,
                                                    REG / SHARD_DP)
        tr = FusedTrainer("SQN", sqn_cfg(), g, mesh=mesh)
        (st, infos), counts, log = counted(lambda: tr.epochs(
            tr.init(x0), data, STEP, nepochs=2, aligned=True))
        out["b"] = dict(x=st.x.cpu().numpy(), infos=infos.cpu().numpy(),
                        count=np.int64(int(st.mem.count)), **counts, **log)
        _, times = timed_epochs(tr, st, data)
        out["b"].update(times)
        try:                    # gloo's collectives run on the host
            tr.jit_epochs()
            out["b"]["jit_raised"] = np.array("")
        except RuntimeError as err:
            out["b"]["jit_raised"] = np.array(str(err))

        fvals = []

        def recording_f(x, b):
            v = f(x, b)
            fvals.append(v)     # this rank's share of the guard's f
            return v
        tr = FusedTrainer("adaQN", AdaQNConfig.create(
            **ADAQN_KW, use_pallas=True), g, obj_fn=recording_f, mesh=mesh)
        (st, infos), counts, log = counted(lambda: tr.epochs(
            tr.init(x0), data, ADAQN_STEP, nepochs=2, aligned=True))
        out["c"] = dict(x=st.x.cpu().numpy(), infos=infos.cpu().numpy(),
                        f_local=torch.stack(fvals).cpu().numpy(),
                        count=np.int64(int(st.mem.count)),
                        fisher_count=np.int64(int(st.fisher.count)),
                        **counts, **log)

        Xh, Yh, _, _ = front_end_data()
        clf, counts, log = counted(lambda: StochasticLogisticRegression(
            mesh=mesh, **DP_MODEL_KW).fit(Xh, Yh))
        out["e"] = dict(x=clf.x_, **counts, **log)
        if rank == 0:
            out["e"]["x_plain"] = StochasticLogisticRegression(
                **DP_MODEL_KW).fit(Xh, Yh).x_
    elif cluster == "param":
        mesh = make_mesh(1, SHARD_PARAM)
        data = (X, Y)               # one data rank: every row

        def two_epochs_with_checkpoint():
            state, i1 = tr.epochs(tr.init(x0), data, STEP, nepochs=1,
                                  aligned=True)
            save_sharded(ckpt, state, mesh)          # (f): after epoch 1
            state, i2 = tr.epochs(state, data, STEP, nepochs=1,
                                  aligned=True)
            return state, torch.cat([i1, i2])
        tr = FusedTrainer("SQN", sqn_cfg(), grad_fn, mesh=mesh)
        (st, infos), counts, log = counted(two_epochs_with_checkpoint)
        full = gather_state(st, mesh)
        out["d_sqn"] = dict(x=full.x.cpu().numpy(),
                            infos=infos.cpu().numpy(),
                            count=np.int64(int(st.mem.count)), **counts,
                            **log)
        _, times = timed_epochs(tr, st, data)
        out["d_sqn"].update(times)

        tr = FusedTrainer("oLBFGS", OLBFGSConfig.create(mem_size=MEM_SIZE),
                          grad_fn, mesh=mesh)
        (st, infos), counts, log = counted(lambda: tr.epochs(
            tr.init(x0), data, STEP, nepochs=2, aligned=True))
        out["d_olbfgs"] = dict(x=gather_state(st, mesh).x.cpu().numpy(),
                               infos=infos.cpu().numpy(), **counts, **log)
    else:                           # "resume": fresh ranks load (f)
        mesh = make_mesh(1, SHARD_PARAM)
        tr = FusedTrainer("SQN", sqn_cfg(), grad_fn, mesh=mesh)
        st = load_sharded(ckpt, tr.init(torch.zeros_like(x0)), mesh)
        niter = int(st.niter)
        st, _ = tr.epochs(st, (X, Y), STEP, nepochs=1, aligned=True)
        out["f"] = dict(x=gather_state(st, mesh).x.cpu().numpy(),
                        niter_loaded=np.int64(niter))
    return out


def nccl_rank_jobs(cluster, X, Y, x0):
    """The jobs of one rank of an NCCL cluster, one card per rank: each
    run through ``jit_epochs`` (CUDA graphs holding NCCL's kernels)
    against the same cluster's eager ``epochs``, counted and recorded,
    and SQN's iters/s on the graph and eager in turns."""
    from stochqn_tpu_torch.parallel import gather_state, make_mesh, \
        shard_batches
    n_data = SHARD_DP if cluster == "nccl_dp" else 1
    mesh = make_mesh(n_data, 1 if cluster == "nccl_dp" else SHARD_PARAM)
    data = shard_batches((X, Y), mesh)

    def g(x, b):                # the penalty split over the data ranks
        return losses.multinomial_logistic_grad(x, b[0], b[1], None,
                                                REG / n_data)
    jobs = {"sqn": (lambda: FusedTrainer("SQN", sqn_cfg(), g, mesh=mesh),
                    STEP)}
    if cluster == "nccl_dp":
        jobs["adaqn"] = (lambda: FusedTrainer("adaQN", AdaQNConfig.create(
            **ADAQN_KW, use_pallas=True), g, obj_fn=lambda x, b: (
                losses.multinomial_logistic_loss(x, b[0], b[1], None,
                                                 REG / n_data)),
            mesh=mesh), ADAQN_STEP)
    else:
        jobs["olbfgs"] = (lambda: FusedTrainer("oLBFGS", OLBFGSConfig.create(
            mem_size=MEM_SIZE), g, mesh=mesh), STEP)
    out = {}
    for job, (make, step) in jobs.items():
        same, st, infos, ecounts, elog, counts, log = graph_against_eager(
            make, x0, data, step)
        full = gather_state(st, mesh)
        out[job] = dict(same=np.bool_(same), same_log=np.bool_(
            same_log(log, elog)), x=full.x.cpu().numpy(),
            infos=infos.cpu().numpy(), count=np.int64(int(st.mem.count)),
            **{f"eager_{k}": v for k, v in ecounts.items()}, **counts, **log)
    make, _ = jobs["sqn"]
    eager, graphed = make(), make()
    graphed.jit_epochs()(graphed.init(x0), data, STEP, 1, aligned=True)
    rates = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager", "eager", "graph"):
        tr = eager if name == "eager" else graphed
        run = tr.epochs if name == "eager" else tr.jit_epochs()
        s0 = tr.init(x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(s0, data, STEP, GRAPH_EPOCHS["sqn"], aligned=True)
        torch.cuda.synchronize()
        rates[name].append(GRAPH_EPOCHS["sqn"] * NUM_BATCHES
                           / (time.perf_counter() - t0))
    out["sqn"].update({f"{k}_iters_per_s": np.array(v)
                       for k, v in rates.items()})
    return out


def rank_main(argv):
    """One rank of a phase 19 cluster (``--rank r --world w --cluster c
    --dir d``): joins the group through the rendezvous file in ``d`` and
    writes ``d/<job>.r<rank>.npz``.  An ``nccl_*`` cluster takes one card
    per rank and NCCL; the others share cuda:0 over gloo (NCCL refuses two
    ranks on one GPU)."""
    args = dict(zip(argv[0::2], argv[1::2]))
    rank, world = int(args["--rank"]), int(args["--world"])
    out_dir, cluster = args["--dir"], args["--cluster"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    nccl = cluster.startswith("nccl")
    torch.cuda.set_device(rank if nccl else 0)
    torch.distributed.init_process_group(
        "nccl" if nccl else "gloo",
        init_method="file://" + os.path.join(out_dir, "rendezvous"),
        world_size=world, rank=rank)
    try:
        t0 = time.perf_counter()
        results = rank_jobs(cluster, rank,
                            os.path.join(out_dir, "checkpoint"))
        for arrays in results.values():
            arrays["job_seconds"] = np.float64(time.perf_counter() - t0)
        for job, arrays in results.items():
            np.savez(os.path.join(out_dir, f"{job}.r{rank}.npz"), **arrays)
    except BaseException:
        # the traceback holds the trainers' graphs: leave without
        # destroying the group under them
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    # the trainers (and their graphs) died with rank_jobs' frame
    gc.collect()
    torch.cuda.synchronize()
    torch.distributed.destroy_process_group()
    return 0


def run_cluster(cluster, world, out_dir, timeout=300):
    """Start ``world`` ranks of ``cluster``, wait for all; a rank that
    fails fails the phase with its log.  Returns the wall seconds."""
    t0 = time.perf_counter()
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, "--rank", str(r), "--world", str(world),
         "--cluster", cluster, "--dir", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0] + "\n(killed at the time limit)")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:], flush=True)
            check(False, f"cluster {cluster}: rank {r} exited with "
                  f"{p.returncode}")
    return time.perf_counter() - t0


def load_job(out_dir, job, world):
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"{job}.r{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


def same_x_on_ranks(what, ranks):
    same = all(np.array_equal(ranks[0]["x"], r["x"]) for r in ranks[1:])
    check(same, f"{what}: x bit-identical on all {len(ranks)} ranks")
    return torch.from_numpy(ranks[0]["x"])


def labels_count(rank, label):
    return int(np.sum(rank["labels"] == label))


def one_rank_ips(trainer, state, data):
    """The unsharded trainer's steady epochs in this process (the one-rank
    run timed in turns with the clusters)."""
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.epochs(state, data, STEP, nepochs=1, aligned=True)
        torch.cuda.synchronize()
        rates.append(NUM_BATCHES / (time.perf_counter() - t0))
    return state, rates


def one_rank_mesh(X, Y, x0, chosen, x_phase4):
    """Phase 19 (a), inside a one-rank NCCL group: the (1, 1) mesh's fused
    SQN eager (phase 4's bits, the kernel per step, the recorder's
    budget), then fused SQN, adaQN on ``project_adaqn`` and the logistic
    model through the programs: every replay the eager run's bits, the
    kernel 120 times a replay, the recorder's log on the replays the eager
    log, op for op.  Returns the launches of the paths."""
    from stochqn_tpu_torch.parallel import MeshComm, make_mesh
    steps = 2 * NUM_BATCHES
    mesh = make_mesh(1, 1)
    check(MeshComm(mesh).capturable, "(a) the (1, 1) mesh's groups are "
          "NCCL, whose collectives a CUDA graph can hold")
    tr = FusedTrainer("SQN", sqn_cfg(), grad_fn, mesh=mesh)
    (st, _), counts, log = counted(lambda: tr.epochs(
        tr.init(x0), (X, Y), STEP, nepochs=2, aligned=True))
    launches = int(counts.pop(chosen))
    check(launches == steps and not any(int(v) for v in counts.values()),
          f"(a) mesh (1, 1) on NCCL: {chosen} launched {launches} times for "
          f"{steps} steps, the other kernels {counts}")

    def budget(what, log):
        labels = log["labels"].tolist()
        check(labels.count("grad") == steps
              and labels.count("hvp") == steps // UPD_FREQ
              and len(labels) == steps + steps // UPD_FREQ
              and set(log["nbytes"].tolist()) == {N_FLAGSHIP * 4}
              and set(log["groups"].tolist()) == {1},
              f"(a) {what}: the recorder holds one all-reduce of n * 4 = "
              f"{N_FLAGSHIP * 4} bytes per base step ({labels.count('grad')})"
              f" and per boundary ({labels.count('hvp')}), group size 1, "
              "nothing else")
    budget("eager", log)
    check(torch.equal(st.x, x_phase4),
          "(a) x after 2 epochs: phase 4's bits (a sum over one rank "
          "changes nothing)")
    out = {"mesh_1x1_fused_sqn": launches}

    def on_graph(what, make, step, kernel):
        same, st, _, ecounts, elog, counts, log = graph_against_eager(
            make, x0, (X, Y), step)
        check(same, f"(a) {what} through jit_epochs: 2 replays of a CUDA "
              "graph holding NCCL's kernels give the eager epochs' bits in "
              "every tensor of the state and every info code")
        check(int(counts[kernel]) == steps
              and all(int(counts[k]) == int(ecounts[k]) for k in counts),
              f"(a) {what}: {kernel} counted {int(counts[kernel]) // 2} "
              f"times a replay; every count the eager run's")
        check(same_log(log, elog), f"(a) {what}: the recorder on the "
              f"replays logs the eager run's {len(elog['labels'])} "
              "collectives, op for op")
        return st, log, int(counts[kernel])

    st, log, out["mesh_1x1_graph_fused_sqn"] = on_graph(
        "SQN", lambda: FusedTrainer("SQN", sqn_cfg(), grad_fn, mesh=mesh),
        STEP, chosen)
    budget("the replays", log)
    check(torch.equal(st.x, x_phase4), "(a) SQN on the graph: phase 4's x")
    _, _, out["mesh_1x1_graph_fused_adaqn"] = on_graph(
        "adaQN, use_pallas=True", lambda: FusedTrainer(
            "adaQN", AdaQNConfig.create(**ADAQN_KW, use_pallas=True),
            grad_fn, obj_fn=obj_fn, mesh=mesh), ADAQN_STEP, "project_adaqn")

    Xh, Yh, _, _ = front_end_data()

    def fit():
        return StochasticLogisticRegression(mesh=mesh, **DP_MODEL_KW).fit(
            Xh, Yh)
    graphs.reset_stats()
    clf, counts, _ = counted(fit)
    stats = {k: graphs.STATS[k] for k in ("captures", "replays")}
    replayed = graph_launches("replay_launches")[chosen]
    saved = FusedTrainer.eager_only
    FusedTrainer.eager_only = property(lambda self: True)   # the eager driver
    try:
        clf_eager = fit()
    finally:
        FusedTrainer.eager_only = saved
    check(np.array_equal(clf.x_, clf_eager.x_) and stats["captures"] == 1
          and stats["replays"] == 2 and replayed == steps,
          f"(a) StochasticLogisticRegression(mesh=make_mesh(1, 1)): "
          f"{stats['captures']} graph captured, {stats['replays']} replays, "
          f"{chosen} counted {replayed // 2} times a replay; the eager "
          "driver's bits")
    out["mesh_1x1_graph_logistic_sqn"] = int(counts[chosen])
    return out


def nccl_clusters(full_loss, chosen):
    """Phase 19's NCCL clusters, one card per rank, where the machine has
    the cards: (2, 1) SQN and adaQN, (1, 3) SQN and oLBFGS on the split
    route, each through ``jit_epochs`` against the same cluster's eager
    epochs bit for bit, with (b)-(d)'s gates and budgets.  Returns their
    records, or why they did not run."""
    import tempfile
    cards = torch.cuda.device_count()
    out = {}
    for cluster, world in (("nccl_dp", SHARD_DP), ("nccl_param", SHARD_PARAM)):
        if cards < world:
            print(f"  NCCL cluster {cluster} ({world} ranks, one card each) "
                  f"did not run: this machine has {cards} card(s); the "
                  "multi-card capture is not verified by this run",
                  flush=True)
            out[cluster] = f"not run: {cards} card(s) for {world} ranks"
            continue
        with tempfile.TemporaryDirectory() as tmp:
            wall = run_cluster(cluster, world, tmp)
            jobs = ("sqn", "adaqn") if cluster == "nccl_dp" else (
                "sqn", "olbfgs")
            ranks = {job: load_job(tmp, job, world) for job in jobs}
        rec = {"wall_s": wall}
        steps = 2 * NUM_BATCHES
        for job, rks in ranks.items():
            what = f"NCCL {cluster} {job}"
            x = same_x_on_ranks(what, rks)
            for r, rk in enumerate(rks):
                check(bool(rk["same"]) and bool(rk["same_log"]),
                      f"{what} rank {r}: 2 replays of a CUDA graph holding "
                      "NCCL's kernels give the eager epochs' bits, and the "
                      "recorder the eager log, op for op")
                kernel = {"sqn": chosen, "adaqn": "project_adaqn",
                          "olbfgs": None}[job]
                if cluster == "nccl_param":
                    kernel = None
                want = steps if kernel else 0
                got = int(rk[kernel]) if kernel else sum(
                    int(rk[k]) for k in SYMBOL)
                check(got == want and all(
                    int(rk[k]) == int(rk["eager_" + k]) for k in SYMBOL),
                      f"{what} rank {r}: {kernel or 'no kernel'} counted "
                      f"{got} times on the replays (want {want}), as many "
                      "as eager")
            infos = rks[0]["infos"].ravel().tolist()
            if job == "adaqn":
                hist = {v: infos.count(v) for v in sorted(set(infos))}
                check(hist == JAX_ADAQN_INFOS,
                      f"{what}: info histogram {hist}, the JAX package's")
                rec[job] = {"loss": full_loss(x)}
                print(f"  {what}: loss after 2 epochs {rec[job]['loss']:.4f}"
                      f" (phase 7: JAX {JAX_ADAQN_LOSS['kernel']})",
                      flush=True)
                continue
            check(set(infos) == {200}, f"{what}: every info code 200")
            want = JAX_LOSS_2_EPOCHS if job == "sqn" else \
                JAX_OLBFGS_LOSS["block"]
            loss_gate(what, full_loss(x), want, LOSS_RTOL)
            rec[job] = {"loss": full_loss(x)}
            if job == "sqn":
                labels = rks[0]["labels"].tolist()
                if cluster == "nccl_dp":
                    check(labels.count("grad") == steps
                          and labels.count("hvp") == steps // UPD_FREQ
                          and len(labels) == steps + steps // UPD_FREQ
                          and set(rks[0]["groups"].tolist()) == {world},
                          f"{what}: (b)'s budget on the replays, group "
                          f"size {world}")
                else:
                    check(labels.count("two_loop") == steps
                          and labels.count("guard") == steps,
                          f"{what}: (d)'s split route on the replays, one "
                          "two-loop sum and one guard sum a step")
                rates = {k: rks[0][f"{k}_iters_per_s"].tolist()
                         for k in ("eager", "graph")}
                rec[job]["iters_per_s"] = {
                    k: statistics.median(v) for k, v in rates.items()}
                print(f"  {what}, rank 0, {GRAPH_EPOCHS['sqn']} epochs a "
                      "call in turns: eager " + ", ".join(
                          f"{v:.1f}" for v in rates["eager"]) + "; graph "
                      + ", ".join(f"{v:.1f}" for v in rates["graph"])
                      + " iters/s", flush=True)
        out[cluster] = rec
    return out


def sharded_phase(dev, x_phase4):
    phase("19. sharded paths at BibTeX shape: a (1, 1) NCCL mesh in this "
          "process, eager and on CUDA graphs; NCCL clusters of one card a "
          "rank where the machine has the cards; data-parallel (2, 1) SQN, "
          "adaQN and the logistic model, parameter-sharded (1, 3) SQN and "
          f"oLBFGS, a sharded checkpoint, over {GLOO_LABEL}")
    import tempfile
    t_phase = time.perf_counter()
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(
            torch.as_tensor(x, device=dev), Xf, Yf, None, REG))
    steps = 2 * NUM_BATCHES
    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    out = {"launches": {}}

    # (a) NCCL, one rank, mesh (1, 1), in this process: eager, then on CUDA
    #     graphs that hold NCCL's kernels
    with nccl_group():
        out["launches"].update(one_rank_mesh(X, Y, x0, chosen, x_phase4))
    out["nccl_clusters"] = nccl_clusters(full_loss, chosen)
    trainer = FusedTrainer("SQN", sqn_cfg(), grad_fn)
    one_state, one_rank = one_rank_ips(trainer, trainer.init(x0), (X, Y))

    with tempfile.TemporaryDirectory() as tmp:
        walls = {}
        for cluster, world in (("dp", SHARD_DP), ("param", SHARD_PARAM),
                               ("resume", SHARD_PARAM)):
            walls[cluster] = run_cluster(cluster, world, tmp)
        b = load_job(tmp, "b", SHARD_DP)
        c = load_job(tmp, "c", SHARD_DP)
        e = load_job(tmp, "e", SHARD_DP)
        d_sqn = load_job(tmp, "d_sqn", SHARD_PARAM)
        d_olbfgs = load_job(tmp, "d_olbfgs", SHARD_PARAM)
        f = load_job(tmp, "f", SHARD_PARAM)
    _, turns = one_rank_ips(trainer, one_state, (X, Y))
    one_rank += turns
    print(f"  cluster walls (start-up included): "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in walls.items())}; "
          f"the jobs of rank 0 in them: "
          f"{float(b[0]['job_seconds']):.1f} s, "
          f"{float(d_sqn[0]['job_seconds']):.1f} s, "
          f"{float(f[0]['job_seconds']):.1f} s", flush=True)

    # (b) data-parallel SQN, float32
    xb = same_x_on_ranks("(b) mesh (2, 1) SQN", b)
    for r, rk in enumerate(b):
        check(int(rk[chosen]) == steps and int(rk["split_route"]) == 0
              and sum(int(rk[k]) for k in ("direction", "direction_streamed",
                                           "project", "project_adaqn")
                      if k != chosen) == 0,
              f"(b) rank {r}: {chosen} launched {int(rk[chosen])} times for "
              f"{steps} steps, no other kernel, no split route")
        check(labels_count(rk, "grad") == steps
              and labels_count(rk, "hvp") == steps // UPD_FREQ
              and len(rk["labels"]) == steps + steps // UPD_FREQ
              and set(rk["nbytes"].tolist()) == {N_FLAGSHIP * 4}
              and set(rk["groups"].tolist()) == {SHARD_DP},
              f"(b) rank {r}: (a)'s budget, group size {SHARD_DP}: one "
              "all-reduce of n * 4 bytes per base step and per boundary")
        raised = str(rk["jit_raised"])
        check("gloo" in raised and "epochs()" in raised,
              f"(b) rank {r}: jit_epochs() on the gloo mesh raises, naming "
              f"gloo and the eager drivers: {raised}")
    infos_b = b[0]["infos"].ravel().tolist()
    loss_b = full_loss(xb)
    check(set(infos_b) == {200} and int(b[0]["count"]) == MEM_SIZE,
          f"(b) all {steps} info codes 200, {MEM_SIZE} live pairs")
    loss_gate("(b) mesh (2, 1) SQN", loss_b, JAX_LOSS_2_EPOCHS, LOSS_RTOL)
    out["launches"]["dp_fused_sqn_per_rank"] = int(b[0][chosen])

    # (c) data-parallel adaQN on project_adaqn, float32
    xc = same_x_on_ranks("(c) mesh (2, 1) adaQN", c)
    for r, rk in enumerate(c):
        check(int(rk["project_adaqn"]) == steps,
              f"(c) rank {r}: project_adaqn launched "
              f"{int(rk['project_adaqn'])} times for {steps} steps")
    infos_c = c[0]["infos"].ravel().tolist()
    binfos = infos_c[UPD_FREQ - 1::UPD_FREQ]
    hist = {v: infos_c.count(v) for v in sorted(set(infos_c))}
    check(hist == JAX_ADAQN_INFOS and binfos == JAX_ADAQN_BOUNDARY_INFOS,
          f"(c) info histogram {hist}, boundary codes {binfos}: the JAX "
          "package's")
    f_c = (sum(rk["f_local"].astype(np.float64) for rk in c)).tolist()
    early = max_rel(f_c[:EARLY_BOUNDARIES], JAX_F64_GUARD_F[:EARLY_BOUNDARIES])
    check(early <= EARLY_RTOL,
          f"(c) guard f (the ranks' shares summed) at boundaries "
          f"1-{EARLY_BOUNDARIES} vs the JAX package's float64 run: max rel "
          f"diff {early:.3e} <= {EARLY_RTOL}")
    check(int(c[0]["count"]) == 1 and int(c[0]["fisher_count"]) == 20,
          "(c) one live pair, 20 Fisher rows, as phase 7")
    loss_c = float(losses.multinomial_logistic_loss(
        xc.to(dev), Xf, Yf, None, REG))
    print(f"  (c) loss after 2 epochs {loss_c:.4f} (phase 7's float32 "
          f"kernel route: JAX {JAX_ADAQN_LOSS['kernel']})", flush=True)
    out["launches"]["dp_fused_adaqn_per_rank"] = int(c[0]["project_adaqn"])

    # (d) parameter-sharded SQN and oLBFGS: the split route, no kernel
    xd = same_x_on_ranks("(d) mesh (1, 3) SQN (gathered)", d_sqn)
    kernels = ("direction", "direction_streamed", "project", "project_adaqn")
    for what, ranks, split in (("SQN", d_sqn, steps),
                               ("oLBFGS", d_olbfgs, 0)):
        for r, rk in enumerate(ranks):
            check(not any(int(rk[k]) for k in kernels)
                  and int(rk["split_route"]) == split,
                  f"(d) {what} rank {r}: no kernel launched, the split "
                  f"route taken {int(rk['split_route'])} times (want "
                  f"{split})")
    evals = {"SQN": (steps, steps // UPD_FREQ), "oLBFGS": (2 * steps, 0)}
    for what, ranks in (("SQN", d_sqn), ("oLBFGS", d_olbfgs)):
        rk = ranks[0]
        grads, bounds = evals[what]
        want = {"gather x": grads, "gather x, v": bounds, "grad": grads,
                "hvp": bounds, "two_loop": steps, "guard": steps,
                "commit": bounds if what == "SQN" else steps}
        got = {k: labels_count(rk, k) for k in want}
        small = rk["nbytes"][~np.isin(rk["labels"], [
            "gather x", "gather x, v", "grad", "hvp"])]
        check(got == want and len(rk["labels"]) == sum(want.values())
              and int(small.max()) <= 1024,
              f"(d) {what}: collectives {got} (the CPU tests' budget: per "
              f"gradient one gather of x and one slice sum; per step one "
              f"two-loop sum and one guard sum; per commit one sum), every "
              f"small one <= 1024 bytes (largest {int(small.max())})")
    loss_gate("(d) mesh (1, 3) SQN", full_loss(xd), JAX_LOSS_2_EPOCHS,
              LOSS_RTOL)
    xo = same_x_on_ranks("(d) mesh (1, 3) oLBFGS (gathered)", d_olbfgs)
    loss_gate("(d) mesh (1, 3) oLBFGS", full_loss(xo),
              JAX_OLBFGS_LOSS["block"], LOSS_RTOL)
    check(set(d_sqn[0]["infos"].ravel().tolist()) == {200}
          and set(d_olbfgs[0]["infos"].ravel().tolist()) == {200},
          "(d) every info code 200")

    # (e) the logistic model, data-parallel, reg_param 0.1
    xe = same_x_on_ranks("(e) mesh (2, 1) StochasticLogisticRegression", e)
    Xh, Yh, _, _ = front_end_data()
    Xd, Yd = torch.from_numpy(Xh).to(dev), torch.from_numpy(Yh).to(dev)

    def model_loss_01(x):
        x = torch.as_tensor(x, device=dev, dtype=torch.float32)
        w = torch.full((Xd.shape[0],), 1.0 / Xd.shape[0], device=dev)
        return float(losses.multinomial_logistic_loss(x, Xd, Yd, w, 0.1))
    l_sh, l_plain = model_loss_01(xe), model_loss_01(e[0]["x_plain"])
    rel = abs(l_sh - l_plain) / l_plain
    check(rel <= DP_LOGISTIC_RTOL,
          f"(e) the model's sharded fit {l_sh:.7g} vs its unsharded fit "
          f"{l_plain:.7g} on the card: rel diff {rel:.3e} <= "
          f"{DP_LOGISTIC_RTOL} (the penalty counted once)")
    for r, rk in enumerate(e):
        check(int(rk[chosen]) == steps,
              f"(e) rank {r}: {chosen} launched {int(rk[chosen])} times")
    out["launches"]["dp_logistic_sqn_per_rank"] = int(e[0][chosen])

    # (f) the sharded checkpoint, resumed by fresh ranks
    xf = same_x_on_ranks("(f) resumed from save_sharded", f)
    check(int(f[0]["niter_loaded"]) == NUM_BATCHES
          and torch.equal(xf, xd),
          "(f) save_sharded after epoch 1, load_sharded into 3 fresh ranks, "
          "epoch 2: the uninterrupted run's bits")

    # (g) times, each labelled
    med = {k: float(np.median(v[0]["iters_per_s"]))
           for k, v in (("dp_2x1", b), ("param_1x3", d_sqn))}
    share = {k: float(np.median(v[0]["collective_share"]))
             for k, v in (("dp_2x1", b), ("param_1x3", d_sqn))}
    one = float(statistics.median(one_rank))
    print(f"  (g) SQN iters/s, {GLOO_LABEL}: one rank (this process, before "
          f"and after the clusters) {', '.join(f'{v:.1f}' for v in one_rank)}"
          f" (median {one:.1f}); mesh (2, 1) "
          f"{', '.join(f'{v:.1f}' for v in b[0]['iters_per_s'])} (median "
          f"{med['dp_2x1']:.1f}, host share in collectives "
          f"{share['dp_2x1']:.3f}); mesh (1, 3) "
          f"{', '.join(f'{v:.1f}' for v in d_sqn[0]['iters_per_s'])} (median "
          f"{med['param_1x3']:.1f}, host share in collectives "
          f"{share['param_1x3']:.3f})", flush=True)
    out["times"] = {"label": GLOO_LABEL, "one_rank_iters_per_s": one,
                    "iters_per_s": med, "collective_host_share": share}
    out["param_sharded_launches"] = {
        what: {k: int(ranks[0][k]) for k in kernels + ("split_route",)}
        for what, ranks in (("fused_sqn_1x3", d_sqn),
                            ("fused_olbfgs_1x3", d_olbfgs))}
    print(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def rule_gate(what, loss, want, f32):
    """The bfloat16 rule: ``loss`` within twice the JAX bfloat16 run's
    distance (``want``) to the JAX float32 run (``f32``)."""
    gate = 2 * abs(want - f32)
    check(abs(loss - want) <= gate,
          f"{what}: loss {loss:.4f} vs the JAX package's bfloat16 run "
          f"{want} (CPU): |diff| {abs(loss - want):.4f} <= {gate:.4f}, "
          f"twice its distance to the float32 run {f32} (rel diff to the "
          f"JAX bfloat16 run {abs(loss - want) / want:.3e})")


def bf16_iterate_phase(dev):
    phase("20. a bfloat16 iterate at BibTeX shape: fused SQN on bfloat16 "
          "and float32 data, SQN_free(dtype=torch.bfloat16)")
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    bf16 = torch.bfloat16
    steps = 2 * NUM_BATCHES

    def full_loss(x):
        x = torch.as_tensor(x, device=dev).float()
        return float(losses.multinomial_logistic_loss(x, Xf, Yf, None, REG))

    plain_calls, restore_plain = spy_plain()
    launches = {}
    for name, data in (("bf16_data", (X.to(bf16), Y.to(bf16))),
                       ("f32_data", (X, Y))):
        trainer = sqn_trainer()
        state = trainer.init(x0.to(bf16))
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        state, infos = trainer.epochs(state, data, STEP, nepochs=2,
                                      aligned=True)
        torch.cuda.set_sync_debug_mode(0)
        counts = read_launches()
        launches[name] = counts.pop("direction_streamed")
        check(state.x.dtype == state.x_sum.dtype == state.mem.s.dtype == bf16
              and state.mem.gram.dtype == torch.float32
              and state.x.device.type == "cuda"
              and launches[name] == steps and not any(counts.values())
              and not plain_calls,
              f"fused SQN, bfloat16 x0, {name}: x, x_sum and the pairs "
              "bfloat16 and the Gram float32 on the card, no host sync, "
              f"direction_streamed launched {launches[name]} times for "
              f"{steps} base steps, the others {counts}, no plain version "
              f"({len(plain_calls)} calls)")
        check(set(infos.flatten().tolist()) == {200}
              and int(state.mem.count) == MEM_SIZE,
              f"fused SQN bfloat16 {name}: all codes 200, {MEM_SIZE} live "
              "pairs, as in the JAX package's run")
        rule_gate(f"fused SQN bfloat16 {name}, 2 epochs",
                  full_loss(state.x), JAX_BF16_ITERATE_LOSS,
                  JAX_LOSS_2_EPOCHS)

    opt = SQN_free(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ, dtype=bf16)
    reset_launches()
    loop = FreeLoop(opt, X, Y, x0, STEP, point_dtype=bf16)
    loop.run(NUM_BATCHES)
    torch.cuda.synchronize()
    counts = read_launches()
    launches["free_sqn"] = counts.pop("direction_streamed")
    check(opt.state.x.dtype == bf16 and launches["free_sqn"] == NUM_BATCHES
          and not any(counts.values()) and not plain_calls,
          f"SQN_free(dtype=bfloat16): direction_streamed launched "
          f"{launches['free_sqn']} times for {NUM_BATCHES} steps, the others "
          f"{counts}, no plain version ({len(plain_calls)} calls)")
    check(loop.tasks == expected_sqn_tasks(NUM_BATCHES)
          and set(loop.infos) == {"no_problems_encountered"}
          and int(opt.state.mem.count) == 5
          and loop.x.dtype == np.float32,
          "SQN_free(dtype=bfloat16): the request order and every "
          "iteration_info of the JAX package's run, 5 live pairs, the "
          "iterate written back into a float32 x")
    rule_gate("SQN_free bfloat16, 1 epoch", full_loss(loop.x),
              JAX_FREE_SQN_BF16_LOSS_1_EPOCH, JAX_FREE_SQN_LOSS_1_EPOCH)
    restore_plain()

    # the kernel on the bfloat16-gradient input at the path's shape
    # (bfloat16 pairs of a real commit cache), against its plain version
    # on the same upcast inputs; then timed against the float32-gradient
    # call on the same pairs
    gen = torch.Generator(device=dev).manual_seed(20)
    mem = committed_memory(N_FLAGSHIP, bf16, dev, gen)
    g16 = torch.randn(N_FLAGSHIP, device=dev, generator=gen).to(bf16)
    g32 = g16.float()
    c = mem.c0 + mem.gamma * mem.cg
    args16 = (mem.s, mem.y, g16, c, mem.gamma)
    args32 = (mem.s, mem.y, g32, c, mem.gamma)
    got = tlk.direction_streamed(*args16)
    want = tlk.direction_streamed_ref(*args32)
    same = tlk.direction_streamed(*args32)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)),
          f"direction_streamed on a bfloat16 gradient (n={N_FLAGSHIP}, "
          f"m={MEM_SIZE}, bfloat16 pairs): max_abs_err={max_abs:.3e} within "
          f"rtol={KERNEL_RTOL} atol={KERNEL_ATOL} of the plain version")
    check(bool(torch.equal(got, same)),
          "the bfloat16 gradient gives the float32-gradient call's bits "
          "(the upcast is exact)")
    timing = time_kernel(f"n={N_FLAGSHIP} bfloat16 pairs, bfloat16 gradient",
                         lambda: tlk.direction_streamed(*args16),
                         lambda: tlk.direction_streamed_ref(*args32))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    k32 = [device_ms(lambda: tlk.direction_streamed(*args32), 50),
           device_ms(lambda: tlk.direction_streamed(*args32), 30, flush)]
    k16 = [device_ms(lambda: tlk.direction_streamed(*args16), 50),
           device_ms(lambda: tlk.direction_streamed(*args16), 30, flush)]
    timing.update(f32_grad_ms=k32[0], f32_grad_cold_ms=k32[1],
                  bf16_grad_turn_ms=k16[0], bf16_grad_turn_cold_ms=k16[1])
    print(f"  direction_streamed, bfloat16 pairs, device: bfloat16 gradient "
          f"(upcast included) {k16[0]:.4f} ms warm, {k16[1]:.4f} ms with "
          f"L2 flushed; float32 gradient {k32[0]:.4f} ms warm, "
          f"{k32[1]:.4f} ms with L2 flushed (in turns)", flush=True)
    return dict(launches=launches, max_abs=max_abs, timing=timing)


class Quadratic:
    """f_b(x) = 0.5 (x - c_b)^T A (x - c_b), tests/test_native.py's
    problem, evaluated in numpy for every backend."""

    def __init__(self, n, seed=1234):
        rng = np.random.default_rng(seed)
        q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        self.a = q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T
        self.centers = rng.standard_normal((16, n))
        self.x0 = rng.standard_normal(n)

    def answer(self, opt, req, b):
        task, at = req["task"], req["requested_on"]
        cmean = self.centers.mean(axis=0)
        if task in ("calc_grad", "calc_grad_same_batch"):
            opt.update_gradient(self.a @ (at - self.centers[b % 16]))
        elif task == "calc_grad_big_batch":
            opt.update_gradient(self.a @ (at - cmean))
        elif task == "calc_hess_vec":
            opt.update_hess_vec(self.a @ at[1])
        else:
            d = at - cmean
            opt.update_function(0.5 * d @ self.a @ d)


def native_lockstep(name, make, prob, nsteps=150, step=0.05):
    """``make(**backend)`` in float64 with ``backend="native"`` and with
    the card's ``backend="torch"``, in lockstep."""
    opts = (make(backend="native"), make())
    check(opts[0].device.type == "cpu" and opts[1].device.type == "cuda",
          f"{name}: the native core on the CPU, the torch backend on the "
          "card, both float64")
    xs = [prob.x0.copy() for _ in opts]
    reqs = [o.run_optimizer(x, step) for o, x in zip(opts, xs)]
    b, worst, seen = 0, 0.0, set()
    for it in range(nsteps):
        rn, rt = reqs
        if (rn["task"], rn["info"]) != (rt["task"], rt["info"]) or not (
                np.allclose(xs[0], xs[1], rtol=NATIVE_RTOL,
                            atol=NATIVE_ATOL)):
            check(False, f"{name}: native and card part at call {it}: "
                  f"{rn['task']}/{rn['info']} vs {rt['task']}/{rt['info']}, "
                  f"max |dx| {np.max(np.abs(xs[0] - xs[1])):.3e}")
        worst = max(worst, float(np.max(np.abs(xs[0] - xs[1]))))
        seen.add(rn["task"])
        for o, r in zip(opts, reqs):
            prob.answer(o, r, b)
        if rn["task"] == "calc_grad":
            b += 1
        reqs = [o.run_optimizer(x, step) for o, x in zip(opts, xs)]
    check(True, f"{name}: {nsteps} calls in lockstep, the same tasks "
          f"({sorted(seen)}) and infos, x within rtol={NATIVE_RTOL} "
          f"atol={NATIVE_ATOL} (max |dx| {worst:.3e})")


def native_phase(dev):
    phase("21. the native C++ tier: the three free-mode classes against the "
          "card's torch backend, SQN_free(backend='native') at BibTeX shape")
    from stochqn_tpu_torch import native_backend
    t0 = time.perf_counter()
    path = native_backend.library_path()
    print(f"  native library {os.path.relpath(path)} ready in "
          f"{time.perf_counter() - t0:.2f} s (g++ "
          f"{' '.join(native_backend.NUMERIC_FLAGS)})", flush=True)
    prob = Quadratic(10)
    native_lockstep("oLBFGS_free", lambda **kw: oLBFGS_free(
        mem_size=5, **kw), prob)
    native_lockstep("SQN_free", lambda **kw: SQN_free(
        mem_size=4, bfgs_upd_freq=5, **kw), prob)
    native_lockstep("SQN_free use_grad_diff", lambda **kw: SQN_free(
        mem_size=4, bfgs_upd_freq=5, use_grad_diff=True, **kw), prob)
    native_lockstep("adaQN_free", lambda **kw: adaQN_free(
        mem_size=4, fisher_size=12, bfgs_upd_freq=5, max_incr=1.01, **kw),
        prob)

    # float32 at BibTeX shape: the native core steps on the host,
    # gradients and Hessian-vector products are computed on the card from
    # the numpy points (phase 11's loop), in turns with the card's backend
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    walls = {"native": [], "card": []}
    for turn in ("native", "card", "card", "native"):
        opt = SQN_free(mem_size=MEM_SIZE, bfgs_upd_freq=UPD_FREQ,
                       use_float=True,
                       backend="native" if turn == "native" else "torch")
        reset_launches()
        loop = FreeLoop(opt, X, Y, x0, STEP)
        loop.run(NUM_BATCHES)
        torch.cuda.synchronize()
        counts = read_launches()
        walls[turn].append(statistics.median(loop.call_ms["calc_grad"]))
        if turn == "native" and len(walls["native"]) == 1:
            check(not any(counts.values()),
                  f"SQN_free(backend='native'): no kernel launched {counts}")
            check(loop.tasks == expected_sqn_tasks(NUM_BATCHES)
                  and set(loop.infos) == {"no_problems_encountered"},
                  f"SQN_free(backend='native'), 1 epoch: phase 11's request "
                  f"order ({NUM_BATCHES + 1} calc_grad, 5 calc_hess_vec) and "
                  "every iteration_info")
            loss = float(losses.multinomial_logistic_loss(
                torch.from_numpy(loop.x).to(dev), Xf, Yf, None, REG))
            loss_gate("SQN_free(backend='native'), 1 epoch", loss,
                      JAX_FREE_SQN_LOSS_1_EPOCH, LOSS_RTOL)
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"  run_optimizer answering calc_grad at n={N_FLAGSHIP}, host wall "
          f"median per call, in turns (native, card, card, native): native "
          f"{walls['native'][0]:.4f} / {walls['native'][1]:.4f} ms, card "
          f"{walls['card'][0]:.4f} / {walls['card'][1]:.4f} ms", flush=True)
    return dict(run_optimizer_ms=med, turns=walls)


# ---------------------------------------------------------------------------
# Phase 22: the single-dispatch programs.  FusedTrainer.jit_epochs and the
# others capture an epoch in a CUDA graph and replay it; the eager epochs
# run the same ops one dispatch at a time, so the two must give the same
# bits (the graph reads the same inputs from its own buffers, and the
# cooperative and programmatic dependent launches of the kernels capture
# as they are).  The eager oLBFGS and adaQN loops run 250-650 iters/s, so
# their runs are shorter than SQN's 20 epochs.
GRAPH_EPOCHS = {"sqn": 20, "olbfgs": 4, "adaqn": 2}
TIMED_EPOCHS = {"sqn": 20, "olbfgs": 2, "adaqn": 4}


def graph_vs_eager(what, make, x0, data, step, nepochs, kernel):
    """``make()``'s ``jit_epochs`` against another ``make()``'s eager
    ``epochs`` for ``nepochs`` aligned epochs from ``x0``: every tensor of
    the state and every info code the same bits, the eager run's kernel
    launches equal to those the replays count, and no other launch but
    the graph's warm-up epoch.  Returns the two trainers, the graph's
    state and its record (launches, capture and warm-up seconds, bytes
    copied per replay)."""
    eager, graphed = make(), make()
    torch.cuda.synchronize()
    reset_launches()
    ref, ref_infos = eager.epochs(eager.init(x0), data, step, nepochs,
                                  aligned=True)
    torch.cuda.synchronize()
    eager_counts = read_launches()
    reset_launches()
    graphs.reset_stats()
    s0 = graphed.init(x0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, infos = graphed.jit_epochs()(s0, data, step, nepochs, aligned=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    held = (torch.cuda.memory_allocated() - base) / 2**20
    counts = read_launches()
    replayed = graph_launches("replay_launches")
    warm = graph_launches("warm_launches")
    (g,) = graphed._programs.graphs()
    check(torch.equal(infos, ref_infos) and same_state(st, ref),
          f"{what}: {nepochs} replays of one CUDA graph and {nepochs} eager "
          "epochs give the same bits in every tensor of the state and every "
          "info code")
    want = nepochs * NUM_BATCHES if kernel is not None else 0
    check(replayed == eager_counts and all(
        counts[k] == replayed[k] + warm[k] for k in counts)
          and sum(eager_counts.values()) == want
          and (kernel is None or eager_counts[kernel] == want),
          f"{what}: launches counted for the replays {replayed} = the eager "
          f"run's {eager_counts}; the warm-up epoch's {warm}")
    print(f"  {what}: first call {first_s:.3f} s for {nepochs} epochs: "
          f"warm-up epoch {g.warm_s:.3f} s, capture and instantiate "
          f"{g.capture_s:.3f} s; peak device memory {first_peak:.1f} MiB "
          f"over what was allocated before it, {held:.1f} MiB still held "
          "after it (the graph's buffers and pool, the returned state); the "
          f"graph copies {g.copy_bytes} bytes of its output state back into "
          "its buffers per replay", flush=True)
    rec = dict(launches=counts.get(kernel, 0) if kernel else 0,
               replay_launches=replayed.get(kernel, 0) if kernel else 0,
               warm_s=g.warm_s, capture_s=g.capture_s,
               first_call_s=first_s, first_call_peak_extra_mib=first_peak,
               held_after_first_call_mib=held,
               copy_back_bytes_per_replay=g.copy_bytes,
               captured_launches=g.launches)
    return eager, graphed, st, infos, rec


def graph_times(what, eager, graphed, x0, data, step, nepochs, kernel=None):
    """Host wall of ``nepochs`` aligned epochs each way, eager and graph,
    in turns (eager, graph, graph, eager, eager, graph), each from a
    fresh state, with the peak device memory the call adds; then the
    idle share of a call of one epoch each way (busy time from a profiler
    trace against the wall of the same call without it: a trace of
    thousands of eager steps takes the profiler tens of seconds to
    read) and, for ``kernel``, its launches by name in the trace of the
    graph's call, one replay."""
    runs = {"eager": lambda s: eager.epochs(s, data, step, nepochs,
                                            aligned=True),
            "graph": lambda s: graphed.jit_epochs()(s, data, step, nepochs,
                                                    aligned=True)}
    fresh = {"eager": lambda: eager.init(x0), "graph": lambda: graphed.init(x0)}
    rates = {k: [] for k in runs}
    peak = {k: 0 for k in runs}
    for name in ("eager", "graph", "graph", "eager", "eager", "graph"):
        s = fresh[name]()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = runs[name](s)
        torch.cuda.synchronize()
        rates[name].append(nepochs * NUM_BATCHES / (time.perf_counter() - t0))
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated() - base)
        del out, s
    ips = {k: statistics.median(v) for k, v in rates.items()}
    one = {"eager": lambda s: eager.epochs(s, data, step, 1, aligned=True),
           "graph": lambda s: graphed.jit_epochs()(s, data, step, 1,
                                                   aligned=True)}
    idle, traced, replay = {}, None, None
    for name in runs:
        idle[name], events = traced_call(one[name], fresh[name])
        if name == "graph":
            replay = replay_split(events, kernel)
            traced = replay.get("launches")
    for name in runs:
        print(f"  {what}, {name}: {nepochs} epochs from a fresh state (in "
              f"turns): {', '.join(f'{v:.1f}' for v in rates[name])} "
              f"iters/s; median {ips[name]:.1f}; the call's peak device "
              f"memory {peak[name] / 2**20:.1f} MiB over what was allocated "
              "before it; device idle over a call of one epoch "
              + ("not measured (the trace shows no device time)"
                 if idle[name] is None else f"{100 * idle[name]:.1f}%"),
              flush=True)
    print(f"  {what}: one replay's profiler trace, "
          f"{replay['device_us']:.1f} us of device time; by kernel: "
          + "; ".join(f"{k[:60]} {v:.1f} us"
                      for k, v in replay["by_kernel_us"].items()), flush=True)
    if replay.get("us_per_launch") is not None:
        print(f"  {what}: {SYMBOL[kernel]} inside the replay "
              f"{replay['us_per_launch']:.3f} us a launch, "
              f"{100 * replay['share']:.1f}% of the replay's device time",
              flush=True)
    if kernel is not None:
        if traced:
            check(traced == NUM_BATCHES,
                  f"{what}: the profiler trace of one replay names "
                  f"{SYMBOL[kernel]} {traced} times (want {NUM_BATCHES})")
        else:
            print(f"  {what}: the profiler trace of the replays names no "
                  f"{SYMBOL[kernel]}: not cross-checked", flush=True)
    return dict(iters_per_s=ips, iters_per_s_all=rates, idle_share=idle,
                peak_extra_mib={k: v / 2**20 for k, v in peak.items()},
                traced_kernel_launches=traced, replay_trace=replay)


def traced_call(one, fresh):
    """``one(fresh())`` under the profiler, and again without it: the
    device's idle share over the call (busy time in the trace against the
    wall of the untraced call; None where the trace shows no device time)
    and the trace's ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile
    s = fresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one(s)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in events) / 1e3
    s = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one(s)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (None if busy <= 0 else 1 - busy / wall), events


def replay_split(events, kernel, top=8):
    """From the profiler's ``key_averages()`` of one replay: its device
    time, the ``top`` kernels by device time, NCCL's kernels and the
    copies (device-to-device copies and copy kernels) by name with their
    launches and device time, and for ``kernel`` its launches, its device
    time a launch and its share of the replay."""
    by_name = {e.key: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
               for e in events}
    by_name = {k: v for k, v in by_name.items() if v > 0}
    total = sum(by_name.values())
    counts = {e.key: e.count for e in events}
    out = {"device_us": total, "by_kernel_us": dict(sorted(
        by_name.items(), key=lambda kv: -kv[1])[:top])}
    for part, match in (("nccl", lambda k: "nccl" in k.lower()),
                        ("copies", lambda k: "copy" in k.lower()
                         or "memcpy" in k.lower())):
        # an aten:: op's device time is its kernels', listed apart
        mine = {k: [counts[k], v] for k, v in by_name.items()
                if match(k) and not k.startswith("aten::")}
        out[part] = mine
        out[part + "_us"] = sum(v for _, v in mine.values())
    if kernel is not None:
        mine = [e for e in events if SYMBOL[kernel] in e.key]
        count = sum(e.count for e in mine)
        us = sum(by_name.get(e.key, 0) for e in mine)
        out.update(launches=count, us_per_launch=us / count if count else None,
                   share=us / total if total else None)
    return out


def mesh_graph_times(x0, data, chosen):
    """Phase 22 (f), inside a one-rank NCCL group: fused SQN on the (1, 1)
    mesh through ``jit_epochs`` against its eager epochs
    (:func:`graph_vs_eager`), then the mesh's eager and graph runs and the
    unsharded graph timed in turns from fresh states, each one's idle
    share over a call of one epoch, and from a profiler trace of one
    replay of each graph its device time, NCCL's kernels and the copies
    (the mesh's ``sum_data`` clones are the copies it has over the
    unsharded replay)."""
    from stochqn_tpu_torch.parallel import make_mesh
    mesh = make_mesh(1, 1)
    n = TIMED_EPOCHS["sqn"]
    what = "(f) SQN on the (1, 1) NCCL mesh"
    eager, graphed, _, _, rec = graph_vs_eager(
        what, lambda: FusedTrainer("SQN", sqn_cfg(), grad_fn, mesh=mesh), x0,
        data, STEP, n, chosen)
    plain = sqn_trainer()
    plain.jit_epochs()(plain.init(x0), data, STEP, 1, aligned=True)
    runs = {"mesh eager": (eager, eager.epochs),
            "mesh graph": (graphed, graphed.jit_epochs()),
            "graph": (plain, plain.jit_epochs())}
    rates = {k: [] for k in runs}
    for name in ("mesh eager", "mesh graph", "graph", "graph", "mesh graph",
                 "mesh eager", "mesh eager", "graph", "mesh graph"):
        tr, run = runs[name]
        s0 = tr.init(x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(s0, data, STEP, n, aligned=True)
        torch.cuda.synchronize()
        rates[name].append(n * NUM_BATCHES / (time.perf_counter() - t0))
    ips = {k: statistics.median(v) for k, v in rates.items()}
    idle, split = {}, {}
    for name, (tr, run) in runs.items():
        idle[name], events = traced_call(
            lambda s, run=run: run(s, data, STEP, 1, aligned=True),
            lambda tr=tr: tr.init(x0))
        if name != "mesh eager":
            split[name] = replay_split(events, chosen)
    for name in runs:
        print(f"  {what}: {name}, {n} epochs a call from a fresh state (in "
              f"turns): {', '.join(f'{v:.1f}' for v in rates[name])} "
              f"iters/s, median {ips[name]:.1f}; device idle over a call of "
              "one epoch " + ("not measured (no device time in the trace)"
                              if idle[name] is None
                              else f"{100 * idle[name]:.1f}%"), flush=True)
    for name, rep in split.items():
        total = rep["device_us"] or float("nan")
        print(f"  {what}: one replay of the {name}, {rep['device_us']:.1f} "
              f"us of device time; NCCL's kernels {rep['nccl_us']:.1f} us "
              f"({100 * rep['nccl_us'] / total:.2f}%): "
              + ("none in the trace" if not rep["nccl"] else "; ".join(
                  f"{k[:100]} x{c} {us:.1f} us"
                  for k, (c, us) in rep["nccl"].items()))
              + f"; copies {rep['copies_us']:.1f} us "
              f"({100 * rep['copies_us'] / total:.2f}%): " + "; ".join(
                  f"{k[:100]} x{c} {us:.1f} us"
                  for k, (c, us) in rep["copies"].items())
              + "; the top kernels: " + "; ".join(
                  f"{k[:100]} {us:.1f} us"
                  for k, us in rep["by_kernel_us"].items()), flush=True)
    clones = split["mesh graph"]["copies_us"] - split["graph"]["copies_us"]
    gap = 1 - ips["mesh graph"] / ips["graph"]
    print(f"  {what}: the mesh's graph {100 * gap:.1f}% under the unsharded "
          f"graph's iters/s ({ips['mesh graph']:.1f} against "
          f"{ips['graph']:.1f}), {ips['mesh graph'] / ips['mesh eager']:.2f}x "
          f"its eager rate; its replay's copies exceed the unsharded one's "
          f"by {clones:.1f} us (the sum_data clones, "
          f"{100 * clones / split['mesh graph']['device_us']:.2f}% of the "
          f"replay), its NCCL kernels take "
          f"{split['mesh graph']['nccl_us']:.1f} us", flush=True)
    rec.update(iters_per_s=ips, iters_per_s_all=rates, idle_share=idle,
               replay_trace=split, clones_us=clones,
               graph_gap_to_unsharded=gap)
    return rec


def graphs_phase(dev, front):
    phase("22. single-dispatch programs: jit_epochs / jit_epochs_scheduled as "
          "CUDA graphs at BibTeX shape, against the eager epochs")
    t_phase = time.perf_counter()
    X, Y, x0 = bench_data(dev)
    Xf, Yf = X.reshape(-1, N_FEATURES), Y.reshape(-1, N_CLASSES)
    data = (X, Y)
    x0n = x0.cpu().numpy()          # one numpy x0 for every run

    def full_loss(x):
        return float(losses.multinomial_logistic_loss(
            x, Xf.to(x.dtype), Yf.to(x.dtype), None, REG))
    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    out = {"launches": {}, "runs": {}}
    plain_calls, restore_plain = spy_plain()

    def clock(part):
        print(f"  [{part} at {time.perf_counter() - t_phase:.1f} s]",
              flush=True)

    # (a) SQN flagship
    n = GRAPH_EPOCHS["sqn"]
    eager, graphed, st, _, rec = graph_vs_eager(
        "(a) SQN flagship", sqn_trainer, x0n, data, STEP, n, chosen)
    print(f"  (a) loss after {n} epochs {full_loss(st.x):.4f}", flush=True)
    st2, infos2 = graphed.jit_epochs()(graphed.init(x0n), data, STEP, 2,
                                       aligned=True)
    check(len(graphed._programs.graphs()) == 1
          and set(infos2.flatten().tolist()) == {200},
          "(a) 2 epochs on the cached graph: no new capture, all codes 200")
    loss_gate("(a) SQN on the graph, 2 epochs", full_loss(st2.x),
              JAX_LOSS_2_EPOCHS, LOSS_RTOL)
    rec.update(graph_times("(a) SQN flagship", eager, graphed, x0n, data,
                           STEP, TIMED_EPOCHS["sqn"], chosen))
    out["runs"]["sqn"] = rec
    out["launches"]["graph_fused_sqn"] = rec["launches"]

    # (b) oLBFGS, block and interleaved (shift mode)
    clock("(b)")
    for layout in ("block", "interleaved"):
        def make(layout=layout):
            return FusedTrainer("oLBFGS", OLBFGSConfig.create(
                mem_size=MEM_SIZE, pairs_interleaved=layout == "interleaved"),
                grad_fn)
        what = f"(b) oLBFGS {layout}"
        eager, graphed, st, _, rec = graph_vs_eager(
            what, make, x0n, data, STEP, GRAPH_EPOCHS["olbfgs"], None)
        if layout == "interleaved":
            check(st.mem.shift and rec["copy_back_bytes_per_replay"]
                  >= st.mem.sy.nbytes,
                  f"{what}: shift mode, whose commit builds a new [2m, n] "
                  "buffer each step: the replay copies it back "
                  f"({st.mem.sy.nbytes} bytes of pairs)")
        st2, _ = graphed.jit_epochs()(graphed.init(x0n), data, STEP, 2,
                                      aligned=True)
        loss_gate(f"{what} on the graph, 2 epochs", full_loss(st2.x),
                  JAX_OLBFGS_LOSS[layout], LOSS_RTOL)
        rec.update(graph_times(what, eager, graphed, x0n, data, STEP,
                               TIMED_EPOCHS["olbfgs"]))
        out["runs"][f"olbfgs_{layout}"] = rec

    # (c) adaQN fisher: the kernel route (project_adaqn captured) and the
    clock("(c)")
    # matvec route; float64 against the JAX float64 run
    for route, use_pallas in (("kernel", True), ("matvec", None)):
        def make(use_pallas=use_pallas):
            return FusedTrainer("adaQN", AdaQNConfig.create(
                **ADAQN_KW, use_pallas=use_pallas), grad_fn, obj_fn=obj_fn)
        what = f"(c) adaQN {route} route"
        eager, graphed, st, _, rec = graph_vs_eager(
            what, make, x0n, data, ADAQN_STEP, GRAPH_EPOCHS["adaqn"],
            "project_adaqn" if use_pallas else None)
        if use_pallas:
            out["launches"]["graph_fused_adaqn"] = rec["launches"]
        rec.update(graph_times(what, eager, graphed, x0n, data, ADAQN_STEP,
                               TIMED_EPOCHS["adaqn"],
                               "project_adaqn" if use_pallas else None))
        out["runs"][f"adaqn_{route}"] = rec
    X64, Y64 = X.double(), Y.double()

    def make64():
        return FusedTrainer("adaQN", AdaQNConfig.create(**ADAQN_KW), grad_fn,
                            obj_fn=obj_fn)
    _, _, st, infos, _ = graph_vs_eager(
        "(c) adaQN float64", make64, x0.double(), (X64, Y64), ADAQN_STEP, 2,
        None)
    binfos = infos.flatten().tolist()[UPD_FREQ - 1::UPD_FREQ]
    rel64 = abs(full_loss(st.x) - JAX_F64_LOSS) / JAX_F64_LOSS
    check(binfos == JAX_ADAQN_BOUNDARY_INFOS and rel64 <= F64_RTOL,
          f"(c) adaQN float64 on the graph: boundary codes the JAX "
          f"package's, the loss after 2 epochs {rel64:.3e} from the JAX "
          f"float64 run (<= {F64_RTOL})")

    # (d) the schedule, another step on a cached graph, donate
    clock("(d)")
    rows = NUM_BATCHES * BATCH_SIZE
    rng = np.random.default_rng(2)
    orders = torch.from_numpy(np.stack([rng.permutation(rows)
                                        for _ in range(3)])).to(dev)
    etas = torch.tensor([step_size_sqrt(STEP, e) for e in range(3)],
                        dtype=torch.float32, device=dev)
    eager, graphed = sqn_trainer(), sqn_trainer()
    ref, ref_infos = eager.epochs_scheduled(eager.init(x0n), (Xf, Yf), etas,
                                            orders, BATCH_SIZE, aligned=True)
    reset_launches()
    graphs.reset_stats()
    st, infos = graphed.jit_epochs_scheduled()(
        graphed.init(x0n), (Xf, Yf), etas, orders, BATCH_SIZE, aligned=True)
    torch.cuda.synchronize()
    out["launches"]["graph_fused_sqn_scheduled"] = read_launches()[chosen]
    check(torch.equal(infos, ref_infos) and same_state(st, ref)
          and graphs.STATS["replays"] == 3,
          "(d) jit_epochs_scheduled, 3 epochs in 3 replays (the gather "
          "inside the graph, each epoch's order and step copied in): the "
          "eager epochs_scheduled's bits")
    replayed = graph_launches("replay_launches")[chosen]
    check(replayed == 3 * NUM_BATCHES,
          f"(d) {chosen} counted {replayed} times for the 3 replays, once a "
          "step")
    loss_gate("(d) jit_epochs_scheduled, 3 epochs", full_loss(st.x),
              JAX_SCHEDULED_LOSS, LOSS_RTOL)
    eager, graphed = sqn_trainer(), sqn_trainer()
    fn = graphed.jit_epochs()
    st = fn(graphed.init(x0n), data, STEP, 1, aligned=True)[0]
    before = graphs.copy_tree(st)
    st2, infos = fn(st, data, STEP / 2, 1, aligned=True)
    ref = eager.epochs(eager.init(x0n), data, STEP, 1, aligned=True)[0]
    ref, ref_infos = eager.epochs(ref, data, STEP / 2, 1, aligned=True)
    check(len(graphed._programs.graphs()) == 1 and torch.equal(
        infos, ref_infos) and same_state(st2, ref) and same_state(st, before),
          "(d) a second call at half the step replays the cached graph and "
          "gives the eager bits at that step; donate=False: the state "
          "passed in is unchanged")
    donor = sqn_trainer()
    donor.donate = True
    s0 = donor.init(x0n)
    d1, _ = donor.jit_epochs()(s0, data, STEP, 1, aligned=True)
    (fam,) = donor._programs.families.values()
    copied = fam.copy_in_bytes
    d2, infos = donor.jit_epochs()(d1, data, STEP / 2, 1, aligned=True)
    check(all(a is b for a, b in zip(graphs.flatten(d2)[0], fam.state))
          and fam.copy_in_bytes == copied and torch.equal(infos, ref_infos)
          and same_state(d2, ref),
          "(d) donate=True: the result is the graph's own buffers, passed "
          "back without a copy, with the same bits")
    del fam, d1, d2, s0

    # (e) the front ends on the graph (phase 18)
    clock("(e)")
    for what, key in (("(a) StochasticLogisticRegression SQN fused",
                       "logistic_fused_sqn"),
                      ("(c) guided SQN, fused engine, 2 epochs",
                       "guided_fused_sqn"),
                      ("(d) StochasticLogisticRegression adaQN fused, "
                       "use_pallas=True", "logistic_fused_adaqn"),
                      ("(g) minimize(SQN) from a numpy x0", "minimize_sqn")):
        g = DRIVEN_GRAPHS[what]
        check(g["captures"] >= 1 and g["replays"] == 2,
              f"(e) phase 18 {what}: {g['captures']} CUDA graph captured, "
              f"{g['replays']} replays for its 2 epochs, held to the JAX "
              "loss there")
    fit, bare = (front["iters_per_s"]["logistic_fit"],
                 front["iters_per_s"]["bare_model_functions"])
    print(f"  (e) phase 18 (j), in turns: the model's fit on the graph "
          f"{fit['epochs']:.1f} iters/s over its replays, {fit['call']:.1f} "
          f"the whole fit (a new trainer each fit: warm-up and capture "
          f"included); bare eager FusedTrainer with the model's functions "
          f"{bare['epochs']:.1f} (its epochs) and {bare['call']:.1f} (the "
          "call)", flush=True)

    # (f) SQN on the (1, 1) NCCL mesh: graph against eager in turns, and
    #     beside the unsharded graph
    clock("(f)")
    with nccl_group():
        out["runs"]["sqn_mesh_1x1"] = mesh_graph_times(x0n, data, chosen)
    check(not plain_calls, f"no plain version was called ({len(plain_calls)})")
    restore_plain()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 22 took {out['seconds']:.1f} s", flush=True)
    print("graphs: " + json.dumps(out["runs"]), flush=True)
    return out


# The grouped product against its plain per-group version on the same
# inputs: both sum in float32 in different orders; the largest difference
# over the largest entry.  TF32 products read ~1e-3.
GMM_RTOL = 1e-5
# Grouped-product launches a step and MoE layer on the pytree path with a
# per-batch boundary (each decoder layer recomputed): the gradient 9 row
# products and 3 weight gradients; each minibatch's Hessian-vector product
# at the boundary 30 and 9.
GMM_PER_STEP = {"gradient": 12, "hvp": 39}
# sqn_dsv2lite.graph's tokens a step, experts held, hidden and expert width
GMM_SHAPE = (4096, 8, 2048, 1408)


def gmm_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def grouped_mm_phase(dev):
    """Phase 23 (see the module's docstring); returns its record."""
    from stochqn_tpu_torch import PytreeTrainer, graphs
    from stochqn_tpu_torch.models import deepseek_v2 as ds
    from stochqn_tpu_torch.ops.kernels import grouped_mm as gm
    phase("23. grouped product of the experts vs plain version on the card")
    T, held, H, W = GMM_SHAPE
    cfg = ds.DeepseekV2Config(hidden_size=H, moe_intermediate_size=W,
                              experts_held=held)
    gen = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale
    x = randn(T, H)
    idx, w = ds.route(x, randn(H, cfg.n_routed_experts, scale=H ** -0.5),
                      cfg)
    tok, _, off = ds.dispatch(idx, w, held)
    rows = x.index_select(0, tok)
    bounds = off.tolist()
    live = bounds[-1]
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    print(f"  routing: {rows.shape[0]} assignments, {live} to the {held} "
          f"held experts, rows a held expert {min(sizes)}-{max(sizes)}",
          flush=True)
    check(0 < min(sizes) and max(sizes) <= T,
          "every held expert has rows, none more than the tokens")
    w_up, w_down = randn(held, H, W, scale=H ** -0.5), \
        randn(held, W, H, scale=W ** -0.5)
    hid = randn(rows.shape[0], W)
    record = {"rows": rows.shape[0], "live_rows": live,
              "expert_rows": [min(sizes), max(sizes)]}
    errs = {}
    tlk.GROUPED_MM_LAUNCHES = 0
    errs["rows_up"] = gmm_err(gm.grouped_mm(rows, w_up, off, T),
                              gm._rows_plain(rows, w_up, off))
    errs["rows_down"] = gmm_err(gm.grouped_mm(hid, w_down, off, T),
                                gm._rows_plain(hid, w_down, off))
    check(tlk.GROUPED_MM_LAUNCHES == 2, "one launch a product")
    a, b = rows.clone().requires_grad_(), w_up.clone().requires_grad_()
    dy = randn(rows.shape[0], W)
    dx, dw = torch.autograd.grad(gm.grouped_mm(a, b, off, T), (a, b), dy)
    errs["backward_dx"] = gmm_err(dx, gm._rows_plain(
        dy, w_up.transpose(1, 2), off))
    errs["backward_dw"] = gmm_err(dw, gm._wgrad_plain(rows, dy, off))
    ta, tb = randn(*rows.shape), randn(*w_up.shape, scale=H ** -0.5)
    _, jv = torch.func.jvp(lambda p, q: gm.grouped_mm(p, q, off, T),
                           (rows, w_up), (ta, tb))
    errs["jvp"] = gmm_err(jv, gm._rows_plain(ta, w_up, off)
                          + gm._rows_plain(rows, tb, off))

    def f(mm, p, q):
        return (torch.tanh(mm(p, q)) ** 2).sum()
    hv = torch.func.jvp(lambda p, q: torch.func.grad(
        lambda u, v: f(lambda c, d: gm.grouped_mm(c, d, off, T), u, v),
        argnums=(0, 1))(p, q), (rows, w_up), (ta, tb))[1]
    a, b = rows.clone().requires_grad_(), w_up.clone().requires_grad_()
    ga, gb = torch.autograd.grad(f(lambda c, d: gm._rows_plain(c, d, off),
                                   a, b), (a, b), create_graph=True)
    ha, hb = torch.autograd.grad((ga * ta).sum() + (gb * tb).sum(), (a, b))
    errs["hvp_dx"], errs["hvp_dw"] = gmm_err(hv[0], ha), gmm_err(hv[1], hb)
    del a, b, ga, gb, ha, hb, hv, jv, dx, dw
    for what, err in errs.items():
        check(err <= GMM_RTOL, f"{what}: max |kernel - plain| / max |plain| "
              f"= {err:.3e} <= {GMM_RTOL}")
    record["max_err_over_max"] = errs

    def plain_rows(p, q):       # the per-expert mm loop, bounds on the host
        y = p.new_zeros(p.shape[0], q.shape[2])
        for g in range(held):
            if bounds[g + 1] > bounds[g]:
                torch.mm(p[bounds[g]:bounds[g + 1]], q[g],
                         out=y[bounds[g]:bounds[g + 1]])
        return y

    def plain_wgrad(p, q):
        out = p.new_empty(held, p.shape[1], q.shape[1])
        for g in range(held):
            torch.mm(p[bounds[g]:bounds[g + 1]].T, q[bounds[g]:bounds[g + 1]],
                     out=out[g])
        return out
    flops = 2.0 * live * H * W
    nbytes = 4.0 * (live * (H + W) + held * H * W)
    record["rows_up"] = dict(time_kernel(
        "grouped_mm rows (x W_up)", lambda: gm.grouped_mm(rows, w_up, off, T),
        lambda: plain_rows(rows, w_up)), **bound(nbytes, flops))
    record["wgrad_up"] = dict(time_kernel(
        "grouped_wgrad (x^T dy)", lambda: gm.grouped_wgrad(rows, dy, off),
        lambda: plain_wgrad(rows, dy)), **bound(nbytes, flops))
    for what in ("rows_up", "wgrad_up"):
        r = record[what]
        print(f"  {what}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}): the "
              f"kernel at {100 * r['bound_ms'] / r['ms']:.1f}% of it",
              flush=True)
    del rows, hid, dy, w_up, w_down, x

    # the main path: the pytree trainer's programs on a small DeepSeek-V2
    small = ds.DeepseekV2Config(
        hidden_size=192, num_attention_heads=2, kv_lora_rank=32,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        intermediate_size=256, moe_intermediate_size=160, n_routed_experts=16,
        experts_held=8, num_experts_per_tok=3, num_hidden_layers=3,
        vocab_size=512)
    cpu = torch.Generator().manual_seed(5)
    params = _to(ds.init_params(small, cpu, std=0.05), dev)
    B, L, seq = 4, 2, 256
    tokens = torch.randint(0, small.vocab_size, (B, 1, seq + 1),
                           generator=cpu).to(dev)
    data = (tokens[..., :-1].contiguous(), tokens[..., 1:].contiguous())
    tr = PytreeTrainer("SQN", SQNConfig.create(mem_size=3, bfgs_upd_freq=L,
                                               pairs_bf16=True),
                       lambda p, bt: ds.loss(p, bt, small), params,
                       reduction="mean", donate=True, boundary_per_batch=True)
    state = tr.init()
    first = float(ds.loss(tr.unravel(state.x), (data[0][0], data[1][0]),
                          small))
    reset_launches()
    tlk.GROUPED_MM_LAUNCHES = 0
    graphs.reset_stats()
    state, infos = tr.jit_epochs()(state, data, 0.05, 2)
    torch.cuda.synchronize()
    got = tlk.GROUPED_MM_LAUNCHES
    per_epoch = small.moe_layers * B * sum(GMM_PER_STEP.values())
    last = float(ds.loss(tr.unravel(state.x), (data[0][0], data[1][0]),
                         small))
    codes = set(infos.reshape(-1).tolist())
    record["main_path"] = {"grouped_mm_launches": got,
                           "direction_streamed_launches": tlk.LAUNCHES,
                           "replays": graphs.STATS["replays"],
                           "loss": [first, last], "codes": sorted(codes)}
    print(f"  main path: {record['main_path']}", flush=True)
    check(got == 2 * per_epoch,
          f"the pytree path's 2 epochs (a warm-up epoch and a replay) "
          f"launched the grouped product {got} times: {small.moe_layers} MoE "
          f"layers x {B} steps x {sum(GMM_PER_STEP.values())} an epoch")
    directions = tlk.LAUNCHES + tlk.DIRECTION_LAUNCHES
    check(directions == 2 * B and graphs.STATS["replays"] == 1,
          f"a direction kernel launched once a step ({directions}), one "
          "replay")
    check(bool(torch.isfinite(state.x).all()) and codes <= VALID_INFO
          and last < first,
          f"finite x, valid codes {sorted(codes)}, loss {first:.5f} -> "
          f"{last:.5f}")
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_no_spills(report):
    """ptxas's report of the build (``-Xptxas -v``): every kernel of the
    five sources is in it, and none spills a byte."""
    functions = re.findall(r"Compiling entry function '(\w+)'", report)
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                         report)]
    registers = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    want = {"direction_parked": 2, "direction_one_read": 1,
            "project_partials": 1, "project_reduce": 1, "adaqn_partials": 3,
            "adaqn_reduce": 1, "grouped_mm_rows": 4, "grouped_mm_wgrad": 4}
    found = {stem: sum(stem in f for f in functions) for stem in want}
    check(found == want, f"ptxas reports every kernel: {found}")
    check(len(spills) >= 2 * len(functions)
          and len(registers) == len(functions) and not any(spills),
          f"ptxas: {len(functions)} kernels, {sum(spills)} bytes of spill "
          f"stores and loads, at most {max(registers, default=0)} registers "
          "a thread")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if "--rank" in sys.argv[1:]:        # one rank of a phase 19 cluster
        return rank_main(sys.argv[1:])
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
    nvcc_s, report = tlk.build_log
    print(f"  {path.relative_to(os.path.dirname(os.path.abspath(__file__)))}"
          f" ready in {time.perf_counter() - t0:.2f} s"
          + (" (already built)" if nvcc_s is None
             else f" (nvcc {nvcc_s:.2f} s)"))
    print("  " + report.strip().replace("\n", "\n  "), flush=True)
    check_no_spills(report)

    if "--kernels" in sys.argv[1:]:
        # the kernel phases alone (3, 6, 9, 10, 23): checks and times
        _, timing = kernel_phase(dev)
        _, _, adaqn_timing = adaqn_kernel_phase(dev)
        _, _, project_timing = project_kernel_phase(dev)
        _, direction_timing = direction_kernel_phase(dev)
        grouped = grouped_mm_phase(dev)
        print(json.dumps({"direction_streamed": timing,
                          "project_adaqn": adaqn_timing,
                          "project": project_timing,
                          "direction": direction_timing,
                          "grouped_mm": grouped}))
        print(card)
        return 0

    max_abs, timing = kernel_phase(dev)
    sqn_launches, ips, streamed_ips, x_phase4 = main_path_phase(dev)
    parity_phase(dev)
    adaqn_max_abs, adaqn_share, adaqn_timing = adaqn_kernel_phase(dev)
    adaqn_launches, adaqn_ips = adaqn_main_path_phase(dev)
    adaqn_parity_phase(dev)
    project_max_abs, project_share, project_timing = project_kernel_phase(dev)
    direction_max_abs, direction_timing = direction_kernel_phase(dev)
    free_launches, free_ips, audit_err = free_sqn_phase(dev)
    free_adaqn_launches = free_adaqn_phase(dev)
    olbfgs = olbfgs_phase(dev)
    ilv_launches, ilv_m20_launches, ilv_ips, ilv_m20_ips = \
        sqn_interleaved_phase(dev)
    generic = generic_phase(dev)
    bf16 = bf16_phase(dev)
    drivers = drivers_phase(dev)
    front, _ = front_end_phase(dev)
    front_ips = front_end_times(dev)
    sharded = sharded_phase(dev, x_phase4)
    bf16_iterate = bf16_iterate_phase(dev)
    native = native_phase(dev)
    programs = graphs_phase(dev, {"iters_per_s": front_ips})
    grouped = grouped_mm_phase(dev)

    # launches: the counts of the paths driven above (fused SQN, fused adaQN,
    # free-mode SQN at m = 10 and m = 20, free-mode adaQN, fused SQN
    # interleaved at m = 10 and m = 20, the generic layout, bfloat16 pairs
    # and Fisher rows, the scheduled, shuffled and streamed drivers), each
    # read after a path that began with every count at 0; the oLBFGS paths
    # launch no kernel.  The float32 SQN paths of phases 15 and 17 count
    # under the kernel the gate chose.
    chosen, _ = gate_choice(MEM_SIZE, N_FLAGSHIP, dev)
    sqn_f32_paths = {"fused_sqn_generic": generic["launches"],
                     **{f"fused_sqn_{k}": v
                        for k, v in drivers["launches"].items()}}
    by_path = {
        "direction": {"fused_sqn": sqn_launches.get("direction", 0),
                      "free_sqn": free_launches.get("direction", 0),
                      "fused_sqn_interleaved":
                          ilv_launches.get("direction", 0)},
        "direction_streamed": {
            "fused_sqn": sqn_launches.get("direction_streamed", 0),
            "free_sqn": free_launches.get("direction_streamed", 0),
            "fused_sqn_interleaved":
                ilv_launches.get("direction_streamed", 0),
            "fused_sqn_interleaved_m20": ilv_m20_launches,
            "fused_sqn_bf16": bf16["launches"]["block"],
            "fused_sqn_bf16_interleaved": bf16["launches"]["interleaved"],
            "fused_sqn_bf16_iterate_bf16_data":
                bf16_iterate["launches"]["bf16_data"],
            "fused_sqn_bf16_iterate_f32_data":
                bf16_iterate["launches"]["f32_data"],
            "free_sqn_bf16_iterate": bf16_iterate["launches"]["free_sqn"]},
        "project": {"free_sqn_oracle_audits": free_launches["project"],
                    "free_sqn_m20_oracle_audits":
                        free_launches["project_m20"]},
        "project_adaqn": {"fused_adaqn": adaqn_launches,
                          "free_adaqn": free_adaqn_launches,
                          "fused_adaqn_generic": generic["adaqn_launches"],
                          "fused_adaqn_fisher_bf16": bf16["adaqn_launches"]},
    }
    by_path[chosen].update(sqn_f32_paths)
    fe = front["launches"]
    by_path[chosen].update({k: fe[k] for k in (
        "logistic_fused_sqn", "guided_protocol_sqn", "guided_fused_sqn",
        "logistic_sparse_sqn", "minimize_sqn")})
    by_path["project_adaqn"]["logistic_fused_adaqn"] = \
        fe["logistic_fused_adaqn"]
    # phase 19: (a) in this process; the ranks' counts of (b), (c), (e) per
    # rank (each of the 2 ranks launched as many)
    sl = sharded["launches"]
    by_path[chosen].update({k: sl[k] for k in (
        "mesh_1x1_fused_sqn", "mesh_1x1_graph_fused_sqn",
        "mesh_1x1_graph_logistic_sqn", "dp_fused_sqn_per_rank",
        "dp_logistic_sqn_per_rank")})
    by_path["project_adaqn"].update({k: sl[k] for k in (
        "mesh_1x1_graph_fused_adaqn", "dp_fused_adaqn_per_rank")})
    # phase 22: the replays of the CUDA graphs and their warm-up epochs
    gl = programs["launches"]
    by_path[chosen].update({k: gl[k] for k in (
        "graph_fused_sqn", "graph_fused_sqn_scheduled")})
    by_path["project_adaqn"]["graph_fused_adaqn"] = gl["graph_fused_adaqn"]
    for name, launches in (("fused_sqn_bf16", bf16["launches"]["block"]),
                           ("fused_sqn_bf16_interleaved",
                            bf16["launches"]["interleaved"]),
                           ("fused_adaqn_generic", generic["adaqn_launches"]),
                           ("fused_sqn_bf16_iterate_bf16_data",
                            bf16_iterate["launches"]["bf16_data"]),
                           ("fused_sqn_bf16_iterate_f32_data",
                            bf16_iterate["launches"]["f32_data"]),
                           ("free_sqn_bf16_iterate",
                            bf16_iterate["launches"]["free_sqn"]),
                           ("fused_adaqn_fisher_bf16",
                            bf16["adaqn_launches"])):
        check(launches > 0, f"{name} launched its kernel: {launches}")
    for name, paths in by_path.items():
        check(sum(paths.values()) > 0,
              f"{name} was launched on a driven path: {paths}")
    print(f"  generic vs chunked SQN: {generic['iters_per_s']} iters/s, "
          f"idle {generic['idle_share']}; bf16 vs float32 SQN: "
          f"{bf16['iters_per_s']} iters/s, idle {bf16['idle_share']}, "
          f"collapsed direction {bf16['direction_ms']} ms; paired vs "
          f"sequential oLBFGS: {drivers['paired_iters_per_s']} iters/s, idle "
          f"{drivers['paired_idle_share']}; stream_rounds "
          f"{drivers['stream_iters_per_s']:.1f} iters/s", flush=True)
    print(f"  native tier: run_optimizer at n={N_FLAGSHIP}, host wall "
          f"median {native['run_optimizer_ms']['native']:.4f} ms (C++ core) "
          f"vs {native['run_optimizer_ms']['card']:.4f} ms (the card's "
          "backend)", flush=True)
    print(f"  oLBFGS (no kernel): fused iters/s block "
          f"{olbfgs['iters_per_s']['block']:.1f}, interleaved "
          f"{olbfgs['iters_per_s']['interleaved']:.1f}; oLBFGS_free "
          f"{olbfgs['free_iters_per_s']:.1f}", flush=True)
    fit, bare = front_ips["logistic_fit"], front_ips[
        "bare_model_functions"]
    print(f"  front ends: logistic fused SQN {fit['epochs']:.1f} iters/s in "
          f"its epochs ({fit['call']:.1f} the whole fit), bare FusedTrainer "
          f"{bare['epochs']:.1f} (the model's functions) and "
          f"{front_ips['bare_phase4']['epochs']:.1f} (phase 4's), in "
          f"turns; one protocol request {front['protocol_request_ms']:.4f} "
          f"ms of host wall, run_optimizer {front['protocol_call_ms']:.4f} "
          "ms", flush=True)
    front_end = {"iters_per_s": front_ips,
                 "guided_protocol_request_ms": front["protocol_request_ms"],
                 "guided_protocol_run_optimizer_ms":
                 front["protocol_call_ms"], "losses": front["losses"]}
    f32 = timing["float32"]
    src = "stochqn_tpu_torch/csrc/"
    tpu = "stochqn_tpu/ops/pallas/two_loop_kernel.py:"

    def entry(name, line, max_abs_err, times, bound_keys, **more):
        return {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                "replaces": f"{tpu}{line}",
                "launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name],
                "max_abs_err": max_abs_err, **times, **bound_keys, **more,
                **({"front_end": front_end, "sharded": sharded_record,
                    "graphs": programs["runs"]}
                   if name == chosen else {})}
    # the parameter-sharded paths take the split route: no kernel
    sharded_record = {"param_sharded_paths_launch_none":
                      sharded["param_sharded_launches"],
                      "times": sharded["times"],
                      "nccl_clusters": sharded["nccl_clusters"]}
    print(json.dumps({"kernels": [
        entry("direction_streamed", 309,
              max(max_abs, bf16_iterate["max_abs"]), f32,
              direction_bound(MEM_SIZE, N_FLAGSHIP), bf16=timing["bfloat16"],
              bf16_bound=direction_bound(MEM_SIZE, N_FLAGSHIP, 2),
              bf16_grad=bf16_iterate["timing"],
              bf16_grad_bound=direction_bound(MEM_SIZE, N_FLAGSHIP, 2,
                                              grad_bytes=2),
              native_run_optimizer_ms=native["run_optimizer_ms"],
              m20=timing["m20"], iters_per_s=streamed_ips,
              interleaved_m20_iters_per_s=ilv_m20_ips,
              bf16_iters_per_s=bf16["iters_per_s"]["bf16 block"]),
        entry("project_adaqn", 390, adaqn_max_abs, adaqn_timing,
              project_adaqn_bound(MEM_SIZE, N_FLAGSHIP),
              worst_err_share_of_f64_bound=adaqn_share,
              iters_per_s=adaqn_ips["kernel"],
              plain_route_iters_per_s=adaqn_ips["matvec"]),
        entry("project", 85, project_max_abs, project_timing,
              project_bound(MEM_SIZE, N_FLAGSHIP),
              worst_err_share_of_f64_bound=project_share,
              oracle_vs_cached_direction_max_err_over_max_d=audit_err),
        entry("direction", 196, direction_max_abs, direction_timing or {
            "ms": None, "plain_ms": None, "library_ms": None},
            direction_bound(MEM_SIZE, N_FLAGSHIP),
            iters_per_s=ips if "direction" in sqn_launches else None,
            free_mode_iters_per_s=free_ips,
            interleaved_iters_per_s=ilv_ips["interleaved"],
            block_iters_per_s_in_turns_with_interleaved=ilv_ips["block"]),
    ], "grouped_mm": grouped}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
