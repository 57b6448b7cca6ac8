"""Fused training engine for the three optimizers.

Counterpart of :mod:`stochqn_tpu.fused`.  An oLBFGS epoch is one
:func:`olbfgs_step` per minibatch: two same-batch gradients, the
uncollapsed two-loop direction, guard, update and a pair commit every
step (or, with ``paired_grads``, one batched gradient call per step and
the commit deferred by one step: :func:`_olbfgs_epoch_paired`).  An SQN
or adaQN epoch runs as rounds of ``upd_freq`` (L) branch-free base steps
followed once per round by the boundary:

* SQN: minibatch gradient, collapsed two-loop direction (the hand-written
  direction kernel on CUDA), NaN / magnitude guard, ``x`` / ``x_sum``
  updates; at the boundary a Hessian-vector product (or big-batch
  gradient) on the round's L minibatches and a curvature-gated pair
  commit.
* adaQN: minibatch gradient appended to the Fisher ring, AdaGrad /
  RMSProp rescaling, diagonal-H0 two-loop (the hand-written projection
  kernel on CUDA with ``use_pallas=True``), guard, updates; at the
  boundary the function-value guard on the average, then a pair commit
  with the empirical-Fisher (or big-batch gradient-difference) ``y``.

That round-chunked layout needs ``B % L == 0`` and an epoch that starts
on a round boundary.  Any other epoch takes the generic per-step layout
(:meth:`FusedTrainer._epoch_generic`): the boundary runs after every step
that ends a round, on the cyclic window of the last L minibatches.  When
``B % L != 0`` that window can wrap into batches this epoch has not
consumed yet, the shortcut the reference's ``_get_long_batch`` takes
(``stochqn/_optimizers.py:66-69``) and the JAX package keeps.

``lax.scan`` becomes a Python loop, and the JAX package's ``lax.cond`` on
``niter % upd_freq`` a host branch on an iteration count the driver keeps
on the host: the count is read from the state at most once per call
(``aligned=None`` or ``False``; ``aligned=True`` asserts a round boundary
and reads nothing) and then advanced by one per step.  Every
accept/reject, flush and first-round decision is a device-side
``torch.where``, so nothing inside an epoch waits for the device.

The state is updated in place where that saves copying the pair memory:
a commit rewrites one ring row pair of ``mem.s`` / ``mem.y`` (or of an
interleaved ring-mode ``mem.sy``; ``ops.pairs.commit_pair``), and a
ring-mode Fisher append one row of ``fisher.f``.  A state passed to an
eager driver (:meth:`FusedTrainer.round`, :meth:`~FusedTrainer.epoch`,
:meth:`~FusedTrainer.epochs`, :meth:`~FusedTrainer.epochs_scheduled`) is
therefore consumed, as the JAX package's with ``donate=True``; use the
returned one.  These have no JAX counterpart of their own: the JAX
package jits ``epoch``.

The JAX package's single-dispatch programs, :meth:`~FusedTrainer.
jit_epoch`, :meth:`~FusedTrainer.jit_epochs` and
:meth:`~FusedTrainer.jit_epochs_scheduled` (and
:meth:`~FusedTrainer.run_epochs` on top of ``jit_epoch``), return
callables with the JAX signatures.  On the card they capture the epoch in
a CUDA graph and replay it (:mod:`stochqn_tpu_torch.graphs`); on the CPU
they run the eager loop.  They follow ``FusedTrainer.donate``: by default
the state passed in stays readable and unchanged, as the JAX package's
without donation; with ``donate=True`` it is consumed and the result may
share its buffers with the program.

Batches are tensors or (nested) tuples, lists or dicts of tensors with a
leading example axis, and epoch data has leaves ``[B, bs, ...]``.

``FusedTrainer(mesh=...)`` runs the same steps on a
``(data, param)`` ``DeviceMesh`` (:mod:`stochqn_tpu_torch.parallel`),
one process per rank: the user's functions run on this rank's rows and
are summed over the data axis (``reduction`` says how), and on a sharded
param axis the state holds this rank's slice of every parameter-axis
field and the ops sum their n-contractions over that axis.  GSPMD
partitions a global ``grad_fn`` by itself; here the trainer has to be
told how the ranks' results combine.  With no mesh nothing of this runs.
On a CUDA mesh whose groups are NCCL the programs capture the sharded
epoch, its collectives included, in CUDA graphs as they capture an
unsharded one; on a CUDA mesh over gloo, whose collectives run on the
host, only the eager drivers run (:attr:`FusedTrainer.eager_only`).
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Callable, Optional, Tuple

import torch

from stochqn_tpu_torch.core import adaqn, olbfgs, sqn
from stochqn_tpu_torch.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu_torch.core.enums import Info
from stochqn_tpu_torch.core.protocol import (cast_scalar, commit_info,
                                             no_bad, resolve_device,
                                             scalar_like, step_info)
from stochqn_tpu_torch.core.state import AdaQNState, OLBFGSState, SQNState
from stochqn_tpu_torch import graphs
from stochqn_tpu_torch.graphs import EpochPrograms, copy_tree
from stochqn_tpu_torch.models.losses import hvp_from_grad
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         fisher_y)
from stochqn_tpu_torch.parallel.evaluate import (data_parallel_grad,
                                                 data_parallel_hvp,
                                                 data_parallel_value)
from stochqn_tpu_torch.parallel.mesh import (MeshComm, shard_batches,
                                             shard_state)
from stochqn_tpu_torch.utils.metrics import host_read, label

Batch = Any
GradFn = Callable[[torch.Tensor, Batch], torch.Tensor]
ObjFn = Callable[[torch.Tensor, Batch], torch.Tensor]
# Optional analytic Hessian-vector product ``hess_vec_fn(x, v, batch) -> [n]``
# (the reference's ``hess_vec_fun``, ``src/stochqn.c:1105-1111``); without
# one the engine uses ``torch.func.jvp`` of ``grad_fn``.
HessVecFn = Callable[[torch.Tensor, torch.Tensor, Batch], torch.Tensor]

_FINC = int(Info.FUNC_INCREASED)


def step_like(step_size, x: torch.Tensor) -> torch.Tensor:
    """The step size as a tensor of the iterate's dtype on its device
    (:func:`~stochqn_tpu_torch.core.protocol.scalar_like`).  A float32 or
    float64 step tensor or array with a bfloat16 iterate raises a
    ``TypeError``: the JAX package's epoch refuses that input (its step
    would turn the bfloat16 iterate float32); a number (Python or numpy
    scalar) or a bfloat16 step is taken."""
    dt = getattr(step_size, "dtype", None)
    if (x.dtype == torch.bfloat16 and not isinstance(step_size, numbers.Real)
            and str(dt).removeprefix("torch.") in ("float32", "float64")):
        raise TypeError(
            f"a {dt} step size with a {x.dtype} iterate: pass a Python "
            "float or a bfloat16 step")
    return scalar_like(step_size, x)


def _tree_map(fn, batch, *more):
    """``fn`` over the leaves of a (nested) tuple, list or dict, or zipped
    over the leaves of several batches of one structure."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, *parts)
                           for parts in zip(batch, *more))
    if isinstance(batch, dict):
        return type(batch)((k, _tree_map(fn, batch[k], *(b[k] for b in more)))
                           for k in batch)
    return fn(batch, *more)


def _first_leaf(batch) -> torch.Tensor:
    if isinstance(batch, torch.Tensor):
        return batch
    return _first_leaf(next(iter(batch.values())) if isinstance(batch, dict)
                       else batch[0])


def _flat(batch):
    """Merge a ``[k, bs, ...]`` stack of minibatches into one big batch,
    example axis major (``[k, bs] -> [bs, k] -> [bs*k]``), the JAX
    package's order, so the big-batch sums run over the same rows in the
    same order."""
    def merge(a):
        a = a.transpose(0, 1)
        return a.reshape((-1,) + tuple(a.shape[2:]))
    return _tree_map(merge, batch)


def _batch_at(data, i: int):
    return _tree_map(lambda a: a[i], data)


def _cyclic_window(data, i: int, window: int, num_batches: int):
    """The last ``window`` minibatches ending at batch ``i`` (inclusive),
    cyclic, merged as :func:`_flat` merges: the JAX package's take of rows
    ``(i + 1 - window + arange(window)) mod B``.  ``i`` is a host int, so
    the window is one slice, or two where it wraps, and no index tensor
    is made."""
    start = i + 1 - window

    def take(a):
        if start >= 0:
            return a[start:i + 1]
        return torch.cat([a[start % num_batches:], a[:i + 1]])
    return _flat(_tree_map(take, data))


def olbfgs_step(cfg: OLBFGSConfig, grad_fn: GradFn, state: OLBFGSState,
                batch: Batch, step_size: torch.Tensor, comm=None
                ) -> Tuple[OLBFGSState, torch.Tensor]:
    """One full oLBFGS iteration: protocol sections 1 and 2 of
    ``run_oLBFGS`` (``src/stochqn.c:991-1031``) with two same-batch
    gradients.  Returns ``(state, info)``; nothing is read on the host.

    After a bad direction (memory flushed, ``x`` kept) the commit is
    vetoed.  ``grad_prev`` and ``s_pending`` are dead across fused steps
    (the pair is built within the step) and stay as they came in, as in
    the JAX package."""
    g = grad_fn(state.x, batch)
    st, bad = olbfgs.step(cfg, state, g, step_size, comm)
    g2 = grad_fn(st.x, batch)              # same batch, new x
    mem, accepted = commit_pair(st.mem, g2 - g, cfg.min_curvature, cfg.y_reg,
                                enabled=torch.logical_not(bad), comm=comm)
    st = st.replace(mem=mem.replace(s_pending=state.mem.s_pending),
                    section=torch.ones_like(state.section))
    return st, commit_info(accepted | bad, step_info(bad))


def _olbfgs_epoch_paired(cfg: OLBFGSConfig, grad_fn: GradFn,
                         state: OLBFGSState, data, step_size: torch.Tensor,
                         comm=None, pair_grads=None
                         ) -> Tuple[OLBFGSState, torch.Tensor]:
    """An oLBFGS epoch with ONE batched gradient call per step instead of
    two (``FusedTrainer(paired_grads=True)``; the JAX package's
    ``_olbfgs_epoch_paired``).

    Step ``k``'s second gradient ``grad(x_{k+1}, b_k)`` and step ``k+1``'s
    first ``grad(x_{k+1}, b_{k+1})`` share their point, so one
    ``torch.func.vmap(grad_fn, in_dims=(None, 0))`` over the stacked
    ``[2, bs, ...]`` pair of batches gives both.  Pair ``k`` is therefore
    committed at the start of step ``k + 1``, before its direction (where
    the sequential step has it too); the first step's commit is vetoed,
    as is any after a bad direction, and the epoch ends with one plain
    gradient that commits the last pending pair.  ``x``, the memory, the
    info codes and ``niter`` come out as :func:`olbfgs_step`'s, to the
    rounding of the batched gradient; ``s_pending`` is the last candidate
    (the sequential step leaves it as it came in).  ``pair_grads`` (the
    trainer's, on a mesh) replaces the ``vmap`` of ``grad_fn``."""
    num_batches = _first_leaf(data).shape[0]
    # [B, 2, bs, ...]: row k pairs batch k-1 (the pending commit's) with k
    paired = _tree_map(
        lambda a: torch.stack([torch.roll(a, 1, dims=0), a], dim=1), data)
    if pair_grads is None:
        pair_grads = torch.func.vmap(grad_fn, in_dims=(None, 0))
    pend_g = torch.zeros_like(state.x)
    pend_ok = no_bad(state.x)
    bads, accs = [], []
    for k in range(num_batches):
        g_pair = pair_grads(state.x, _batch_at(paired, k))
        mem, acc = commit_pair(state.mem, g_pair[0] - pend_g,
                               cfg.min_curvature, cfg.y_reg, enabled=pend_ok,
                               comm=comm)
        state, bad = olbfgs.step(cfg, state.replace(mem=mem), g_pair[1],
                                 step_size, comm)
        state = state.replace(section=torch.ones_like(state.section))
        pend_g, pend_ok = g_pair[1], torch.logical_not(bad)
        bads.append(bad)
        accs.append(acc)
    g2_last = grad_fn(state.x, _batch_at(data, num_batches - 1))
    mem, acc = commit_pair(state.mem, g2_last - pend_g, cfg.min_curvature,
                           cfg.y_reg, enabled=pend_ok, comm=comm)
    accs = torch.stack(accs[1:] + [acc])
    bads = torch.stack(bads)
    return (state.replace(mem=mem),
            commit_info(accs | bads, step_info(bads)))


def _sqn_base(cfg: SQNConfig, grad_fn: GradFn, state: SQNState,
              batch: Batch, step_size: torch.Tensor, comm=None
              ) -> Tuple[SQNState, torch.Tensor]:
    """The minibatch gradient (labelled ``gradient`` in a captured epoch)
    and :func:`core.sqn.step` on it."""
    with label("gradient"):
        g = grad_fn(state.x, batch)
    return sqn.step(cfg, state, g, step_size, comm)


def _sqn_boundary(cfg: SQNConfig, grad_fn: GradFn, state: SQNState,
                  big: Batch, bad: torch.Tensor,
                  hess_vec_fn: Optional[HessVecFn] = None, comm=None
                  ) -> Tuple[SQNState, torch.Tensor]:
    """The every-``upd_freq`` correction-pair work
    (``src/stochqn.c:1078-1141``), on the already assembled big batch.
    Call exactly when ``niter % upd_freq == 0``.

    Branch-free like the JAX package: the first boundary still evaluates
    the Hessian-vector product and the commit on a meaningless ``s``, and
    vetoes the commit with ``enabled = not first``."""
    st = state
    x_avg = st.x_sum * cast_scalar(1.0 / cfg.upd_freq, st.x.dtype)
    is_first = st.niter == cfg.upd_freq
    not_first = torch.logical_not(is_first)

    s_cand = x_avg - st.x_avg_prev      # garbage on the first round; vetoed
    mem_p = st.mem.replace(s_pending=s_cand)
    if cfg.use_grad_diff:
        gb = grad_fn(x_avg, big)        # first round: at the archived average
        mem2, acc = commit_pair(mem_p, gb - st.grad_prev, cfg.min_curvature,
                                cfg.y_reg, enabled=not_first,
                                direction_cache=True, comm=comm)
        keep = is_first | acc
        st = st.replace(mem=mem2,
                        grad_prev=torch.where(keep, gb, st.grad_prev),
                        x_avg_prev=torch.where(keep, x_avg, st.x_avg_prev),
                        x_sum=torch.zeros_like(st.x_sum))
    else:
        if hess_vec_fn is not None:
            hv = hess_vec_fn(x_avg, s_cand, big)
        else:
            hv = hvp_from_grad(grad_fn)(x_avg, s_cand, big)
        mem2, acc = commit_pair(mem_p, hv, cfg.min_curvature, y_reg=0.0,
                                enabled=not_first, direction_cache=True,
                                comm=comm)
        # archive happens on first AND (accept or reject) later rounds
        st = st.replace(mem=mem2, x_avg_prev=x_avg,
                        x_sum=torch.zeros_like(st.x_sum))
    info = step_info(bad)
    return st, torch.where(is_first, info, commit_info(acc, info))


def _adaqn_base(cfg: AdaQNConfig, grad_fn: GradFn, state: AdaQNState,
                batch: Batch, step_size: torch.Tensor, comm=None
                ) -> Tuple[AdaQNState, torch.Tensor]:
    """The minibatch gradient and :func:`core.adaqn.step` on it."""
    return adaqn.step(cfg, state, grad_fn(state.x, batch), step_size, comm)


def _adaqn_boundary(cfg: AdaQNConfig, grad_fn: GradFn,
                    obj_fn: Optional[ObjFn], state: AdaQNState, big: Batch,
                    fval_batch: Batch, bad: torch.Tensor, comm=None
                    ) -> Tuple[AdaQNState, torch.Tensor]:
    """The every-``upd_freq`` adaQN work: function-value guard and pair
    commit (``src/stochqn.c:1201-1308``).  Call exactly when
    ``niter % upd_freq == 0``.

    Branch-free like :func:`_sqn_boundary`: the first archive, the
    ``func_increased`` rejection and the commit are device-side selects
    and a vetoed commit.  Reference quirks kept: on a rejection ``x_sum``
    keeps ``x_avg`` (``src/stochqn.c:1275-1283``), and with
    ``use_grad_diff`` ``x_avg_prev`` is refreshed only on the first
    archive (``src/stochqn.c:1265-1270``)."""
    st = state
    x_avg = st.x_sum * cast_scalar(1.0 / cfg.upd_freq, st.x.dtype)
    is_first = st.niter == cfg.upd_freq
    not_first = torch.logical_not(is_first)
    base_info = step_info(bad)

    # function-value guard (src/stochqn.c:1272-1291)
    if cfg.max_incr > 0:
        f = torch.as_tensor(obj_fn(x_avg, fval_batch), dtype=st.x.dtype,
                            device=st.x.device)
        reject = not_first & ((f > cast_scalar(cfg.max_incr, f.dtype)
                                    * st.f_prev)
                              | torch.logical_not(torch.isfinite(f)))
        # accept (or first): record f; reject: keep f_prev
        st = st.replace(f_prev=torch.where(reject, st.f_prev, f))
    else:
        reject = no_bad(x_avg)

    commit_ok = not_first & torch.logical_not(reject)
    s_cand = x_avg - st.x_avg_prev      # garbage on the first round; vetoed
    mem_p = st.mem.replace(s_pending=s_cand)
    if cfg.use_grad_diff:
        gb = grad_fn(x_avg, big)
        mem2, acc = commit_pair(mem_p, gb - st.grad_prev, cfg.min_curvature,
                                cfg.y_reg, enabled=commit_ok, comm=comm)
        st = st.replace(
            mem=mem2,
            grad_prev=torch.where(is_first | acc, gb, st.grad_prev),
            x_avg_prev=torch.where(is_first, x_avg, st.x_avg_prev))
    else:
        mem2, acc = commit_pair(mem_p, fisher_y(st.fisher, s_cand, comm),
                                cfg.min_curvature, y_reg=0.0,
                                enabled=commit_ok, comm=comm)
        st = st.replace(
            mem=mem2,
            x_avg_prev=torch.where(is_first | acc, x_avg, st.x_avg_prev))

    # rejection: flush both memories, revert x (src/stochqn.c:1275-1283)
    zero = torch.zeros_like(st.fisher.head)
    st = st.replace(
        mem=conditional_flush(st.mem, reject),
        fisher=st.fisher.replace(
            head=torch.where(reject, zero, st.fisher.head),
            count=torch.where(reject, zero, st.fisher.count)),
        x=torch.where(reject, st.x_avg_prev, st.x),
        x_sum=torch.where(reject, x_avg, torch.zeros_like(st.x_sum)))
    info = torch.where(reject, _FINC, commit_info(is_first | acc, base_info))
    return st, info.to(torch.int32)


def sqn_step(cfg: SQNConfig, grad_fn: GradFn, state: SQNState, batch: Batch,
             big_batch_thunk: Callable[[], Batch], step_size: torch.Tensor,
             boundary: bool, hess_vec_fn: Optional[HessVecFn] = None,
             comm=None) -> Tuple[SQNState, torch.Tensor]:
    """One SQN iteration of the generic layout.  ``boundary`` is the JAX
    package's ``lax.cond`` predicate ``niter % upd_freq == 0`` after this
    step, decided by the caller on its host count of iterations (never
    read from ``state.niter``)."""
    state, bad = _sqn_base(cfg, grad_fn, state, batch, step_size, comm)
    if not boundary:
        with label("infos"):
            return state, step_info(bad)
    with label("boundary"):
        return _sqn_boundary(cfg, grad_fn, state, big_batch_thunk(), bad,
                             hess_vec_fn, comm)


def adaqn_step(cfg: AdaQNConfig, grad_fn: GradFn, obj_fn: Optional[ObjFn],
               state: AdaQNState, batch: Batch,
               big_batch_thunk: Callable[[], Batch],
               fval_batch_thunk: Callable[[], Batch], step_size: torch.Tensor,
               boundary: bool, comm=None) -> Tuple[AdaQNState, torch.Tensor]:
    """One adaQN iteration of the generic layout; ``boundary`` as in
    :func:`sqn_step`."""
    if cfg.max_incr > 0 and obj_fn is None:
        raise ValueError("adaQN with max_incr needs an objective function")
    state, bad = _adaqn_base(cfg, grad_fn, state, batch, step_size, comm)
    if not boundary:
        return state, step_info(bad)
    return _adaqn_boundary(cfg, grad_fn, obj_fn, state, big_batch_thunk(),
                           fval_batch_thunk(), bad, comm)


@dataclasses.dataclass
class FusedTrainer:
    """Fused trainer for any of the three optimizers.

    Args:
      optimizer: "oLBFGS", "SQN" or "adaQN".
      cfg: the matching :class:`OLBFGSConfig`, :class:`SQNConfig` or
        :class:`AdaQNConfig`.
      grad_fn: ``grad_fn(x, batch) -> [n]``.
      obj_fn: ``obj_fn(x, batch) -> scalar`` tensor; required for adaQN
        with ``max_incr``.
      val_data: optional validation batch (tensors on the state's device)
        for adaQN's function-value guard; otherwise the round's big batch
        is used, as in the reference.
      hess_vec_fn: optional ``hess_vec_fn(x, v, big_batch) -> [n]`` used by
        SQN's boundary in place of ``torch.func.jvp`` of ``grad_fn``;
        ignored for adaQN and with ``cfg.use_grad_diff``.
      paired_grads: oLBFGS only: one batched gradient call per step
        (:func:`_olbfgs_epoch_paired`) instead of two.  The same steps;
        off by default, as in the JAX package (PERF.md has its times).
      mesh: a ``(data, param)`` ``DeviceMesh``
        (:func:`stochqn_tpu_torch.parallel.make_mesh`) for a sharded run,
        one process per rank.  :meth:`init` then returns this rank's part
        of the state (:func:`~stochqn_tpu_torch.parallel.shard_state`);
        :meth:`round`, :meth:`epoch` and :meth:`epochs` take this rank's
        rows of each batch (:func:`~stochqn_tpu_torch.parallel.
        shard_batches`), while :meth:`epochs_scheduled` and
        :meth:`run_epochs`, which gather rows themselves, take the full
        data and take the rank's rows after each gather.  The functions see
        the full ``x`` and this rank's rows; ``val_data`` is the full
        validation batch on every rank.
      reduction: how the ranks' results of ``grad_fn``, ``hess_vec_fn``
        and a big-batch ``obj_fn`` combine over the data axis: ``"sum"``
        (functions that sum over their rows, nothing outside the sum) or
        ``"mean"`` (functions that average over their rows, everything
        inside the mean); see :mod:`stochqn_tpu_torch.parallel.evaluate`.
      donate: whether the programs of :meth:`jit_epoch`,
        :meth:`jit_epochs`, :meth:`jit_epochs_scheduled` and
        :meth:`run_epochs` consume the state passed in, as the JAX
        package's field.  Off (the default): that state stays readable and
        unchanged, and each call returns a state of its own (on the card a
        copy of the graph's buffers; on the CPU the eager loop runs on a
        copy).  On: the state passed in is consumed, and on the card the
        returned state is the graph's own buffers, which the next call
        takes without a copy and overwrites.

    On an NCCL mesh the trainer's CUDA graphs hold NCCL kernels: drop the
    trainer and run ``gc.collect()`` before ``torch.distributed.
    destroy_process_group()``, which can hang under a live graph.
    """

    optimizer: str
    cfg: Any
    grad_fn: GradFn
    obj_fn: Optional[ObjFn] = None
    val_data: Optional[Batch] = None
    hess_vec_fn: Optional[HessVecFn] = None
    paired_grads: bool = False
    mesh: Any = None
    reduction: str = "sum"
    donate: bool = False

    # the CUDA graphs and the cached jit_* callables (the JAX package's
    # _epoch_jit and the others)
    _programs: Any = dataclasses.field(default=None, init=False, repr=False,
                                       compare=False)
    _epoch_jit: Any = dataclasses.field(default=None, init=False, repr=False,
                                        compare=False)
    _epochs_jit: Any = dataclasses.field(default=None, init=False,
                                         repr=False, compare=False)
    _epochs_sched_jit: Any = dataclasses.field(default=None, init=False,
                                               repr=False, compare=False)

    def __post_init__(self):
        kind = self.optimizer
        cfg_cls = {"oLBFGS": OLBFGSConfig, "SQN": SQNConfig,
                   "adaQN": AdaQNConfig}.get(kind)
        if cfg_cls is None:
            raise ValueError(f"unknown optimizer {kind!r}")
        if not isinstance(self.cfg, cfg_cls):
            raise TypeError(f"{kind} needs an {cfg_cls.__name__}, got "
                            f"{type(self.cfg)}")
        if kind == "adaQN" and self.cfg.max_incr > 0 and self.obj_fn is None:
            raise ValueError(
                "adaQN with max_incr needs an objective function "
                "(pass obj_fn=..., or max_incr=None to disable the "
                "function-value guard)")
        self._evaluators()

    def _evaluators(self):
        """The functions the steps call: the user's as given with no mesh;
        on a mesh, wrapped to take this rank's slice of ``x`` and rows
        and to return this rank's slice of the sum over the data axis
        (:mod:`stochqn_tpu_torch.parallel.evaluate`)."""
        self._comm = None
        self._grad, self._hvp = self.grad_fn, self.hess_vec_fn
        self._obj = self._val_obj = self.obj_fn
        self._pair_grads = None
        if self.mesh is None:
            return
        comm = self._comm = MeshComm(self.mesh)
        red = self.reduction
        self._grad = data_parallel_grad(self.grad_fn, comm, red)
        self._hvp = data_parallel_hvp(self.grad_fn, comm, red,
                                      hess_vec_fn=self.hess_vec_fn)
        if self.paired_grads:
            self._pair_grads = data_parallel_grad(
                torch.func.vmap(self.grad_fn, in_dims=(None, 0)), comm, red)
        if self.obj_fn is not None:
            obj_fn = self.obj_fn
            self._obj = data_parallel_value(obj_fn, comm, red)

            def val_obj(x, batch):      # the full validation set: no sum
                (x_full,) = comm.gather_param([x], "gather x")
                return obj_fn(x_full, batch)
            self._val_obj = val_obj

    @property
    def eager_only(self) -> bool:
        """Whether only the eager drivers run: on a CUDA mesh whose groups
        are gloo, whose collectives run on the host and cannot be captured
        (:meth:`jit_epoch` and the others raise there).  False with no
        mesh, on a CPU mesh (the programs run the eager loop there) and on
        an NCCL mesh (they replay CUDA graphs)."""
        return (self._comm is not None and self.mesh.device_type != "cpu"
                and not self._comm.capturable)

    def init(self, x0, device=None):
        """Fresh state at ``x0`` (copied), on ``device``.  With no
        ``device`` a tensor stays where it is, and anything else (a numpy
        array, a list) goes to the card: no CUDA device raises; pass
        ``device="cpu"`` for the CPU.  On a mesh, this rank's part of the
        state."""
        if not isinstance(x0, torch.Tensor):
            device = resolve_device(
                device, "FusedTrainer.init with an x0 that is no tensor")
        init = {"oLBFGS": olbfgs.init, "SQN": sqn.init,
                "adaQN": adaqn.init}[self.optimizer]
        state = init(torch.as_tensor(x0, device=device), self.cfg)
        return state if self.mesh is None else shard_state(state, self.mesh)

    def round(self, state, round_data, step_size
              ) -> Tuple[Any, torch.Tensor]:
        """One ``upd_freq``-sized round: L branch-free base steps, then the
        boundary once.  ``round_data`` leaves are ``[L, bs, ...]``; the
        round must start with ``niter % upd_freq == 0``.  Returns
        ``(state, infos[L])`` (int32).  oLBFGS has no boundary: a round is
        one :func:`olbfgs_step` per minibatch, of any count."""
        L = _first_leaf(round_data).shape[0]
        eta = step_like(step_size, state.x)
        comm = self._comm
        if self.optimizer == "oLBFGS":
            infos = []
            for i in range(L):
                state, info = olbfgs_step(self.cfg, self._grad, state,
                                          _batch_at(round_data, i), eta, comm)
                infos.append(info)
            return state, torch.stack(infos)
        base = _sqn_base if self.optimizer == "SQN" else _adaqn_base
        bads = []
        for i in range(L):
            state, bad = base(self.cfg, self._grad, state,
                              _batch_at(round_data, i), eta, comm)
            bads.append(bad)
        with label("boundary"):
            big = _flat(round_data)
            if self.optimizer == "SQN":
                state, binfo = _sqn_boundary(self.cfg, self._grad, state,
                                             big, bads[-1], self._hvp, comm)
            else:
                fval, obj = ((self.val_data, self._val_obj)
                             if self.val_data is not None
                             else (big, self._obj))
                state, binfo = _adaqn_boundary(self.cfg, self._grad, obj,
                                               state, big, fval, bads[-1],
                                               comm)
        with label("infos"):
            infos = step_info(torch.stack(bads))
            infos[L - 1] = binfo
        return state, infos

    def _epoch_chunked(self, state, data, step_size, num_batches, L):
        rounds = num_batches // L
        data_r = _tree_map(
            lambda a: a.reshape((rounds, L) + tuple(a.shape[1:])), data)
        infos = []
        for r in range(rounds):
            state, inf = self.round(state, _batch_at(data_r, r), step_size)
            infos.append(inf)
        with label("infos"):
            return state, torch.cat(infos)

    def _epoch_generic(self, state, data, step_size, phase: int
                       ) -> Tuple[Any, torch.Tensor]:
        """One epoch of per-step iterations, starting ``phase`` steps into
        a round (``niter % upd_freq``, known on the host); the boundary
        follows each step that ends a round, on the cyclic window of the
        last ``upd_freq`` minibatches (fewer when the epoch has fewer)."""
        num_batches = _first_leaf(data).shape[0]
        L = self.cfg.upd_freq
        window = min(L, num_batches)
        eta = step_like(step_size, state.x)
        infos = []
        for i in range(num_batches):
            phase = (phase + 1) % L

            def big(i=i):
                return _cyclic_window(data, i, window, num_batches)
            if self.optimizer == "SQN":
                state, info = sqn_step(self.cfg, self._grad, state,
                                       _batch_at(data, i), big, eta,
                                       phase == 0, self._hvp, self._comm)
            else:
                fval, obj = (((lambda: self.val_data), self._val_obj)
                             if self.val_data is not None else
                             (big, self._obj))
                state, info = adaqn_step(self.cfg, self._grad, obj, state,
                                         _batch_at(data, i), big, fval, eta,
                                         phase == 0, self._comm)
            infos.append(info)
        with label("infos"):
            return state, torch.stack(infos)

    def _local(self, data):
        """This rank's rows of batched data (all of them with no mesh)."""
        return data if self.mesh is None else shard_batches(data, self.mesh)

    def _phase(self, state, aligned) -> int:
        """``niter % upd_freq`` at the start of a call: 0 where the caller
        asserts a round boundary (``aligned=True``) and for oLBFGS (no
        boundary), else read from the state (one host read)."""
        if aligned is True or self.optimizer == "oLBFGS":
            return 0
        with host_read():
            return int(state.niter) % self.cfg.upd_freq

    def _layout(self, num_batches: int, phase: int, generic: bool) -> tuple:
        """``(generic, phase)`` of the epoch :meth:`_epoch_at` runs from
        ``phase`` with ``generic`` asked: ``(False, 0)`` for the
        round-chunked layout and for oLBFGS, ``(True, phase)`` for the
        generic one.  A CUDA graph of the epoch is keyed by it."""
        if self.optimizer == "oLBFGS":
            return False, 0
        if generic or phase != 0 or num_batches % self.cfg.upd_freq != 0:
            return True, phase
        return False, 0

    def _epoch_at(self, state, data, step_size, phase: int, generic: bool):
        """One epoch starting ``phase`` steps into a round: for SQN and
        adaQN round-chunked where the layout allows it and ``generic`` is
        not forced, else per step."""
        if self.optimizer == "oLBFGS":
            if self.paired_grads:
                return _olbfgs_epoch_paired(self.cfg, self._grad, state,
                                            data,
                                            step_like(step_size, state.x),
                                            self._comm, self._pair_grads)
            return self.round(state, data, step_size)
        num_batches = _first_leaf(data).shape[0]
        L = self.cfg.upd_freq
        if generic or phase != 0 or num_batches % L != 0:
            return self._epoch_generic(state, data, step_size, phase)
        return self._epoch_chunked(state, data, step_size, num_batches, L)

    def epoch(self, state, data, step_size, aligned=None
              ) -> Tuple[Any, torch.Tensor]:
        """Run one epoch over ``data`` (leaves ``[B, bs, ...]``).  Returns
        ``(state, infos[B])``.

        An SQN or adaQN epoch takes the round-chunked layout when
        ``B % upd_freq == 0`` and it starts on a round boundary
        (``niter % upd_freq == 0``), else the generic per-step layout;
        both give the same steps.  ``aligned`` says what is known of the
        start:

        * ``True``: the caller asserts a round boundary; nothing is read
          on the host;
        * ``False``: force the generic layout; ``niter`` is read once;
        * ``None`` (default): ``niter`` is read once and decides, the
          torch form of the JAX package's ``lax.cond`` on
          ``niter % upd_freq``.

        An oLBFGS epoch has no boundary, so any ``B`` and any ``niter``
        will do and ``aligned`` is ignored."""
        return self._epoch_at(state, data, step_size,
                              self._phase(state, aligned), aligned is False)

    def epochs(self, state, data, step_size, nepochs: int,
               aligned=None) -> Tuple[Any, torch.Tensor]:
        """Run ``nepochs`` epochs over the same pre-batched ``data`` — the
        counterpart of the function ``jit_epochs()`` returns in the JAX
        package.  ``step_size`` is a scalar (same step every epoch) or a
        ``[nepochs]`` schedule.  Returns ``(state, infos[nepochs, B])``.

        Alignment is resolved once, before the first epoch (``aligned`` as
        in :meth:`epoch`); the host count then advances by ``B`` per epoch,
        so with ``aligned=True`` (or oLBFGS) no device value is read on
        the host at all."""
        steps = torch.broadcast_to(step_like(step_size, state.x),
                                   (nepochs,))
        return self._drive(state, [data] * nepochs, steps, aligned)

    def _drive(self, state, epoch_data, steps, aligned):
        """The epochs of ``epoch_data`` (an iterable of batched data, one
        per epoch) at ``steps[e]``, alignment resolved once."""
        phase = self._phase(state, aligned)
        infos = []
        for e, data in enumerate(epoch_data):
            state, inf = self._epoch_at(state, data, steps[e], phase,
                                        aligned is False)
            phase = (phase + _first_leaf(data).shape[0]) % self.cfg.upd_freq
            infos.append(inf)
        return state, torch.stack(infos)

    def epochs_scheduled(self, state, flat_data, step_sizes, orders,
                         batch_size: int, aligned=None
                         ) -> Tuple[Any, torch.Tensor]:
        """Epochs over a precomputed schedule — the counterpart of the
        function ``jit_epochs_scheduled()`` returns in the JAX package.

        ``flat_data`` leaves are unbatched ``[n_rows, ...]``; ``orders
        [nepochs, B * batch_size]`` holds each epoch's row indices in
        batch order and ``step_sizes [nepochs]`` its step size (a scalar:
        the same every epoch).  Each epoch is one gather on the data's
        device, ``a[order].reshape(B, batch_size, ...)``, then
        :meth:`epoch`.  Keep ``orders`` and ``step_sizes`` on the state's
        device: copying them there from the host waits for the device.
        Returns ``(state, infos[nepochs, B])``."""
        orders = _orders(flat_data, orders, batch_size)
        nepochs = orders.shape[0]
        steps = torch.broadcast_to(step_like(step_sizes, state.x),
                                   (nepochs,))

        def gathered(e):
            return self._local(_gather(flat_data, orders[e], batch_size))
        return self._drive(state, (gathered(e) for e in range(nepochs)),
                           steps, aligned)

    def run_epochs(self, state, data, nepochs: int, step_size,
                   decr_step_size=None, shuffle=None
                   ) -> Tuple[Any, torch.Tensor]:
        """Host loop over epochs of pre-batched ``data`` (leaves
        ``[B, bs, ...]``), each epoch the program of :meth:`jit_epoch`.
        ``decr_step_size(step0, epoch)`` gives each epoch's step size, as
        the guided schedule hook does.  ``shuffle``, a ``torch.Generator``
        on the data's device, reshuffles the rows of the whole epoch before
        each epoch (:func:`shuffle_batched`, from the unshuffled ``data``
        every time).  ``niter`` is read once, before the first epoch, and
        the host count then advances by ``B`` per epoch, so any start,
        mid-round included, takes its boundaries where the JAX package's
        do.  The state passed in is consumed only with ``donate=True``, as
        in the JAX package.  On a CUDA mesh over gloo (:attr:`eager_only`),
        where no graph can hold the collectives, the epochs run in the
        eager loop, with the same steps."""
        local = self._local(data) if shuffle is None else None

        def epoch_data():
            for _ in range(nepochs):
                yield local if shuffle is None else self._local(
                    shuffle_batched(data, shuffle))
        steps = [step_like(step_size if decr_step_size is None
                           else decr_step_size(step_size, e), state.x)
                 for e in range(nepochs)]
        return self._program(state, epoch_data(), nepochs, steps,
                             _first_leaf(data).shape[0], None)

    # -- the JAX package's single-dispatch programs ------------------------ #
    def _no_gloo_mesh(self, what: str) -> None:
        if self.eager_only:
            raise RuntimeError(
                f"{what}: a program is captured in a CUDA graph, and this "
                "CUDA mesh's groups run over gloo, whose collectives run on "
                "the host and cannot be captured (an NCCL mesh can); on a "
                "gloo mesh call the eager epoch() / epochs() / "
                "epochs_scheduled()")

    def _program(self, state, epoch_inputs, nepochs: int, steps, num_batches,
                 aligned, scheduled: Optional[int] = None):
        """``nepochs`` epochs through the CUDA graphs where the state is on
        the card (with no mesh or on an NCCL mesh), else the eager loop (on
        a copy of the state unless ``donate``).  ``epoch_inputs`` yields
        each epoch's batched data or, for a schedule (``scheduled`` the
        batch size), ``(flat_data, order)``: every rank's full rows, of
        which the epoch takes this rank's after the gather."""
        if not (graphs.captures(state) and (
                self._comm is None or self._comm.capturable)):
            if not self.donate:
                state = copy_tree(state)
            if scheduled is not None:
                epoch_inputs = (self._local(_gather(fd, order, scheduled))
                                for fd, order in epoch_inputs)
            return self._drive(state, epoch_inputs, steps, aligned)
        if self._programs is None:
            self._programs = EpochPrograms(self)
        if scheduled is None:
            def epoch(st, data, eta, layout):
                return self._epoch_at(st, data, eta, layout[1], layout[0])
        else:
            def epoch(st, inputs, eta, layout):
                data = self._local(_gather(inputs[0], inputs[1], scheduled))
                return self._epoch_at(st, data, eta, layout[1], layout[0])
        return self._programs.drive(
            "batched" if scheduled is None else "scheduled", state,
            epoch_inputs, nepochs, steps, num_batches, aligned, self.donate,
            epoch, static=() if scheduled is None else (scheduled,))

    def jit_epoch(self):
        """The cached single-epoch program: ``fn(state, data, step_size,
        aligned=None) -> (state, infos[B])``, :meth:`epoch`'s arguments
        and results.  On the card one replay of a CUDA graph of the epoch
        (captured at the first call with a new layout, data shape or start
        phase); on the CPU the eager epoch.  On an NCCL mesh the graph
        holds the epoch's collectives.  The state passed in is kept or
        consumed as ``donate`` says; a trainer on a CUDA mesh over gloo
        raises (:attr:`eager_only`)."""
        self._no_gloo_mesh("jit_epoch")
        if self._epoch_jit is None:
            def run(state, data, step_size, aligned=None):
                steps = step_like(step_size, state.x).reshape(1)
                state, infos = self._program(
                    state, [data], 1, steps, _first_leaf(data).shape[0],
                    aligned)
                return state, infos[0]
            self._epoch_jit = run
        return self._epoch_jit

    def jit_epochs(self):
        """The cached multi-epoch program: ``fn(state, data, step_size,
        nepochs, aligned=None) -> (state, infos[nepochs, B])``, ``nepochs``
        epochs over the same pre-batched ``data``, ``step_size`` a scalar
        (the same every epoch) or a ``[nepochs]`` schedule.  On the card
        ``nepochs`` replays of the epoch's CUDA graph with no host read
        between them; on the CPU :meth:`epochs`.  Alignment is resolved
        once, as in :meth:`epochs`.  On an NCCL mesh the graph holds the
        epoch's collectives.  The state passed in is kept or consumed as
        ``donate`` says; a trainer on a CUDA mesh over gloo raises
        (:attr:`eager_only`)."""
        self._no_gloo_mesh("jit_epochs")
        if self._epochs_jit is None:
            def run(state, data, step_size, nepochs, aligned=None):
                steps = torch.broadcast_to(step_like(step_size, state.x),
                                           (nepochs,))
                return self._program(state, [data] * nepochs, nepochs, steps,
                                     _first_leaf(data).shape[0], aligned)
            self._epochs_jit = run
        return self._epochs_jit

    def jit_epochs_scheduled(self):
        """The cached scheduled program: ``fn(state, flat_data,
        step_sizes, orders, batch_size, aligned=None) -> (state,
        infos[nepochs, B])``, :meth:`epochs_scheduled`'s arguments and
        results.  On the card each epoch is one replay of a CUDA graph that
        gathers ``a[order]`` of every leaf and runs the epoch on it, the
        epoch's order and step copied into the graph's buffers before it;
        on the CPU :meth:`epochs_scheduled`.  On a mesh every rank passes
        the full rows and the graph takes this rank's after the gather, as
        :meth:`epochs_scheduled` does.  The state passed in is kept or
        consumed as ``donate`` says; a trainer on a CUDA mesh over gloo
        raises (:attr:`eager_only`)."""
        self._no_gloo_mesh("jit_epochs_scheduled")
        if self._epochs_sched_jit is None:
            def run(state, flat_data, step_sizes, orders, batch_size,
                    aligned=None):
                orders = _orders(flat_data, orders, batch_size)
                nepochs, rows = orders.shape
                steps = torch.broadcast_to(step_like(step_sizes, state.x),
                                           (nepochs,))
                return self._program(
                    state, ((flat_data, orders[e]) for e in range(nepochs)),
                    nepochs, steps, rows // batch_size, aligned,
                    scheduled=batch_size)
            self._epochs_sched_jit = run
        return self._epochs_sched_jit


def _orders(flat_data, orders, batch_size: int) -> torch.Tensor:
    """A schedule's ``[nepochs, B * batch_size]`` row orders on the data's
    device."""
    orders = torch.as_tensor(orders, device=_first_leaf(flat_data).device)
    if orders.shape[1] % batch_size:
        raise ValueError(
            f"orders.shape[1]={orders.shape[1]} must be a multiple of "
            f"batch_size={batch_size} (each epoch row lists exactly the "
            "gathered batch rows)")
    return orders


def _gather(flat_data, order: torch.Tensor, batch_size: int):
    """One epoch's rows ``a[order]`` of every leaf, as ``[B, batch_size,
    ...]`` batches."""
    nbatch = order.shape[0] // batch_size
    return _tree_map(lambda a: a.index_select(0, order).reshape(
        (nbatch, batch_size) + tuple(a.shape[1:])), flat_data)


def shuffle_batched(data, generator: torch.Generator):
    """Shuffle example rows across the whole epoch, keeping the batching:
    one ``torch.randperm`` of ``B * bs`` rows from ``generator`` (on the
    data's device), applied to every leaf."""
    nb, bs = _first_leaf(data).shape[:2]
    perm = torch.randperm(nb * bs, generator=generator,
                          device=generator.device)

    def shuf(a):
        flat = a.reshape((nb * bs,) + tuple(a.shape[2:]))
        return flat.index_select(0, perm).reshape(a.shape)
    return _tree_map(shuf, data)


def batchify(data, batch_size: int):
    """Reshape ``[n, ...]`` leaves into ``[B, batch_size, ...]``, dropping
    the ragged tail."""
    def rs(a):
        nb = a.shape[0] // batch_size
        if nb == 0:
            raise ValueError(
                f"batch_size={batch_size} exceeds the {a.shape[0]} available "
                "rows — no batches would be produced")
        return a[:nb * batch_size].reshape(
            (nb, batch_size) + tuple(a.shape[1:]))
    return _tree_map(rs, data)
