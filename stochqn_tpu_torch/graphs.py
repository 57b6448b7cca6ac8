"""Single-dispatch epoch programs: the fused epoch captured in a CUDA graph.

Counterpart of the programs the JAX package's ``FusedTrainer.jit_epoch``,
``jit_epochs`` and ``jit_epochs_scheduled`` compile
(``stochqn_tpu/fused.py:715-826``).  XLA runs a jitted epoch as one device
program; eager PyTorch dispatches each of its ops from Python, and the
device waits for the host (PERF.md section 5).  Here one epoch, exactly
the ops :meth:`~stochqn_tpu_torch.fused.FusedTrainer._epoch_at` runs
eagerly, is captured once in a ``torch.cuda.CUDAGraph`` and replayed:
``nepochs`` epochs are ``nepochs`` replays, with no host read in between.

The graph reads its inputs from static buffers that it owns:

* the state's tensors (one buffer per field, shared by every graph of a
  :class:`_Family`); the captured epoch ends by copying its output state
  back into them, unless an output field is its input buffer updated in
  place (the block layout's pair rows, a ring-mode Fisher row), so
  replays chain with nothing between them;
* the data (batched ``[B, bs, ...]`` leaves, or for a scheduled epoch the
  unbatched rows and the epoch's row order, gathered inside the graph);
* the step size, a 0-d tensor of the iterate's dtype.  A Python step
  would be a fill frozen into the graph at capture; a static buffer
  follows every call.

Before a replay the caller's inputs are copied into the buffers, except a
state that is the family's own buffers (what a ``donate=True`` call
returns) and a data tensor that is the one copied last time, unmodified
since (its ``_version`` unchanged).

A graph is keyed by what decides its ops: its family (the trainer, the
state's layout and its tensors' shapes, dtypes and devices, the data's,
the step's dtype, a scheduled epoch's batch size, the mesh's shape and
this rank's place in it) and the epoch's layout (round-chunked, or
generic from a start phase ``niter % upd_freq``: up to ``upd_freq``
graphs where ``B % upd_freq != 0``).  The layout is decided
on the host before the epoch, as the eager driver decides it.

Before its capture a graph's epoch runs once eagerly on a scratch copy of
the state, on the capture stream: that builds the kernels, fills their
per-device caches, and makes cuBLAS's first call on that stream, none of
which may happen inside a capture; the caller's state is not advanced.
Nothing falls back: a capture or replay that fails raises, naming the
user function that read the host where it was one.

Kernel launches: a kernel wrapper called inside a capture records its
launch with the graph (:data:`~stochqn_tpu_torch.ops.kernels.
two_loop_kernel.CAPTURED`) instead of counting it, and every replay
counts the launches its graph holds.  :data:`STATS` keeps what the
programs did since :func:`reset_stats`, and the label map of every graph
captured (:func:`stochqn_tpu_torch.utils.metrics.label`).  A call is the
span ``stochqn.jit_epochs`` over its host read, loads, warm-ups, captures
and replays, and the bytes copied into the buffers and back are counted
(:mod:`stochqn_tpu_torch.utils.metrics`).

On a mesh (``FusedTrainer(mesh=...)``) whose groups are NCCL, the epoch's
collectives are captured with it: ``ProcessGroupNCCL`` runs each on its
own stream, ordered after the capture stream and joined back into it, so
the graph holds NCCL's kernels between the epoch's own.  What that needs:

* the warm-up epoch runs every collective of the epoch once for real,
  which creates NCCL's communicators (made at a group's first call, and
  not inside a capture);
* every rank captures and replays the same graphs in the same order: the
  layout and the start phase are host decisions every rank makes alike
  from the same ``niter`` and batch count, so no rank waits in a
  collective that another rank's graph does not hold;
* the capture runs in thread-local mode, so that the calls NCCL's
  watchdog thread makes meanwhile do not void it;
* the graph is keyed by the mesh's shape and this rank's place in it too,
  and its collectives are logged at each replay
  (:func:`stochqn_tpu_torch.parallel.comm.log_replay`), as its launches
  are counted.

A graph that holds NCCL kernels must be released before the process group
is destroyed (drop the trainer and ``gc.collect()``): destroying the
group under a live graph can hang, and a later replay would run on a dead
communicator.  A gloo group runs its collectives on the host, so a trainer
on a CUDA mesh over gloo has no programs (``FusedTrainer.jit_epoch`` and
the others raise there).
"""
from __future__ import annotations

import dataclasses
import gc
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk
from stochqn_tpu_torch.parallel import comm
from stochqn_tpu_torch.utils import metrics

# Since the last reset_stats(): graphs captured and replays, the seconds
# spent capturing and instantiating graphs and warming them up, the
# kernel launches (by counter name of ops.kernels.two_loop_kernel) made by
# warm-up epochs and by replays, and each graph's label map
# ``(node_count, [(label, first, end), ...])`` in the order captured.
STATS: Dict[str, Any] = {}


def reset_stats() -> None:
    STATS.update(captures=0, replays=0, capture_s=0.0, warm_s=0.0,
                 warm_launches={}, replay_launches={}, labels=[])


reset_stats()


def _add(counts: dict, more: dict) -> None:
    for k, v in more.items():
        counts[k] = counts.get(k, 0) + v


# -- trees of tensors -------------------------------------------------------- #
def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """The tensors of a state or batch (dataclasses, tuples, lists, dicts
    and tensors, nested) in a fixed order, and a hashable spec of the
    structure with every non-tensor field's value (a memory's ``shift``)."""
    leaves: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return "T"
        if dataclasses.is_dataclass(t):
            return (type(t), tuple((f.name, walk(getattr(t, f.name)))
                                   for f in dataclasses.fields(t)))
        if isinstance(t, (tuple, list)):
            return (type(t), tuple(walk(p) for p in t))
        if isinstance(t, dict):
            return (dict, tuple((k, walk(t[k])) for k in t))
        return ("static", t)
    return leaves, walk(tree)


def unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` with ``leaves`` (in :func:`flatten` order)."""
    it = iter(leaves)

    def build(s):
        if s == "T":
            return next(it)
        kind, parts = s
        if kind == "static":
            return parts
        if kind is dict:
            return {k: build(p) for k, p in parts}
        if kind in (tuple, list):
            return kind(build(p) for p in parts)
        return kind(**{name: build(p) for name, p in parts})
    return build(spec)


def copy_tree(tree) -> Any:
    """A copy of ``tree`` with every tensor cloned."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [t.clone() for t in leaves])


def _meta(leaves) -> tuple:
    return tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                 for t in leaves)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


# -- capture ----------------------------------------------------------------- #
def captures(state) -> bool:
    """Whether the programs capture ``state``'s epochs in CUDA graphs:
    a state on the card (a CPU state runs the eager loop)."""
    return state.x.device.type == "cuda"


_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device on which every warm-up and capture runs
    (a graph cannot be captured on the default stream)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


def _user_frame(err: BaseException, user_fns: Dict[str, Callable]):
    """Where in the user's functions ``err`` was raised: ``(role, name,
    file:line)`` of the innermost frame that runs one of ``user_fns``
    (``grad_fn``, ``obj_fn``, ``hess_vec_fn``), else of the innermost
    frame outside torch and this package; None if there is none."""
    codes = {getattr(fn, "__code__", None): role
             for role, fn in user_fns.items() if fn is not None}
    ours = (os.path.dirname(os.path.abspath(__file__)),
            os.path.dirname(os.path.abspath(torch.__file__)))
    found = outside = None
    tb = err.__traceback__
    while tb is not None:
        code = tb.tb_frame.f_code
        where = (code.co_name, f"{code.co_filename}:{tb.tb_lineno}")
        if code in codes:
            found = (codes[code],) + where
        elif not os.path.abspath(code.co_filename).startswith(ours):
            outside = ("the function",) + where
        tb = tb.tb_next
    return found or outside


def _capture_error(trainer, err: BaseException) -> RuntimeError:
    user = _user_frame(err, {"grad_fn": trainer.grad_fn,
                             "obj_fn": trainer.obj_fn,
                             "hess_vec_fn": trainer.hess_vec_fn})
    where = ("" if user is None else
             f" in {user[0]} {user[1]!r} ({user[2]})")
    return RuntimeError(
        f"capturing the {trainer.optimizer} epoch in a CUDA graph failed"
        f"{where}: {type(err).__name__}: {err}.  Every function the epoch "
        "calls has to run on the card without a host read (.item(), "
        "float(), a Python branch on a tensor's value); the eager "
        "FusedTrainer.epoch() / epochs() take such functions")


class _Graph:
    """One epoch of one layout, captured: ``run(state, inputs, eta) ->
    (state, infos)`` on the family's buffers."""

    def __init__(self, family: "_Family", run: Callable):
        device = family.device
        cap = _capture_stream(device)
        cur = torch.cuda.current_stream(device)
        cap.wait_stream(cur)
        counted = dict(tlk.read_launches())
        t0 = time.perf_counter()
        with torch.cuda.stream(cap):
            # the warm-up epoch, on a scratch copy of the loaded state
            with metrics.span("stochqn.warmup"):
                run(copy_tree(family.state_tree()), family.inputs_tree(),
                    family.eta)
            self.warm_launches = {k: v - counted[k]
                                  for k, v in tlk.read_launches().items()
                                  if v != counted[k]}
            t1 = time.perf_counter()
            with metrics.span("stochqn.capture"):
                self._capture(family, run, cap)
        cur.wait_stream(cap)
        self.warm_s = t1 - t0
        self.capture_s = time.perf_counter() - t1
        self.replays = 0
        STATS["captures"] += 1
        STATS["capture_s"] += self.capture_s
        STATS["warm_s"] += self.warm_s
        _add(STATS["warm_launches"], self.warm_launches)
        STATS["labels"].append(self.labels)

    def _capture(self, family: "_Family", run: Callable,
                 cap: "torch.cuda.Stream") -> None:
        """The capture of ``run`` on the family's buffers, on ``cap``,
        its write-back included, and the graph's label map."""
        trainer = family.trainer
        nodes = metrics.GraphNodes(cap)
        self.graph = torch.cuda.CUDAGraph()
        tlk.CAPTURED.clear()
        comm.CAPTURED.clear()
        # No garbage collection while capturing: collecting another
        # trainer's graph destroys it, which CUDA refuses during a
        # capture, and the capture is lost.
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            # on a mesh NCCL's watchdog thread queries events while
            # this thread captures: global mode would void the capture
            self.graph.capture_begin(capture_error_mode=(
                "global" if trainer.mesh is None else "thread_local"))
            try:
                with metrics.capturing(nodes) as c:
                    out, self.infos = run(family.state_tree(),
                                          family.inputs_tree(),
                                          family.eta)
                    self.copy_bytes = family.write_back(out)
                    self.labels = c.map()
            except BaseException as err:
                try:
                    self.graph.capture_end()
                except Exception:  # noqa: BLE001 - the capture is void
                    pass
                raise _capture_error(trainer, err) from err
            self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.launches = dict(tlk.CAPTURED)
        self.collectives = list(comm.CAPTURED)
        tlk.CAPTURED.clear()
        comm.CAPTURED.clear()

    def replay(self) -> torch.Tensor:
        """One epoch on the family's buffers; returns the graph's infos
        (overwritten by the next replay)."""
        self.graph.replay()
        tlk.count_replay(self.launches)
        comm.log_replay(self.collectives)
        self.replays += 1
        STATS["replays"] += 1
        _add(STATS["replay_launches"], self.launches)
        return self.infos


class _Family:
    """The static buffers of one state layout, data layout and step dtype,
    and the graphs captured on them, one per epoch layout."""

    def __init__(self, trainer, state, inputs, eta_dtype, epoch_fn):
        self.trainer = trainer
        self.epoch_fn = epoch_fn        # (state, inputs, eta, layout) -> ...
        leaves, self.state_spec = flatten(state)
        self.state = [torch.empty_like(t) for t in leaves]
        leaves, self.inputs_spec = flatten(inputs)
        self.inputs = [torch.empty_like(t) for t in leaves]
        self.loaded: List[Optional[Tuple[Any, int]]] = [None] * len(leaves)
        self.device = state.x.device
        self.eta = torch.empty((), dtype=eta_dtype, device=self.device)
        self.graphs: Dict[tuple, _Graph] = {}
        self.copy_in_bytes = 0

    def state_tree(self):
        return unflatten(self.state_spec, self.state)

    def inputs_tree(self):
        return unflatten(self.inputs_spec, self.inputs)

    def load(self, state, inputs, eta: torch.Tensor) -> None:
        """Copy the caller's state, inputs and step into the buffers,
        skipping the state where it is these buffers and a data tensor
        that is the one copied last time, unmodified since."""
        leaves, _ = flatten(state)
        nbytes = 0
        if not all(a is b for a, b in zip(leaves, self.state)):
            for dst, src in zip(self.state, leaves):
                dst.copy_(src)
                nbytes += dst.nbytes
        for i, src in enumerate(flatten(inputs)[0]):
            seen = self.loaded[i]
            if seen is not None and seen[0]() is src and \
                    seen[1] == src._version:
                continue
            self.inputs[i].copy_(src)
            nbytes += src.nbytes
            self.loaded[i] = (weakref.ref(src), src._version)
        self.eta.copy_(eta)
        self.copy_in_bytes += nbytes
        metrics.count("copy_in_bytes", nbytes)

    def write_back(self, out) -> int:
        """Inside the capture: copy the epoch's output state into the
        state buffers (an output that is its own buffer, updated in place,
        stays).  An output that shares another buffer's storage is staged
        first, so no copy reads a buffer an earlier copy wrote.  Returns
        the bytes copied per replay.  Labelled ``copy_back``."""
        with metrics.label("copy_back"):
            return self._write_back(out)

    def _write_back(self, out) -> int:
        leaves, spec = flatten(out)
        if spec != self.state_spec or [(t.shape, t.dtype) for t in leaves] \
                != [(t.shape, t.dtype) for t in self.state]:
            raise RuntimeError("the epoch returned a state of another "
                               "layout than it was given")
        buffers = {_storage(t) for t in self.state}
        moves = []
        for dst, src in zip(self.state, leaves):
            if src.data_ptr() == dst.data_ptr():
                continue                        # updated in place
            if _storage(src) in buffers:
                src = src.clone()
            moves.append((dst, src))
        for dst, src in moves:
            dst.copy_(src)
        return sum(dst.nbytes for dst, _ in moves)

    def graph(self, layout: tuple) -> _Graph:
        if layout not in self.graphs:
            def run(state, inputs, eta):
                return self.epoch_fn(state, inputs, eta, layout)
            self.graphs[layout] = _Graph(self, run)
        return self.graphs[layout]


class EpochPrograms:
    """The graphs of one :class:`~stochqn_tpu_torch.fused.FusedTrainer`,
    by family; ``trainer.jit_epoch()`` and the others drive them."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.families: Dict[tuple, _Family] = {}

    def graphs(self) -> List[_Graph]:
        """Every graph captured so far."""
        return [g for f in self.families.values() for g in f.graphs.values()]

    def family(self, kind: str, state, inputs, eta_dtype, epoch_fn,
               static=()) -> _Family:
        s_leaves, s_spec = flatten(state)
        i_leaves, i_spec = flatten(inputs)
        dev = state.x.device
        if any(t.device != dev for t in s_leaves + i_leaves):
            raise ValueError(
                f"{kind}: the state and the data must be on one device "
                f"(the state is on {dev}, the data on "
                f"{sorted({str(t.device) for t in i_leaves})})")
        c = self.trainer._comm          # the mesh's shape, this rank's place
        mesh = None if c is None else (c.n_data, c.n_param, c.data_rank,
                                       c.param_rank)
        key = (kind, s_spec, _meta(s_leaves), i_spec, _meta(i_leaves),
               eta_dtype, static, mesh)
        if key not in self.families:
            self.families[key] = _Family(self.trainer, state, inputs,
                                         eta_dtype, epoch_fn)
        return self.families[key]

    def drive(self, kind: str, state, epoch_inputs, nepochs: int,
              steps, num_batches: int, aligned, donate: bool,
              epoch_fn, static=()) -> Tuple[Any, torch.Tensor]:
        """``nepochs`` epochs, epoch ``e`` on the ``e``-th item of the
        iterable ``epoch_inputs`` at ``steps[e]``, each one replay.  ``epoch_fn
        (state, inputs, eta, (generic, phase))`` is the epoch the graphs
        capture.  The start phase is resolved once, as the eager driver
        resolves it.  With ``donate`` the returned state is the family's
        buffers; otherwise a copy of them."""
        with metrics.span("stochqn.jit_epochs"):
            tr = self.trainer
            phase = tr._phase(state, aligned)
            L = tr.cfg.upd_freq
            infos = torch.empty((nepochs, num_batches),
                                dtype=torch.int32, device=state.x.device)
            for e, inputs in enumerate(epoch_inputs):
                fam = self.family(kind, state, inputs, state.x.dtype,
                                  epoch_fn, static)
                with metrics.span("stochqn.load"):
                    fam.load(state, inputs, steps[e])
                layout = tr._layout(num_batches, phase, aligned is False)
                graph = fam.graph(layout)
                with metrics.span("stochqn.replay"):
                    out = graph.replay()
                metrics.count("copy_back_bytes", graph.copy_bytes)
                infos[e].copy_(out)
                state = fam.state_tree()
                phase = (phase + num_batches) % L
            return (state if donate else copy_tree(state)), infos
