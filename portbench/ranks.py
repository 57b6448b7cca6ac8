"""A cell on several cards: one process a rank, one card each.

The port's meshes put one process on each rank (explicit SPMD), so a
cell whose ``chips`` is over 1 runs as that many ranks.  The process the
benchmark is started as is the launcher (:func:`launch`): it starts
``world`` copies of its own script, each with ``--rank r --world w
--rendezvous file://...`` (and ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
in its environment), waits for all of them under one deadline, and on
the first rank that fails, or at the deadline, kills every rank.

In a rank, :class:`Group` forms the port's process group
(``stochqn_tpu_torch.parallel.distributed.initialize``: NCCL on the
card, gloo on the CPU, which the tests use) and one gloo group over the
same ranks for the host's decisions: rank 0's choice to end the window
(:meth:`Group.decide`), the barriers, and what rank 0 gathers
(:meth:`Group.gather`).  Every rank makes the same calls in the same
order, or NCCL waits for the missing one.
"""
from __future__ import annotations

import datetime
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Sequence, Tuple

# the seconds a run of several ranks may take beyond its window: start-up,
# set-up (capture included), the traced slice, the check and teardown
SETUP_ALLOWANCE = 900.0
# the exit codes a rank passes on as they are (2: no card or too few; 3:
# a forbidden module loaded); every other failure exits with 1
KEPT_CODES = (2, 3)


def add_arguments(ap) -> None:
    """The options the launcher gives each rank (not for a user)."""
    import argparse
    for name, kind in (("--rank", int), ("--world", int),
                       ("--rendezvous", str), ("--t0", float)):
        ap.add_argument(name, type=kind, default=None, help=argparse.SUPPRESS)


def launch(cmd: Sequence[str], world: int, deadline: float
           ) -> Tuple[int, str, str]:
    """Run ``world`` ranks of ``cmd`` (with the rank options added) and
    wait for all of them, at most ``deadline`` seconds.  Returns ``(code,
    rank 0's standard output, every rank's standard error)``, the failing
    rank's last; ``code`` is 0 where every rank exited with 0, else the
    first failing rank's code as :data:`KEPT_CODES` say, or 1 (the
    deadline passed, or a rank failed otherwise).  No rank is left alive,
    also where the launcher itself is ended by SIGTERM."""
    tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
    procs: List[subprocess.Popen] = []
    files = []
    term = signal.signal(signal.SIGTERM, _exit_on_term)
    try:
        url = "file://" + os.path.join(tmp, "rendezvous")
        for r in range(world):
            out = open(os.path.join(tmp, f"r{r}.out"), "w+")
            err = open(os.path.join(tmp, f"r{r}.err"), "w+")
            files.append((out, err))
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                list(cmd) + ["--rank", str(r), "--world", str(world),
                             "--rendezvous", url],
                stdout=out, stderr=err, stdin=subprocess.DEVNULL, env=env))
        code, failing = _wait(procs, time.monotonic() + deadline)
        _kill(procs)
        # only rank 0 prints a result; anything another rank printed on
        # its standard output goes with its errors
        logs = [_read(err) + (_read(out) if r else "")
                for r, (out, err) in enumerate(files)]
        out0 = "" if code else _read(files[0][0])
        last = failing if failing is not None else 0
        order = [r for r in range(world) if r != last] + [last]
        errors = "".join(_tagged(r, logs[r]) for r in order)
        if failing is None and code:
            errors += f"ranks: the deadline of {deadline:.0f} s passed\n"
        elif failing is not None:
            errors += (f"ranks: rank {failing} exited with "
                       f"{procs[failing].returncode}\n")
        return code, out0, errors
    finally:
        _kill(procs)
        signal.signal(signal.SIGTERM, term)
        for out, err in files:
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _read(f) -> str:
    f.seek(0)
    return f.read()


def _tagged(rank: int, text: str) -> str:
    return "".join(f"[rank {rank}] {line}\n" for line in text.splitlines())


def _exit_on_term(signum, frame):
    raise SystemExit(128 + signum)


def _wait(procs, end: float) -> Tuple[int, object]:
    """``(code, failing rank or None)`` once every rank has exited with 0,
    one has failed, or ``end`` has passed."""
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0):
                return (c if c in KEPT_CODES else 1), r
        if all(c == 0 for c in codes):
            return 0, None
        if time.monotonic() > end:
            return 1, None
        time.sleep(0.05)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


class Group:
    """This process's rank: the port's process group (NCCL on the card,
    gloo on the CPU) and a gloo group over the same ranks for the host.
    Leaves the process where the launcher that started it has gone."""

    def __init__(self, rank: int, world: int, rendezvous: str,
                 device_type: str, timeout_s: float):
        import torch
        import torch.distributed as dist
        from stochqn_tpu_torch.parallel import distributed
        self.rank, self.world, self.device_type = rank, world, device_type
        _watch_parent(os.getppid())
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        timeout = datetime.timedelta(seconds=timeout_s)
        distributed.initialize(init_method=rendezvous, world_size=world,
                               rank=rank, device_type=device_type,
                               timeout=timeout)
        self.host = dist.new_group(backend="gloo", timeout=timeout)
        self._meshes: dict = {}

    def decide(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        import torch
        import torch.distributed as dist
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.host)
        return bool(t.item())

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.host)

    def gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def mesh(self, shape: Sequence[int]):
        """The port's ``(data, param)`` mesh of ``shape`` over the ranks,
        made once a process."""
        from stochqn_tpu_torch.parallel import make_mesh
        key = tuple(shape)
        if key not in self._meshes:
            self._meshes[key] = make_mesh(*key, device_type=self.device_type)
        return self._meshes[key]

    def close(self) -> None:
        """Destroy the groups; the program's graphs, which hold NCCL's
        kernels, have to be released before."""
        import gc
        import torch
        import torch.distributed as dist
        self._meshes.clear()
        gc.collect()
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        dist.destroy_process_group()


def _watch_parent(parent: int) -> None:
    """Leave the process once its parent, the launcher, has gone (a
    launcher killed outright cannot kill its ranks)."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True,
                     name="portbench-parent-watch").start()


def leave(code: int) -> None:
    """Leave a rank at once, output flushed: a rank that failed may hold
    graphs with NCCL's kernels, under which the group cannot be
    destroyed."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
