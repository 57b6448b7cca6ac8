"""What the drivers share: the device's clock and sync, a run's record,
the precision a reference runs in, the card's name, power limit, clocks
and temperature, and the program's pair memory read back oldest first;
on several ranks, rank 0's part (the end of the window, the profiler,
the check)."""
from __future__ import annotations

import contextlib
import gc
import subprocess
import time
from typing import List

import torch

from portbench import checks, trace

NAMES = {"no_problems_encountered": 200, "func_increased": 201,
         "curvature_too_small": 202, "search_direction_was_nan": 203}
NAN_CODE = 203
# the precisions a plain reference runs in (:func:`precision`); any other
# control a configuration names is an option of the program's own
PRECISIONS = ("float32", "tf32", "bfloat16")


@contextlib.contextmanager
def precision(mode: str):
    """The plain reference's precision: ``float32`` (TF32 off), ``tf32``
    (float32 with the matrix products in TF32) or ``bfloat16``.  Yields
    the dtype to compute in."""
    mm = torch.backends.cuda.matmul.allow_tf32
    dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield torch.bfloat16 if mode == "bfloat16" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


def live_pairs(mem) -> torch.Tensor:
    """``[S; Y]`` of a block-layout memory's live pairs, oldest first, on
    the host."""
    m = mem.s.shape[0]
    head, count = int(mem.head), int(mem.count)
    rows = torch.tensor([(head - count + i) % m for i in range(count)],
                        dtype=torch.long, device=mem.s.device)
    return torch.cat([mem.s.index_select(0, rows),
                      mem.y.index_select(0, rows)]).float().cpu()


def reference_pairs(opt) -> torch.Tensor:
    """The same of a :class:`portbench.reference.sqn.SQN`."""
    if not opt.S:
        return torch.zeros((0, opt.x.shape[0]))
    return torch.cat([torch.stack(opt.S), torch.stack(opt.Y)]).float().cpu()


def smi(fields: str) -> str:
    """``fields`` of the card as ``nvidia-smi`` reads them, or "not
    read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not read"


def card() -> str:
    """The card's name and power limit."""
    return smi("name,power.limit")


def card_state() -> str:
    """The card's SM and memory clocks, power draw and temperature."""
    return smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")


class Base:
    """A run of one cell; a driver's ``Run`` fills in ``setup``,
    ``window``, ``trace`` and ``reference``."""

    def __init__(self, ctx):
        self.ctx, self.cfg, self.traffic = ctx, ctx.cfg, ctx.traffic
        self.device = ctx.device
        self.attempted = self.failed = 0
        self.end_to_end: dict = {}
        self.traced: dict = {}
        self.window_s = 0.0
        self.rate = 0.0                 # the window's units of work a second
        self.lines: List[str] = []      # printed before the result
        self.record: dict = {}          # the program's checked steps

    @property
    def leader(self) -> bool:
        """Whether this process reports the run: the only one, or rank 0."""
        return self.ctx.ranks is None or self.ctx.ranks.rank == 0

    def stop(self, done: bool) -> bool:
        """Whether the window ends: ``done``, by rank 0's clock on every
        rank where there are several, so that all make the same calls."""
        return done if self.ctx.ranks is None else self.ctx.ranks.decide(done)

    def held(self) -> set:
        """The devices that hold the run's data and the program's
        iterate (``state.x``, where the driver keeps a state)."""
        tensors = [t for t in getattr(self, "data", {}).values()
                   if isinstance(t, torch.Tensor)]
        state = getattr(self, "state", None)
        if state is not None:
            tensors.append(state.x)
        return {t.device for t in tensors}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def clock() -> float:
        return time.perf_counter()

    def marker(self):
        """An event on the current stream (None on the CPU, whose work is
        done when the call returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def profile(self, call) -> None:
        """``call()`` profiled (:func:`portbench.trace.profile_slice`), the
        payload of the collectives it ran counted in ``collective_bytes``;
        on a rank other than 0 it only runs."""
        from stochqn_tpu_torch.parallel import comm
        if not self.leader:
            self.sync()
            call()
            self.sync()
            return
        with comm.record_collectives() as log:
            self.traced = trace.profile_slice(call, self.sync)
        self.traced["collective_bytes"] = comm.collective_bytes(log)

    def notes(self) -> List[str]:
        return list(self.lines)

    def release(self) -> None:
        """Drop the program's objects (a driver lists them in
        ``program_attrs``) and return their memory."""
        for name in getattr(self, "program_attrs", ()):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str) -> dict:
        raise NotImplementedError

    def check(self) -> dict:
        """The program's record against the plain reference's, in the
        precision the configuration states; rank 0's alone (the others
        give nothing)."""
        if not self.leader:
            return {}
        return self.compare(self.record, self.reference("float32"))

    def compare(self, prog: dict, ref: dict) -> dict:
        return checks.compare(prog, ref, self.x0, self.loss)

    def control(self, mode: str) -> dict:
        """The check's numbers with the plain reference in ``mode`` put in
        the program's place; rank 0's alone."""
        if not self.leader:
            return {}
        return self.compare(self.reference(mode), self.reference("float32"))
