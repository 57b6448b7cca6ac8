"""Readings that the limits of a cell's check are set from, on the card:

* the program's sound runs, one per ``--seeds`` seed (the lower reading
  of each number is the largest of them);
* the control, one per ``--control-seeds`` seed: the configuration's
  ``control``, either the plain reference in the precision below the one
  the configuration states, put in the program's place, or the name of
  the program's own lower-precision option (``pairs_bf16``), the program
  run with it on;
* each fault of ``--faults`` (``portbench/faults.py``) planted in the
  program, one run per ``--fault-seeds`` seed.

Each run is the cell's set-up and a window of ``--window-seconds`` (the
cell's own load, long enough for the check's answers), then the check;
all in one process, on the card (exits with 2 where there is none).
Prints one line per run and writes every number to ``--out`` as JSON.

    python3 portbench/control.py --workload sqn_bibtex.graph \
        --seeds 11,12,13 --control-seeds 21,22,23 --fault-seeds 31,32,33 \
        --out readings.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def reading(bench, cell: str, seed: int, device, seconds: float,
            kind: str = "program") -> dict:
    """The check's numbers of one run: ``kind`` ``"program"`` (a sound
    run), ``"control"`` or the name of a fault planted in the program."""
    import torch
    from portbench import driving, faults, harness
    ctx = harness.Context(bench, cell, seed, device)
    torch.backends.cuda.matmul.allow_tf32 = bool(ctx.cfg.get("tf32", False))
    mode = ctx.cfg["control"]
    option = kind == "control" and mode not in driving.PRECISIONS
    if option:
        ctx.cfg[mode] = True
    r = ctx.driver().Run(ctx)
    with (faults.plant(kind, ctx.module("models"))
          if kind in faults.NAMES else contextlib.nullcontext()):
        r.setup()
        r.window(seconds)
    r.release()
    if kind == "control" and not option:
        return r.control(mode)
    return r.check()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="unchanged,half_batch,altered")
    ap.add_argument("--window-seconds", type=float, default=0.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device: the readings are the card's", file=sys.stderr)
        sys.exit(2)
    bench = harness.Bench()
    device = torch.device("cuda", 0)
    out = {"workload": args.workload}
    runs = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds] + \
        [(f, s) for f in args.faults.split(",") if f
         for s in args.fault_seeds]
    for kind, seed in runs:
        t0 = time.perf_counter()
        numbers = reading(bench, args.workload, seed, device,
                          args.window_seconds, kind)
        out.setdefault(kind, {})[seed] = numbers
        print(f"{kind} seed {seed} ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} {v!r}" for k, v in numbers.items()),
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
