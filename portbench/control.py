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
A cell on several cards makes its runs as that many ranks, started as
``run.py`` starts them (``portbench/ranks.py``), every rank making every
run; rank 0 prints and writes the numbers.  ``--faults`` may then name
the faults across cards too (``faults.ACROSS``).

    python3 portbench/control.py --workload sqn_bibtex.graph \
        --seeds 11,12,13 --control-seeds 21,22,23 --fault-seeds 31,32,33 \
        --out readings.json
    python3 portbench/control.py --workload sqn_criteo.split4 \
        --faults unchanged,half_batch,altered,no_param_sum ...
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def reading(bench, cell: str, seed: int, device, seconds: float,
            kind: str = "program", ranks=None) -> dict:
    """The check's numbers of one run: ``kind`` ``"program"`` (a sound
    run), ``"control"`` or the name of a fault planted in the program;
    on several ranks (``ranks``) rank 0's, the others' empty."""
    import torch
    from portbench import driving, faults, harness
    ctx = harness.Context(bench, cell, seed, device, ranks=ranks)
    torch.backends.cuda.matmul.allow_tf32 = bool(ctx.cfg.get("tf32", False))
    mode = ctx.cfg["control"]
    option = kind == "control" and mode not in driving.PRECISIONS
    if option:
        ctx.cfg[mode] = True
    r = ctx.driver().Run(ctx)
    with (faults.plant(kind, ctx.module("models"))
          if kind in faults.ALL else contextlib.nullcontext()):
        r.setup()
        r.window(seconds)
    r.release()
    numbers = (r.control(mode) if kind == "control" and not option
               else r.check())
    if ranks is not None:
        ranks.barrier()             # the others wait for rank 0's check
    return numbers


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="unchanged,half_batch,altered")
    ap.add_argument("--window-seconds", type=float, default=0.0)
    ap.add_argument("--out", required=True)
    sys.path.insert(0, str(REPO))
    from portbench import ranks, run as runner
    runner.add_test_arguments(ap)
    ranks.add_arguments(ap)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    bench = runner.bench_of(args)
    chips = bench.cell(args.workload)["chips"]
    runs = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds] + \
        [(f, s) for f in args.faults.split(",") if f
         for s in args.fault_seeds]
    deadline = max(len(runs), 1) * (args.window_seconds
                                    + ranks.SETUP_ALLOWANCE)
    if chips > 1 and args.rank is None:
        sys.stdout.write(runner.launched(__file__, argv, chips, deadline))
        return
    runner.prepare(args, chips)
    import torch
    group = runner.join(args, deadline)
    rank = 0 if group is None else group.rank
    device = (torch.device("cuda", rank) if args.device == "cuda"
              else torch.device("cpu"))
    out = {"workload": args.workload}
    try:
        for kind, seed in runs:
            t0 = time.perf_counter()
            numbers = reading(bench, args.workload, seed, device,
                              args.window_seconds, kind, group)
            out.setdefault(kind, {})[seed] = numbers
            if rank == 0:
                print(f"{kind} seed {seed} ({time.perf_counter() - t0:.1f} "
                      "s): " + ", ".join(f"{k} {v!r}"
                                         for k, v in numbers.items()),
                      flush=True)
    except Exception:  # noqa: BLE001 - a rank's boundary: report, leave
        if group is None:
            raise
        traceback.print_exc()
        ranks.leave(1)
    if group is not None:
        group.close()
    if rank == 0:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
