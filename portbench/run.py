"""Run one benchmark cell once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's parts by the names ``BENCHMARK.json`` gives them, sets
up, measures for ``--seconds``, with ``--trace 1`` profiles a slice, then
checks the program's output against the plain reference.  The last lines
of standard error give each number compared beside its limit; the last
line of standard output is the result as one JSON object.  Exits with 2,
printing no result, where there is no card, the cell asks for more cards
than there are, or the program cannot be imported; with 3 where a module
of JAX or of the JAX package was loaded; with 1 on any other failure.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".portbench_cache"


def fail(code: int, message: str) -> None:
    print(message, file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of a run lives at a fixed place in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(REPO))
    import torch
    from portbench import harness

    bench = harness.Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        fail(2, "no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < cell["chips"]:
        fail(2, f"{args.workload} needs {cell['chips']} cards, "
                f"{torch.cuda.device_count()} found")
    try:
        import stochqn_tpu_torch  # noqa: F401
    except ImportError as err:
        fail(2, f"the program under test does not import: {err}")

    ctx = harness.Context(bench, args.workload, args.seed,
                          torch.device("cuda", 0))
    ctx.t_start = T_START
    tf32 = bool(ctx.cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        result, notes = harness.run_cell(ctx, args.seconds, bool(args.trace))
    except Exception:  # noqa: BLE001 - the run's boundary: report, no result
        traceback.print_exc()
        fail(1, f"{args.workload}: the run failed")
    loaded = harness.forbidden_modules()
    if loaded:
        fail(3, f"modules of JAX or the JAX package were loaded: {loaded}")
    for line in notes:
        print(line, file=sys.stderr)
    print(f"memory peak: {result['device']['memory_peak_bytes']} bytes; "
          f"attempted {result['attempted']}, failed {result['failed']}",
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
