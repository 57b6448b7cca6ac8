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

A cell whose ``chips`` is over 1 runs as that many ranks, one card each
(``portbench/ranks.py``): this process starts them, waits for them and
prints rank 0's result once every rank has ended well; a rank that fails,
or the deadline of ``--seconds`` plus ``ranks.SETUP_ALLOWANCE``, ends
them all and the run, with no result.  ``--device cpu`` (with ``--bench``
naming another ``BENCHMARK.json`` and ``--search`` the directories of its
cells) runs on the CPU, ranks over gloo: the benchmark's own tests.
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


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    add_test_arguments(ap)
    from portbench import ranks
    ranks.add_arguments(ap)
    return ap.parse_args(argv)


def add_test_arguments(ap) -> None:
    """``--device``, ``--bench``, ``--search``: the tests' runs on the
    CPU, on cells of their own."""
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    ap.add_argument("--bench", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--search", action="append", default=[],
                    help=argparse.SUPPRESS)


def bench_of(args):
    from portbench import harness
    return (harness.Bench() if args.bench is None else
            harness.Bench(Path(args.bench), [Path(p) for p in args.search]))


def prepare(args, chips: int) -> None:
    """The caches in the checkout, the card's and the program's presence
    (exits with 2 without them)."""
    # every cache of a run lives at a fixed place in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            fail(2, "no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < chips:
            fail(2, f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} found")
    try:
        import stochqn_tpu_torch  # noqa: F401
    except ImportError as err:
        fail(2, f"the program under test does not import: {err}")


def tail(result: dict) -> str:
    """The last lines of standard error: the peak, and each number
    compared beside its limit."""
    lines = [f"memory peak: {result['device']['memory_peak_bytes']} bytes; "
             f"attempted {result['attempted']}, failed {result['failed']}"]
    lines += [f"compared {name}: {c['value']!r} (limit {c['limit']!r})"
              for name, c in result["compared"].items()]
    lines.append(f"correct: {result['correct']}")
    return "\n".join(lines)


def launched(script: str, argv, world: int, deadline: float) -> str:
    """This process as the launcher of ``world`` ranks of ``script``:
    prints every rank's errors and returns rank 0's standard output, or
    exits as the failing rank did, printing nothing on its own."""
    from portbench import harness, ranks
    code, out, errors = ranks.launch(
        [sys.executable, script] + list(argv) + ["--t0", repr(T_START)],
        world, deadline)
    sys.stderr.write(errors)
    if code:
        fail(code, "the ranks failed: no result")
    loaded = harness.forbidden_modules()
    if loaded:
        fail(3, f"modules of JAX or the JAX package were loaded: {loaded}")
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    sys.path.insert(0, str(REPO))
    args = parse(argv)
    bench = bench_of(args)
    chips = bench.cell(args.workload)["chips"]
    if chips > 1 and args.rank is None:
        # the launcher loads neither torch nor the program, and touches no
        # card: each rank checks them, and the ranks start the sooner
        from portbench import ranks
        out = launched(__file__, argv, chips,
                       args.seconds + ranks.SETUP_ALLOWANCE)
        result = json.loads(out.strip().splitlines()[-1])
        print(tail(result), file=sys.stderr, flush=True)
        print(json.dumps(result), flush=True)
        return
    prepare(args, chips)
    run_rank(args, bench)


def join(args, timeout_s: float):
    """This rank's group (its collectives time out after ``timeout_s``),
    or None for a cell on one card."""
    if args.rank is None:
        return None
    from portbench import ranks
    return ranks.Group(args.rank, args.world, args.rendezvous, args.device,
                       timeout_s)


def run_rank(args, bench) -> None:
    """One run on this process's card (rank ``args.rank``'s, or the only
    one): prints the result where this is rank 0."""
    import torch
    from portbench import harness, ranks
    group = join(args, args.seconds + ranks.SETUP_ALLOWANCE)
    t_group = time.perf_counter()
    rank = 0 if group is None else group.rank
    device = (torch.device("cuda", rank) if args.device == "cuda"
              else torch.device("cpu"))
    ctx = harness.Context(bench, args.workload, args.seed, device,
                          ranks=group)
    ctx.t_start = T_START if args.t0 is None else args.t0
    ctx.marks.update(process=T_START, group=t_group)
    tf32 = bool(ctx.cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        result, notes = harness.run_cell(ctx, args.seconds, bool(args.trace))
    except Exception:  # noqa: BLE001 - the run's boundary: report, no result
        traceback.print_exc()
        print(f"{args.workload}: the run failed", file=sys.stderr)
        if group is not None:
            ranks.leave(1)
        sys.exit(1)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        if group is not None:
            ranks.leave(3)
        sys.exit(3)
    if group is not None:
        group.close()
    for line in notes:
        print(line, file=sys.stderr)
    if result is None:              # a rank other than 0
        return
    if group is None:
        print(tail(result), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
