#!/usr/bin/env python3
"""The one-read ``direction`` kernel against another version of its source,
on the card: where its time goes, stage by stage, and what a change of the
source moves, kernel alone and end to end.

    python3 tools/direction_ab.py --other OLD.cu
        [--sections stages,probes,by_n,graph] [--out FILE]

``OLD.cu`` is another ``direction.cu`` with the same C interface
(``sqn_direction``, ``sqn_direction_scratch``, ``sqn_direction_max_n``),
for example a parent's: ``git show REV:stochqn_tpu_torch/csrc/direction.cu
> build/parent_direction.cu``.  Both are built here with the package's nvcc
flags.  The package's wrapper is pointed at one source or the other (its
other kernels stay the package's own), so every section runs both sources
through the same code, in turns (other, this, this, other), in one process
on one card.  Sections:

- ``stages``: each source built once more with every stage stamped with
  ``%globaltimer`` by thread 0 of each block (``SQN_STAGES_BEGIN``,
  ``SQN_STAGE(k)``, ``SQN_STAGES_END``; a source that has no such marks
  gets them at the anchors of the kernel's first version,
  :data:`OLD_ANCHORS`).  A
  one-thread kernel stamps the time just before each launch and just after
  it.  Stage k is reported as the mean over launches of the last block's
  stamp less the stamp before the launch: 0 first instruction (and the
  first block's), then what the source names (``STAGE_NAMES``), and the
  stamp after the launch.  Every stage but 0 costs one ``__syncthreads``,
  so the stamped kernel's event time is printed beside the plain one's.
  At n = 900 and 292,083, m = 10, back to back (warm) and with L2 flushed.
- ``probes``: an empty kernel launched plain and cooperatively at the
  flagship's grid and shared memory and at one small block, and one that
  passes a grid barrier: the parts of the chain no source can shorten.
- ``by_n``: both sources timed by n, warm and with L2 flushed (CUDA
  events, as ``chip_smoke.device_ms`` times them), against the plain
  version and the streamed kernel, after a check against the plain
  version.
- ``graph``: the SQN flagship (``chip_smoke``'s data and trainer) as
  ``jit_epochs`` on a CUDA graph, 20 epochs a call, iters/s in turns,
  then a profiler trace of one replay for each source: device time by
  kernel name, ``direction``'s time per launch inside the replay and its
  share of the replay's device time.

Prints one ``direction_ab:`` JSON line, and writes it to ``--out`` if
given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk  # noqa: E402

M = cs.MEM_SIZE
N_STAGE = (900, cs.N_FLAGSHIP)
N_BY_N = (900, 2001, 2004, 2007, 29_208, 146_041, cs.N_FLAGSHIP)
DIRECTION_FNS = ("sqn_direction", "sqn_direction_scratch",
                 "sqn_direction_max_n")
STAGE_NAMES = {
    "old": ("first instruction", "park landed", "partials written",
            "barrier passed", "u formed", "d stored"),
    "new": ("first instruction", "barriers armed (thread 0)",
            "copies issued", "park landed and summed", "barrier passed",
            "wg summed", "u formed", "d stored"),
}
MAX_STAGES = 8

# Where the stamps go in a source of the kernel's first version, which has
# no marks of its own: (text, replacement).
OLD_ANCHORS = (
    ("float* partials, int m, int64_t n, int cols) {",
     "float* partials, int m, int64_t n, int cols) {\n  SQN_STAGES_BEGIN"),
    ("  __pipeline_wait_prior(0);\n  __syncthreads();\n",
     "  __pipeline_wait_prior(0);\n  __syncthreads();\n  SQN_STAGE(1)\n"),
    ("  cg::this_grid().sync();\n",
     "  SQN_STAGE(2)\n  cg::this_grid().sync();\n  SQN_STAGE(3)\n"),
    ("    u[threadIdx.x] = v;\n  }\n  __syncthreads();\n",
     "    u[threadIdx.x] = v;\n  }\n  __syncthreads();\n  SQN_STAGE(4)\n"),
    ("    d[j0 + c] = fmaf(gam, gs[c], t);\n  }\n}",
     "    d[j0 + c] = fmaf(gam, gs[c], t);\n  }\n  SQN_STAGE(5)\n"
     "  SQN_STAGES_END\n}"),
)

# Prepended to a stamped source: the stamps, the marks around each launch,
# and the probes.
PRELUDE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
__device__ unsigned long long* sqn_stage_out;
__device__ int sqn_stage_row;
__device__ __forceinline__ unsigned long long sqn_now_() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SQN_STAGES_BEGIN                              \
  unsigned long long sqn_st_[MAX_STAGES] = {};        \
  if (threadIdx.x == 0) sqn_st_[0] = sqn_now_();
#define SQN_STAGE(k)                                  \
  __syncthreads();                                    \
  if (threadIdx.x == 0) sqn_st_[k] = sqn_now_();
#define SQN_MARK(k)                                   \
  if (threadIdx.x == 0) sqn_st_[k] = sqn_now_();
#define SQN_STAGES_END                                                 \
  if (threadIdx.x == 0) {                                              \
    unsigned long long* o_ =                                           \
        sqn_stage_out +                                                \
        (static_cast<long long>(sqn_stage_row) * gridDim.x + blockIdx.x) \
            * MAX_STAGES;                                              \
    for (int i_ = 0; i_ < MAX_STAGES; ++i_) o_[i_] = sqn_st_[i_];      \
  }
__global__ void sqn_stage_mark_kernel(unsigned long long* out, int row,
                                      int which) {
  out[2 * row + which] = sqn_now_();
  if (which == 0) sqn_stage_row = row;
}
__global__ void sqn_probe_kernel(unsigned long long* out, int barrier) {
  if (barrier) cooperative_groups::this_grid().sync();
  if (threadIdx.x == 0 && blockIdx.x == 0 && out) out[0] = sqn_now_();
}
extern "C" {
int sqn_stage_setup(void* out) {
  return static_cast<int>(cudaMemcpyToSymbol(sqn_stage_out, &out,
                                             sizeof(out)));
}
int sqn_stage_mark(void* out, int row, int which, void* stream) {
  sqn_stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out), row, which);
  return static_cast<int>(cudaGetLastError());
}
int sqn_probe(int blocks, int threads, int smem, int cooperative,
              int barrier, void* stream) {
  static int set = 0;
  if (!set) {
    int optin = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(sqn_probe_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    set = 1;
  }
  unsigned long long* out = nullptr;
  void* args[] = {&out, &barrier};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cooperative ? cudaLaunchCooperativeKernel(
                        reinterpret_cast<void*>(sqn_probe_kernel),
                        dim3(blocks), dim3(threads), args, smem, st)
                  : cudaLaunchKernel(reinterpret_cast<void*>(sqn_probe_kernel),
                                     dim3(blocks), dim3(threads), args, smem,
                                     st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
}
""".replace("MAX_STAGES", str(MAX_STAGES))


def stamped_source(text: str) -> tuple[str, tuple]:
    """``text`` with the stamps turned on (its own marks, or the first
    version's anchors) and the names of its stages."""
    names = STAGE_NAMES["new"]
    if "SQN_STAGES_BEGIN" not in text:
        names = STAGE_NAMES["old"]
        for old, new in OLD_ANCHORS:
            if text.count(old) != 1:
                raise SystemExit(f"direction_ab: anchor not found once: "
                                 f"{old!r}")
            text = text.replace(old, new)
    return PRELUDE + text, names


def build(sources: dict, outdir: Path) -> dict:
    """Compile each ``{label: source text}`` into its own library with the
    package's flags (one nvcc each, all at once); returns the CDLLs."""
    outdir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    nvcc = tlk._nvcc()
    for label, text in sources.items():
        src = outdir / f"{label}.cu"
        src.write_text(text)
        lib = outdir / f"lib{label}.so"
        cmds.append([nvcc, *tlk._COMPILE_FLAGS, "-shared", "-o", str(lib),
                     str(src)])
        libs[label] = lib
    log = tlk._run(cmds)
    spills = re.findall(r"(\d+) bytes spill", log)
    print(f"  built {', '.join(libs)}; spill bytes {spills}", flush=True)
    out = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for label, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.sqn_direction.argtypes = [ptr] * 7 + [i32, i64, ptr]
        lib.sqn_direction.restype = i32
        lib.sqn_direction_scratch.argtypes = [i32, i64]
        lib.sqn_direction_scratch.restype = i64
        lib.sqn_direction_max_n.argtypes = [i32]
        lib.sqn_direction_max_n.restype = i64
        if hasattr(lib, "sqn_stage_mark"):
            lib.sqn_stage_setup.argtypes = [ptr]
            lib.sqn_stage_mark.argtypes = [ptr, i32, i32, ptr]
            lib.sqn_probe.argtypes = [i32, i32, i32, i32, i32, ptr]
        out[label] = lib
    return out


class _Pointed:
    """The package's library with the direction functions of another."""

    def __init__(self, base, direction_lib):
        self._base, self._dir = base, direction_lib

    def __getattr__(self, name):
        return getattr(self._dir if name in DIRECTION_FNS else self._base,
                       name)


def use(lib):
    """Point the package's ``direction`` wrapper at ``lib`` (None: the
    package's own source)."""
    tlk._lib = None
    base = tlk._library()
    tlk._lib = base if lib is None else _Pointed(base, lib)
    tlk._direction_max_n.cache_clear()


def args_at(n, dev, gen):
    return (torch.randn(M, n, device=dev, generator=gen),
            torch.randn(M, n, device=dev, generator=gen),
            torch.randn(n, device=dev, generator=gen),
            torch.randn(2 * M, 2 * M, device=dev, generator=gen) / n,
            torch.full((), 0.7, device=dev))


def stage_split(lib, names, args, launches, flush):
    """Stamps of ``launches`` launches of ``lib``'s kernel: per stage the
    mean over launches of the last block's stamp less the mark before the
    launch, in microseconds."""
    m, n = args[0].shape
    dev = args[0].device
    blocks = max(1, lib.sqn_direction_scratch(m, n) // (2 * m))
    stamps = torch.zeros(launches * blocks * MAX_STAGES, dtype=torch.int64,
                         device=dev)
    marks = torch.zeros(2 * launches, dtype=torch.int64, device=dev)
    if lib.sqn_stage_setup(stamps.data_ptr()) != 0:
        raise RuntimeError("sqn_stage_setup failed")
    d = torch.empty(n, device=dev)
    scratch = torch.empty(max(1, lib.sqn_direction_scratch(m, n)),
                          device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args]

    def launch(i):
        if flush is not None:
            flush.zero_()
        lib.sqn_stage_mark(marks.data_ptr(), i, 0, stream)
        err = lib.sqn_direction(*ptrs, d.data_ptr(), scratch.data_ptr(), m,
                                n, stream)
        lib.sqn_stage_mark(marks.data_ptr(), i, 1, stream)
        if err != 0:
            raise RuntimeError(f"sqn_direction: CUDA error {err}")
    for i in range(3):
        launch(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.SPIN_CYCLES)
    for i in range(launches):
        launch(i)
    torch.cuda.synchronize()
    st = stamps.view(launches, blocks, MAX_STAGES).cpu().numpy()
    mk = marks.view(launches, 2).cpu().numpy()
    pre = mk[:, 0:1].astype(np.float64)
    # a stage the launch does not pass (the grid barrier of one block) is 0
    rel = np.where(st[:, :, :len(names)] > 0,
                   (st[:, :, :len(names)] - pre[:, :, None]) / 1e3, np.nan)
    out = {"blocks": int(blocks),
           "first block's first instruction":
               float(rel[:, :, 0].min(axis=1).mean())}
    for k, name in enumerate(names):
        if not np.isnan(rel[:, :, k]).all():
            out[name] = float(rel[:, :, k].max(axis=1).mean())
    out["mark after the launch"] = float(((mk[:, 1] - mk[:, 0]) / 1e3).mean())
    raw = np.unique(st[:, :, :len(names)].ravel())
    raw = raw[raw > 0]
    out["timer step ns"] = float(np.diff(raw).min()) if raw.size > 1 else None
    return out


def section_stages(libs, stage_names, dev, gen, flush):
    res = {}
    for n in N_STAGE:
        args = args_at(n, dev, gen)
        for label in ("other", "this"):
            lib = libs.get(f"{label}_stamped")
            if lib is None:
                continue
            names = stage_names[label]
            for how, fl in (("warm", None), ("flushed", flush)):
                split = stage_split(lib, names, args, 100 if fl is None
                                    else 30, fl)
                use(lib)
                stamped = cs.device_ms(lambda: tlk.direction(*args), 50, fl)
                use(libs.get(label))
                plain = cs.device_ms(lambda: tlk.direction(*args), 50, fl)
                split["event us, stamped"] = 1e3 * stamped
                split["event us, unstamped"] = 1e3 * plain
                res[f"{label} n={n} {how}"] = split
                print(f"  stages {label} n={n} {how}: " + "; ".join(
                    f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in split.items()), flush=True)
    use(None)
    return res


def section_probes(lib, dev):
    """An empty kernel, plain and cooperative, at the flagship's grid and
    shared memory and at one block; one that passes a grid barrier."""
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    big = 186 * 1024
    res = {}
    for what, blocks, threads, smem, coop, barrier in (
            ("empty, 1 block of 128, no smem", 1, 128, 0, 0, 0),
            ("empty, 1 block of 512, 186 KB", 1, 512, big, 0, 0),
            ("empty cooperative, 1 block of 512, 186 KB", 1, 512, big, 1, 0),
            ("empty, one block per SM of 512, 186 KB", sms, 512, big, 0, 0),
            ("empty cooperative, one block per SM of 512, 186 KB", sms, 512,
             big, 1, 0),
            ("grid barrier, 4 blocks of 512", 4, 512, big, 1, 1),
            ("grid barrier, one block per SM of 512, 186 KB", sms, 512, big,
             1, 1)):
        def fn():
            err = lib.sqn_probe(blocks, threads, smem, coop, barrier, stream)
            if err != 0:
                raise RuntimeError(f"probe {what}: CUDA error {err}")
        res[what] = 1e3 * cs.device_ms(fn, 200)
        print(f"  probe {what}: {res[what]:.3f} us a launch, back to back",
              flush=True)
    return res


def section_by_n(libs, dev, gen, flush):
    res = {}
    for n in N_BY_N:
        args = args_at(n, dev, gen)
        want = tlk.direction_ref(*args)
        row = {}
        for label in ("other", "this", "this", "other"):
            use(libs.get(label))
            got = tlk.direction(*args)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=cs.KERNEL_RTOL,
                                  atol=cs.KERNEL_ATOL):
                raise SystemExit(f"direction_ab: {label} n={n} disagrees "
                                 f"with the plain version: "
                                 f"{float((got - want).abs().max()):.3e}")
            row.setdefault(label, []).append(
                (1e3 * cs.device_ms(lambda: tlk.direction(*args), 50),
                 1e3 * cs.device_ms(lambda: tlk.direction(*args), 30, flush)))
        use(None)
        row["direction_streamed"] = [(
            1e3 * cs.device_ms(lambda: tlk.direction_streamed(*args), 50),
            1e3 * cs.device_ms(lambda: tlk.direction_streamed(*args), 30,
                               flush))]
        res[n] = row
        print(f"  by n, n={n}: " + "; ".join(
            f"{k} warm {'/'.join(f'{w:.2f}' for w, _ in v)} us, flushed "
            f"{'/'.join(f'{c:.2f}' for _, c in v)} us"
            for k, v in row.items()), flush=True)
    return res


def replay_trace(trainer, x0, data):
    """``chip_smoke.replay_split`` of a profiler trace of one replay of
    ``trainer``'s epoch graph (captured before the trace)."""
    from torch.profiler import ProfilerActivity, profile
    fn = trainer.jit_epochs()
    fn(trainer.init(x0), data, cs.STEP, 1, aligned=True)
    s = trainer.init(x0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(s, data, cs.STEP, 1, aligned=True)
        torch.cuda.synchronize()
    return cs.replay_split(prof.key_averages(), "direction", top=12)


def section_graph(libs, dev):
    X, Y, x0 = cs.bench_data(dev)
    x0 = x0.cpu().numpy()
    data = (X, Y)
    res = {"iters_per_s": {}, "trace": {}}
    trainers = {}
    for label in ("other", "this"):
        use(libs.get(label))
        tr = cs.sqn_trainer()
        tr.jit_epochs()(tr.init(x0), data, cs.STEP, 1, aligned=True)
        trainers[label] = tr
    epochs = cs.GRAPH_EPOCHS["sqn"]
    for label in ("other", "this", "this", "other", "other", "this"):
        use(libs.get(label))
        tr = trainers[label]
        s = tr.init(x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.jit_epochs()(s, data, cs.STEP, epochs, aligned=True)
        torch.cuda.synchronize()
        res["iters_per_s"].setdefault(label, []).append(
            epochs * cs.NUM_BATCHES / (time.perf_counter() - t0))
    for label in ("other", "this"):
        use(libs.get(label))
        tr = res["trace"][label] = replay_trace(trainers[label], x0, data)
        print(f"  graph {label}: iters/s "
              f"{', '.join(f'{v:.1f}' for v in res['iters_per_s'][label])}"
              f" (median {statistics.median(res['iters_per_s'][label]):.1f});"
              f" one replay's trace: {tr['device_us']:.1f} us of device "
              f"time, direction {tr['launches']} launches, "
              f"{tr['us_per_launch'] or 0:.3f} us each, "
              f"{100 * (tr['share'] or 0):.1f}% of the replay", flush=True)
        for k, v in tr["by_kernel_us"].items():
            print(f"    {v:10.1f} us  {k[:110]}", flush=True)
    use(None)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--sections", default="stages,probes,by_n,graph")
    ap.add_argument("--out", help="also write the JSON record here")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("direction_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.nvidia_smi()
    print(f"  nvidia-smi: {card}", flush=True)
    sections = opt.sections.split(",")
    other = Path(opt.other).read_text()
    this = (tlk._CSRC / "direction.cu").read_text()
    sources, stage_names = {"other": other}, {}
    if "stages" in sections or "probes" in sections:
        # the same source twice is stamped once
        for label, text in (("other", other), ("this", this))[
                :1 if this == other else 2]:
            sources[f"{label}_stamped"], stage_names[label] = \
                stamped_source(text)
    tlk._BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tlk._BUILD) as tmp:
        libs = build(sources, Path(tmp))
        libs["this"] = None
        gen = torch.Generator(device=dev).manual_seed(5)
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        out = {"card": card, "cap_m10": {}}
        for label in ("other", "this"):
            use(libs[label])
            out["cap_m10"][label] = tlk.direction_max_n(M, dev)
        use(None)
        print(f"  cap at m={M}: {out['cap_m10']}", flush=True)
        if "probes" in sections:
            out["probes"] = section_probes(libs["other_stamped"], dev)
        if "stages" in sections:
            out["stages"] = section_stages(libs, stage_names, dev, gen,
                                           flush)
        if "by_n" in sections:
            out["by_n"] = section_by_n(libs, dev, gen, flush)
        if "graph" in sections:
            out["graph"] = section_graph(libs, dev)
    if opt.out:
        os.makedirs(os.path.dirname(opt.out) or ".", exist_ok=True)
        Path(opt.out).write_text(json.dumps(out, indent=1))
    print("direction_ab: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
