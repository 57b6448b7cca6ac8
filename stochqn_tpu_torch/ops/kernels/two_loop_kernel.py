"""The collapsed two-loop direction kernel and its plain PyTorch version.

``direction_streamed(s_mem, y_mem, grad, c, gamma)`` computes

    d = gamma * g + W^T (C (W g)),   W = [s_mem; y_mem]  ([2m, n])

the Hopper port of ``stochqn_tpu/ops/pallas/two_loop_kernel.py``'s
``direction_streamed``.  The kernel is CUDA C++
(``stochqn_tpu_torch/csrc/direction_streamed.cu``; its header says what
bounds it and how it is built), compiled by ``nvcc`` for ``sm_90a`` at
first use into ``stochqn_tpu_torch/build/<source hash>/`` and loaded with
ctypes.

The wrapper checks its arguments, then dispatches on the device: CPU
tensors go to :func:`direction_streamed_ref`, CUDA tensors to the kernel.
There is no fallback: a CUDA call that cannot launch the kernel raises.
:data:`LAUNCHES` counts kernel launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

# Kernel launches made by :func:`direction_streamed` (one per direction).
LAUNCHES = 0

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build"
_SOURCES = ("direction_streamed.cu",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_STORAGE = (torch.float32, torch.bfloat16)
_MAX_MEM = 32                 # sqn_direction_max_mem() in the source
_PARTIAL_COLS = 1024          # columns per pass-1 block, at least
_MAX_PARTIALS = 1024          # pass-1 blocks, at most

_lib = None
# (seconds, nvcc output) of the build this process made; None if the
# library was already built.
build_log = None


def direction_streamed_ref(s_mem: torch.Tensor, y_mem: torch.Tensor,
                           grad: torch.Tensor, c: torch.Tensor,
                           gamma: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same math with the pairs upcast to
    float32 and float32 accumulation."""
    w = torch.cat([s_mem, y_mem], dim=0).to(torch.float32)
    u = c @ (w @ grad)
    return gamma * grad + u @ w


def _check(s_mem, y_mem, grad, c, gamma):
    tensors = (s_mem, y_mem, grad, c, gamma)
    dev = s_mem.device
    if any(t.device != dev for t in tensors):
        raise ValueError("direction_streamed: all tensors must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if s_mem.dtype not in _STORAGE or y_mem.dtype != s_mem.dtype:
        raise TypeError("direction_streamed: s_mem and y_mem must both be "
                        f"float32 or both bfloat16, got {s_mem.dtype}, "
                        f"{y_mem.dtype}")
    for name, t in (("grad", grad), ("c", c), ("gamma", gamma)):
        if t.dtype != torch.float32:
            raise TypeError(f"direction_streamed: {name} must be float32, "
                            f"got {t.dtype}")
    if s_mem.dim() != 2 or y_mem.shape != s_mem.shape:
        raise ValueError("direction_streamed: s_mem and y_mem must be "
                         f"[m, n] alike, got {tuple(s_mem.shape)}, "
                         f"{tuple(y_mem.shape)}")
    m, n = s_mem.shape
    if not 1 <= m <= _MAX_MEM or n < 1:
        raise ValueError(f"direction_streamed: need 1 <= m <= {_MAX_MEM} "
                         f"and n >= 1, got m={m}, n={n}")
    if grad.shape != (n,) or c.shape != (2 * m, 2 * m) or gamma.numel() != 1:
        raise ValueError(
            f"direction_streamed: expected grad [{n}], c [{2 * m}, {2 * m}] "
            f"and a one-element gamma, got {tuple(grad.shape)}, "
            f"{tuple(c.shape)}, {tuple(gamma.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("direction_streamed: tensors must be contiguous")


def direction_streamed(s_mem: torch.Tensor, y_mem: torch.Tensor,
                       grad: torch.Tensor, c: torch.Tensor,
                       gamma: torch.Tensor) -> torch.Tensor:
    """``gamma * grad + W^T (c @ (W grad))`` with ``W = [s_mem; y_mem]``.

    ``s_mem``/``y_mem`` ``[m, n]`` float32 or bfloat16; ``grad`` ``[n]``,
    ``c`` ``[2m, 2m]`` and the one-element ``gamma`` float32; all
    contiguous and on one device.  Returns ``d [n]`` float32.
    """
    global LAUNCHES
    _check(s_mem, y_mem, grad, c, gamma)
    if s_mem.device.type == "cpu":
        return direction_streamed_ref(s_mem, y_mem, grad, c, gamma)
    if s_mem.device.type != "cuda":
        raise ValueError("direction_streamed: CPU or CUDA tensors only, "
                         f"got {s_mem.device}")
    m, n = s_mem.shape
    num_partials = min(-(-n // _PARTIAL_COLS), _MAX_PARTIALS)
    fn = _library().sqn_direction_streamed
    with torch.cuda.device(s_mem.device):
        d = torch.empty(n, dtype=torch.float32, device=s_mem.device)
        scratch = torch.empty((num_partials + 1) * 2 * m,
                              dtype=torch.float32, device=s_mem.device)
        stream = torch.cuda.current_stream(s_mem.device).cuda_stream
        err = fn(s_mem.data_ptr(), y_mem.data_ptr(),
                 int(s_mem.dtype == torch.bfloat16), grad.data_ptr(),
                 c.data_ptr(), gamma.data_ptr(), d.data_ptr(),
                 scratch.data_ptr(), m, n, num_partials, stream)
    if err != 0:
        raise RuntimeError(f"direction_streamed: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return d


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("direction_streamed: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernel is built from source at first use")


def build() -> Path:
    """Compile the kernel library unless the current sources are built, and
    return its path (``build/<hash of sources and flags>/``).

    The build writes to a temporary file and renames it into place, so
    concurrent builders never load a half-written library.
    """
    global build_log
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    out = _BUILD / h.hexdigest()[:16] / "libstochqn_torch_kernels.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
           *(str(_CSRC / name) for name in _SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_log = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.sqn_direction_streamed
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.sqn_direction_max_mem.restype = ctypes.c_int
        if lib.sqn_direction_max_mem() != _MAX_MEM:
            raise RuntimeError("direction_streamed: the built library "
                               "disagrees with the wrapper on the largest m")
        _lib = lib
    return _lib
