"""The two-loop kernels and their plain PyTorch versions.

``direction_streamed(s_mem, y_mem, grad, c, gamma)`` and
``direction(s_mem, y_mem, grad, c, gamma)`` compute the collapsed SQN
direction

    d = gamma * g + W^T (C (W g)),   W = [s_mem; y_mem]  ([2m, n])

the Hopper ports of ``stochqn_tpu/ops/pallas/two_loop_kernel.py``'s
``direction_streamed`` (``csrc/direction_streamed.cu``: float32 or bfloat16
pairs of any size; one cooperative launch that parks what fits the card's
shared memory across a grid-wide barrier and reads the rest twice, the
second time from L2 as far as the card's L2 holds it) and
``direction`` (``csrc/direction.cu``: one read of ``W``, all of it parked,
float32 pairs, capped by the card's shared memory; see
:func:`direction_fits`).

``project(s_mem, y_mem, grad)`` computes the uncached two-loop's projection

    W g [2m],   W W^T [2m, 2m]

in one pass, the port of the Pallas ``project`` (``csrc/project.cu``: tiles
through a ring of ``cp.async`` buffers that staging warps keep full,
``W W^T`` in 8 x 8 register patches, both launches programmatic dependents;
``csrc/projection.cuh`` holds what it shares with
``csrc/project_adaqn.cu``).

``project_adaqn(s_mem, y_mem, diag, grad)`` computes adaQN's projection

    W g [2m],   (Y o D) g [m],   (Y o D) Y^T [m, m],   D = diag(diag)

in one pass, the port of the Pallas ``project_adaqn``
(``csrc/project_adaqn.cu``).

Each source's header says what bounds its kernel and how it is designed.
The sources are compiled by ``nvcc`` for ``sm_90a`` at first use, one
``nvcc`` per source started together, linked into one library under
``stochqn_tpu_torch/build/<source hash>/`` and loaded with ctypes.  The
library also holds the grouped product of a mixture of experts
(``csrc/grouped_mm.cu``), which :mod:`.grouped_mm` wraps.

Each wrapper checks its arguments, then dispatches on the device: CPU
tensors go to its plain version, CUDA tensors to the kernel.  There is no
fallback: a CUDA call that cannot launch the kernel raises.
:data:`LAUNCHES`, :data:`DIRECTION_LAUNCHES`, :data:`PROJECT_LAUNCHES` and
:data:`PROJECT_ADAQN_LAUNCHES` count kernel launches, so a run can show
that its main path went through the kernels.  Each launch of
:func:`direction_streamed` also adds its split of ``W``'s bytes
(:func:`direction_streamed_split`) to the port's counters
``direction_parked_bytes``, ``direction_l2_held_bytes`` and
``direction_reread_bytes`` (:mod:`stochqn_tpu_torch.utils.metrics`).  A
wrapper called while its stream is captured into a CUDA graph launches
nothing then: it records the launch in :data:`CAPTURED` and its bytes in
:data:`CAPTURED_COUNTS`, and the graph's owner counts both at every replay
(:func:`count_replay`; :mod:`stochqn_tpu_torch.graphs`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from stochqn_tpu_torch.utils import metrics

# Kernel launches made by :func:`direction_streamed` (one per direction).
LAUNCHES = 0
# Kernel launches made by :func:`direction` (one per direction).
DIRECTION_LAUNCHES = 0
# Kernel launches made by :func:`project` (one per projection).
PROJECT_LAUNCHES = 0
# Kernel launches made by :func:`project_adaqn` (one per projection).
PROJECT_ADAQN_LAUNCHES = 0
# Kernel launches made by ``ops.kernels.grouped_mm`` (one per product).
GROUPED_MM_LAUNCHES = 0
# Launches recorded into the CUDA graph being captured, by counter name:
# they run, and are counted, at each replay of the graph.
CAPTURED: dict = {}
# Bytes recorded into the CUDA graph being captured, by the name of the
# counter of :data:`stochqn_tpu_torch.utils.metrics.COUNTERS` they add to
# at each replay of the graph.
CAPTURED_COUNTS: dict = {}
_COUNTERS = ("LAUNCHES", "DIRECTION_LAUNCHES", "PROJECT_LAUNCHES",
             "PROJECT_ADAQN_LAUNCHES", "GROUPED_MM_LAUNCHES")


def _launched(counter: str, **counts: int) -> None:
    """Count one launch of a kernel and add ``counts`` to the port's
    counters by name, or record both in :data:`CAPTURED` and
    :data:`CAPTURED_COUNTS` where the current stream is being captured."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[counter] = CAPTURED.get(counter, 0) + 1
        for name, k in counts.items():
            CAPTURED_COUNTS[name] = CAPTURED_COUNTS.get(name, 0) + k
    else:
        globals()[counter] += 1
        for name, k in counts.items():
            metrics.count(name, k)


def count_replay(captured: dict, counts: dict = None) -> None:
    """Count the launches a graph holds (``captured``, as
    :data:`CAPTURED` was after its capture) and add its ``counts`` (as
    :data:`CAPTURED_COUNTS` was) for one replay of it."""
    for counter, k in captured.items():
        globals()[counter] += k
    for name, k in (counts or {}).items():
        metrics.count(name, k)


def read_launches() -> dict:
    """Every launch count, by counter name."""
    return {c: globals()[c] for c in _COUNTERS}

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build"
_SOURCES = ("direction_streamed.cu", "direction.cu", "project.cu",
            "project_adaqn.cu", "grouped_mm.cu")
_HEADERS = ("projection.cuh",)    # included by sources: hashed, not compiled
_COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                  "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
_STORAGE = (torch.float32, torch.bfloat16)
_MAX_MEM = 32                 # every kernel's largest m

_lib = None
# (seconds, nvcc output) of the library's build, set by :func:`build`: the
# output holds ptxas's report of every kernel's registers and spills.  The
# seconds are None where the library was already built; the output is then
# read from the file the build left beside it.
build_log = None


def direction_streamed_ref(s_mem: torch.Tensor, y_mem: torch.Tensor,
                           grad: torch.Tensor, c: torch.Tensor,
                           gamma: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same math with the pairs upcast to
    float32 and float32 accumulation."""
    w = torch.cat([s_mem, y_mem], dim=0).to(torch.float32)
    u = c @ (w @ grad)
    return gamma * grad + u @ w


def _check(name, storage, s_mem, y_mem, grad, c, gamma):
    """Argument checks of both direction wrappers; ``storage`` lists the
    pair dtypes ``name`` takes.  ``grad`` is float32 (the wrapper has
    upcast any other dtype it takes)."""
    tensors = (s_mem, y_mem, grad, c, gamma)
    dev = s_mem.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if s_mem.dtype not in storage or y_mem.dtype != s_mem.dtype:
        kinds = " or both ".join(str(t)[6:] for t in storage)
        raise TypeError(f"{name}: s_mem and y_mem must both be {kinds}, "
                        f"got {s_mem.dtype}, {y_mem.dtype}")
    for what, t in (("grad", grad), ("c", c), ("gamma", gamma)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, "
                            f"got {t.dtype}")
    if s_mem.dim() != 2 or y_mem.shape != s_mem.shape:
        raise ValueError(f"{name}: s_mem and y_mem must be "
                         f"[m, n] alike, got {tuple(s_mem.shape)}, "
                         f"{tuple(y_mem.shape)}")
    m, n = s_mem.shape
    if not 1 <= m <= _MAX_MEM or n < 1:
        raise ValueError(f"{name}: need 1 <= m <= {_MAX_MEM} "
                         f"and n >= 1, got m={m}, n={n}")
    if grad.shape != (n,) or c.shape != (2 * m, 2 * m) or gamma.numel() != 1:
        raise ValueError(
            f"{name}: expected grad [{n}], c [{2 * m}, {2 * m}] "
            f"and a one-element gamma, got {tuple(grad.shape)}, "
            f"{tuple(c.shape)}, {tuple(gamma.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: CPU or CUDA tensors only, got {t.device}")
    return t.device.type == "cuda"


def direction_streamed(s_mem: torch.Tensor, y_mem: torch.Tensor,
                       grad: torch.Tensor, c: torch.Tensor,
                       gamma: torch.Tensor) -> torch.Tensor:
    """``gamma * grad + W^T (c @ (W grad))`` with ``W = [s_mem; y_mem]``.

    ``s_mem``/``y_mem`` ``[m, n]`` float32 or bfloat16; ``grad`` ``[n]``
    float32 or bfloat16; ``c`` ``[2m, 2m]`` and the one-element ``gamma``
    float32; all contiguous and on one device.  Returns ``d [n]`` float32.

    A bfloat16 ``grad`` (a bfloat16 iterate's) is upcast to float32 here,
    exactly, before the kernel or the plain version sees it: the Pallas
    wrapper's own ``grad.astype(jnp.float32)``.  That is one more pass
    over ``grad`` (2n bytes read, 4n written), which a load templated on
    the gradient's type inside the kernel would save.
    """
    if grad.dtype == torch.bfloat16:
        grad = grad.float()
    _check("direction_streamed", _STORAGE, s_mem, y_mem, grad, c, gamma)
    if not _on_cuda("direction_streamed", s_mem):
        return direction_streamed_ref(s_mem, y_mem, grad, c, gamma)
    m, n = s_mem.shape
    bf16 = int(s_mem.dtype == torch.bfloat16)
    lib = _library()
    with torch.cuda.device(s_mem.device):
        d = torch.empty(n, dtype=torch.float32, device=s_mem.device)
        scratch = torch.empty(lib.sqn_direction_streamed_scratch(m, n, bf16),
                              dtype=torch.float32, device=s_mem.device)
        stream = torch.cuda.current_stream(s_mem.device).cuda_stream
        err = lib.sqn_direction_streamed(
            s_mem.data_ptr(), y_mem.data_ptr(), bf16, grad.data_ptr(),
            c.data_ptr(), gamma.data_ptr(), d.data_ptr(), scratch.data_ptr(),
            m, n, stream)
    if err != 0:
        raise RuntimeError(f"direction_streamed: kernel launch failed with "
                           f"CUDA error {err}")
    col_bytes = 2 * m * s_mem.element_size()
    parked, held, reread = _split(m, n, bf16, s_mem.device.index)
    _launched("LAUNCHES", direction_parked_bytes=parked * col_bytes,
              direction_l2_held_bytes=held * col_bytes,
              direction_reread_bytes=reread * col_bytes)
    return d


@functools.lru_cache(maxsize=None)
def _split(m: int, n: int, bf16: int, device_index: int) -> tuple:
    with torch.cuda.device(device_index):
        split = (ctypes.c_longlong * 3)()
        _library().sqn_direction_streamed_split(m, n, bf16, split)
        return tuple(split)


def direction_streamed_split(m: int, n: int, storage: torch.dtype,
                             device: torch.device) -> dict:
    """How a launch of :func:`direction_streamed` on the CUDA ``device``
    treats the ``n`` columns of ``[2m, n]`` pairs stored as ``storage``,
    worked out by the kernel's source from the device's properties:
    ``parked``, the columns kept in shared memory between the kernel's two
    uses of them (read from global memory once); ``l2_held``, those read
    again from L2, where the first read left them while it copied the rest
    under the L2 policy evict_first; ``reread``, those read again from
    device memory.  The three add up to ``n``."""
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    parked, held, reread = _split(m, n, int(storage == torch.bfloat16),
                                  index)
    return {"parked": parked, "l2_held": held, "reread": reread}


def direction_streamed_parked(m: int, n: int, storage: torch.dtype,
                              device: torch.device) -> int:
    """How many of the ``n`` columns of ``[2m, n]`` pairs stored as
    ``storage`` :func:`direction_streamed` keeps in shared memory between
    its two uses of them on the CUDA ``device`` (the rest is read twice):
    :func:`direction_streamed_split`'s ``parked``."""
    return direction_streamed_split(m, n, storage, device)["parked"]


def direction_ref(s_mem: torch.Tensor, y_mem: torch.Tensor,
                  grad: torch.Tensor, c: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`direction`: the same function as
    :func:`direction_streamed_ref`."""
    return direction_streamed_ref(s_mem, y_mem, grad, c, gamma)


@functools.lru_cache(maxsize=None)
def _direction_max_n(m: int, device_index: int) -> int:
    with torch.cuda.device(device_index):
        return int(_library().sqn_direction_max_n(m))


def direction_max_n(m: int, device: torch.device) -> int:
    """The largest ``n`` :func:`direction` takes for ``m`` pairs on the
    CUDA ``device``: what the shared memory of its SMs can park, worked out
    by the kernel's source from the device's properties."""
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return _direction_max_n(m, index)


def direction_fits(m: int, n: int, device: torch.device) -> bool:
    """Whether :func:`direction` takes ``[m, n]`` pairs on ``device``: any
    shape on the CPU (the plain version), ``n`` up to
    :func:`direction_max_n` on a card."""
    device = torch.device(device)
    return device.type != "cuda" or n <= direction_max_n(m, device)


def direction(s_mem: torch.Tensor, y_mem: torch.Tensor,
              grad: torch.Tensor, c: torch.Tensor,
              gamma: torch.Tensor) -> torch.Tensor:
    """``gamma * grad + W^T (c @ (W grad))`` with ``W = [s_mem; y_mem]``,
    ``W`` read from device memory once.

    ``s_mem``/``y_mem`` ``[m, n]``, ``grad`` ``[n]``, ``c`` ``[2m, 2m]`` and
    the one-element ``gamma``; all float32, contiguous and on one device.
    Returns ``d [n]`` float32.  On CUDA a shape over the card's cap
    (:func:`direction_fits`) raises: :func:`direction_streamed` has none.
    """
    _check("direction", (torch.float32,), s_mem, y_mem, grad, c, gamma)
    if not _on_cuda("direction", s_mem):
        return direction_ref(s_mem, y_mem, grad, c, gamma)
    m, n = s_mem.shape
    if not direction_fits(m, n, s_mem.device):
        raise ValueError(
            f"direction: m={m}, n={n} is over what this card's shared "
            f"memory parks (n <= {direction_max_n(m, s_mem.device)}); "
            "direction_streamed takes any size")
    lib = _library()
    with torch.cuda.device(s_mem.device):
        d = torch.empty(n, dtype=torch.float32, device=s_mem.device)
        scratch = torch.empty(lib.sqn_direction_scratch(m, n),
                              dtype=torch.float32, device=s_mem.device)
        stream = torch.cuda.current_stream(s_mem.device).cuda_stream
        err = lib.sqn_direction(s_mem.data_ptr(), y_mem.data_ptr(),
                                grad.data_ptr(), c.data_ptr(),
                                gamma.data_ptr(), d.data_ptr(),
                                scratch.data_ptr(), m, n, stream)
    if err != 0:
        raise RuntimeError(f"direction: kernel launch failed with CUDA "
                           f"error {err}")
    _launched("DIRECTION_LAUNCHES")
    return d


def project_ref(s_mem: torch.Tensor, y_mem: torch.Tensor,
                grad: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``W`` formed, then two float32 products (the
    JAX package's XLA reference for the kernel)."""
    w = torch.cat([s_mem, y_mem], dim=0)
    return w @ grad, w @ w.T


def _check_projection(name, s_mem, y_mem, **vectors):
    """Argument checks of both projection wrappers; ``vectors`` are the
    ``[n]`` arguments by name."""
    tensors = (s_mem, y_mem, *vectors.values())
    dev = s_mem.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: all tensors must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if s_mem.dim() != 2 or y_mem.shape != s_mem.shape:
        raise ValueError(f"{name}: s_mem and y_mem must be [m, n] "
                         f"alike, got {tuple(s_mem.shape)}, "
                         f"{tuple(y_mem.shape)}")
    m, n = s_mem.shape
    if not 1 <= m <= _MAX_MEM or n < 1:
        raise ValueError(f"{name}: need 1 <= m <= {_MAX_MEM} and "
                         f"n >= 1, got m={m}, n={n}")
    if any(v.shape != (n,) for v in vectors.values()):
        raise ValueError(
            f"{name}: expected {' and '.join(vectors)} [{n}], got "
            f"{', '.join(str(tuple(v.shape)) for v in vectors.values())}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def project(s_mem: torch.Tensor, y_mem: torch.Tensor, grad: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(W grad [2m], W W^T [2m, 2m])`` with ``W = [s_mem; y_mem]``.

    ``s_mem``/``y_mem`` ``[m, n]`` and ``grad`` ``[n]``; all float32,
    contiguous and on one device.  Returns float32 tensors (views of one
    buffer on CUDA); the Gram is exactly symmetric there.
    """
    _check_projection("project", s_mem, y_mem, grad=grad)
    if not _on_cuda("project", s_mem):
        return project_ref(s_mem, y_mem, grad)
    m, n = s_mem.shape
    lib = _library()
    sms = _sm_count(s_mem.device.index)
    with torch.cuda.device(s_mem.device):
        out = torch.empty(2 * m + 4 * m * m, dtype=torch.float32,
                          device=s_mem.device)
        scratch = torch.empty(lib.sqn_project_scratch(m, n, sms),
                              dtype=torch.float32, device=s_mem.device)
        stream = torch.cuda.current_stream(s_mem.device).cuda_stream
        err = lib.sqn_project(s_mem.data_ptr(), y_mem.data_ptr(),
                              grad.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), m, n, sms, stream)
    if err != 0:
        raise RuntimeError(f"project: kernel launch failed with CUDA "
                           f"error {err}")
    _launched("PROJECT_LAUNCHES")
    return out[:2 * m], out[2 * m:].view(2 * m, 2 * m)


def project_adaqn_ref(s_mem: torch.Tensor, y_mem: torch.Tensor,
                      diag: torch.Tensor, grad: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``Y o D`` formed, then three float32
    products (the JAX package's XLA reference for the kernel)."""
    wg = torch.cat([s_mem, y_mem], dim=0) @ grad
    yd = y_mem * diag[None, :]
    return wg, yd @ grad, yd @ y_mem.T


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def project_adaqn(s_mem: torch.Tensor, y_mem: torch.Tensor,
                  diag: torch.Tensor, grad: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(W grad [2m], (Y o D) grad [m], (Y o D) Y^T [m, m])`` with
    ``W = [s_mem; y_mem]`` and ``D = diag(diag)``.

    ``s_mem``/``y_mem`` ``[m, n]``, ``diag`` and ``grad`` ``[n]``; all
    float32, contiguous and on one device.  Returns float32 tensors (views
    of one buffer on CUDA).
    """
    _check_projection("project_adaqn", s_mem, y_mem, diag=diag, grad=grad)
    if not _on_cuda("project_adaqn", s_mem):
        return project_adaqn_ref(s_mem, y_mem, diag, grad)
    m, n = s_mem.shape
    lib = _library()
    sms = _sm_count(s_mem.device.index)
    with torch.cuda.device(s_mem.device):
        out = torch.empty(3 * m + m * m, dtype=torch.float32,
                          device=s_mem.device)
        scratch = torch.empty(lib.adaqn_project_scratch(m, n, sms),
                              dtype=torch.float32, device=s_mem.device)
        stream = torch.cuda.current_stream(s_mem.device).cuda_stream
        err = lib.adaqn_project(s_mem.data_ptr(), y_mem.data_ptr(),
                                diag.data_ptr(), grad.data_ptr(),
                                out.data_ptr(), scratch.data_ptr(), m, n, sms,
                                stream)
    if err != 0:
        raise RuntimeError(f"project_adaqn: kernel launch failed with CUDA "
                           f"error {err}")
    _launched("PROJECT_ADAQN_LAUNCHES")
    return out[:2 * m], out[2 * m:3 * m], out[3 * m:].view(m, m)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("two_loop_kernel: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernels are built from source at first use")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once and wait for all; raise on any failure.
    Returns their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the kernel library unless the current sources are built, and
    return its path (``build/<hash of sources, headers and flags>/``).

    Each source compiles in its own ``nvcc``, all started together, and one
    more links the objects.  The build happens in a fresh temporary
    directory and the library is renamed into place, so concurrent
    builders never load a half-written one.
    """
    global build_log
    nvcc_flags = " ".join(_COMPILE_FLAGS + ("|",) + _LINK_FLAGS)
    h = hashlib.sha256(nvcc_flags.encode())
    for name in _SOURCES + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    out = _BUILD / h.hexdigest()[:16] / "libstochqn_torch_kernels.so"
    report = out.with_name("nvcc.log")
    if out.exists():
        build_log = (None, report.read_text())
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, Path(name).stem + ".o")
                for name in _SOURCES]
        log = _run([[nvcc, *_COMPILE_FLAGS, "-c", "-o", obj,
                     str(_CSRC / name)]
                    for name, obj in zip(_SOURCES, objs)])
        lib = os.path.join(tmp, out.name)
        log += _run([[nvcc, *_LINK_FLAGS, "-o", lib, *objs]])
        kept = os.path.join(tmp, report.name)
        Path(kept).write_text(log)
        os.replace(kept, report)
        os.replace(lib, out)
    build_log = (time.perf_counter() - t0, log)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.sqn_direction_streamed
        fn.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, i32,
                       ctypes.c_longlong, ptr]
        fn.restype = i32
        fn = lib.sqn_direction_streamed_scratch
        fn.argtypes = [i32, ctypes.c_longlong, i32]
        fn.restype = ctypes.c_longlong
        fn = lib.sqn_direction_streamed_split
        fn.argtypes = [i32, ctypes.c_longlong, i32,
                       ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = None
        fn = lib.adaqn_project
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, ctypes.c_longlong,
                       i32, ptr]
        fn.restype = i32
        fn = lib.adaqn_project_scratch
        fn.argtypes = [i32, ctypes.c_longlong, i32]
        fn.restype = ctypes.c_longlong
        fn = lib.sqn_direction
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                       ctypes.c_longlong, ptr]
        fn.restype = i32
        fn = lib.sqn_direction_scratch
        fn.argtypes = [i32, ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
        fn = lib.sqn_direction_max_n
        fn.argtypes = [i32]
        fn.restype = ctypes.c_longlong
        fn = lib.sqn_project
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ctypes.c_longlong, i32,
                       ptr]
        fn.restype = i32
        fn = lib.sqn_project_scratch
        fn.argtypes = [i32, ctypes.c_longlong, i32]
        fn.restype = ctypes.c_longlong
        i64 = ctypes.c_longlong
        fn = lib.grouped_mm_rows_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, i32] + [i64] * 11 + [ptr]
        fn.restype = i32
        fn = lib.grouped_mm_wgrad_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, i32] + [i64] * 6 + [ptr]
        fn.restype = i32
        lib.sqn_direction_max_mem.restype = i32
        if lib.sqn_direction_max_mem() != _MAX_MEM:
            raise RuntimeError("two_loop_kernel: the built library "
                               "disagrees with the wrappers on the largest m")
        _lib = lib
    return _lib
