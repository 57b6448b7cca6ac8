"""ctypes bindings for the native C++ optimizer core.

Counterpart of :mod:`stochqn_tpu.native_backend`.  The native tier
(``native/``) implements the three state machines in header-only C++17
behind a C ABI (``native/include/stochqn_native.h``); this module builds
that library with ``g++`` at first use and wraps it in classes with the
``start`` / ``run`` surface the free-mode classes drive with
``backend="native"``: a CPU engine with per-call latency in
microseconds, the role the reference's C core and Cython bridge played.

It is this package's own copy of the bridge: importing the JAX package's
would import JAX.  The library is compiled from the same source with the
same :data:`NUMERIC_FLAGS`, so the two bridges' optimizers take the same
steps bit for bit, but into this package's build tree
(``stochqn_tpu_torch/build/native/<hash of sources and flags>/``), never
into ``native/build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_BUILD = Path(__file__).resolve().parent / "build" / "native"
_LIB_NAME = "libstochqn_native.so"

# The flags that fix the core's floating-point behaviour (-O3 with
# -march=native contracts into FMAs, -fopenmp fixes the reductions'
# structure): the JAX package's bridge builds with exactly these, and the
# two libraries agree bit for bit only while they match.
NUMERIC_FLAGS = ("-O3", "-march=native", "-fopenmp")
_FLAGS = (*NUMERIC_FLAGS, "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _sources() -> list:
    """Every file the library is compiled from: ``capi.cpp`` and the
    headers it includes."""
    return sorted(p for d in ("src", "include")
                  for p in (_NATIVE_DIR / d).glob("*")
                  if p.suffix in (".cpp", ".hpp", ".h"))


def _lib_path() -> Path:
    if not (_NATIVE_DIR / "src" / "capi.cpp").is_file():
        raise RuntimeError(
            "native C++ sources not found (backend='native' needs a source "
            f"checkout with the native/ directory; looked in {_NATIVE_DIR})")
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / h.hexdigest()[:16] / _LIB_NAME


def _build(out: Path) -> None:
    """Compile into a temporary directory beside ``out`` and rename into
    place: a concurrent process never loads a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = ["g++", *_FLAGS, f"-I{_NATIVE_DIR / 'include'}",
               str(_NATIVE_DIR / "src" / "capi.cpp"), "-o", lib]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "native library build failed:\n" + proc.stderr[-4000:])
        os.replace(lib, out)


def load_library() -> ctypes.CDLL:
    """Load the native library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _configure(lib)
            _lib = lib
        return _lib


def library_path() -> str:
    """Path of the built shared library (building it on first use), for
    programs that link against the C ABI
    (``native/include/stochqn_native.h``)."""
    load_library()
    return str(_lib_path())


def native_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _configure(lib: ctypes.CDLL) -> None:
    for suffix, real in (("f64", ctypes.c_double), ("f32", ctypes.c_float)):
        rp = ctypes.POINTER(real)
        ip = ctypes.POINTER(ctypes.c_int)
        lp = ctypes.POINTER(ctypes.c_long)
        size = ctypes.c_size_t

        f = getattr(lib, f"sqn_native_olbfgs_create_{suffix}")
        f.restype = ctypes.c_void_p
        f.argtypes = [size, size, real, real, real, ctypes.c_int]
        f = getattr(lib, f"sqn_native_olbfgs_run_{suffix}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, size, real, rp, rp, rp, ip, ip, lp]

        f = getattr(lib, f"sqn_native_sqn_create_{suffix}")
        f.restype = ctypes.c_void_p
        f.argtypes = [size, size, size, real, real, ctypes.c_int,
                      ctypes.c_int]
        f = getattr(lib, f"sqn_native_sqn_run_{suffix}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, size, real, rp, rp, rp, rp, rp, ip,
                      ip, lp]

        f = getattr(lib, f"sqn_native_adaqn_create_{suffix}")
        f.restype = ctypes.c_void_p
        f.argtypes = [size, size, size, size, real, real, real, real, real,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
        f = getattr(lib, f"sqn_native_adaqn_run_{suffix}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, size, real, rp, rp, real, rp, ip, ip,
                      lp]

        for kind in ("olbfgs", "sqn", "adaqn"):
            f = getattr(lib, f"sqn_native_{kind}_destroy_{suffix}")
            f.restype = None
            f.argtypes = [ctypes.c_void_p]


class _NativeBase:
    """The ctypes plumbing the three native optimizers share: the numpy
    buffers the C core reads and writes (``x``, ``gradient``, ``req_out``;
    SQN adds ``hess_vec`` and ``req_vec_out``), allocated once by
    ``start`` and bound to the run function as pointers."""

    kind = None  # "olbfgs" | "sqn" | "adaqn"

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)
        if self.dtype == np.float64:
            self._sfx, self._real = "f64", ctypes.c_double
        elif self.dtype == np.float32:
            self._sfx, self._real = "f32", ctypes.c_float
        else:
            raise ValueError("the native backend takes float32 or float64, "
                             f"got {self.dtype}")
        self._lib = load_library()
        self._handle = None
        self._n = None

    def _fn(self, op):
        return getattr(self._lib, f"sqn_native_{self.kind}_{op}_{self._sfx}")

    def _alloc_buffers(self, x0) -> None:
        x0 = np.asarray(x0, self.dtype).reshape(-1)
        self._n = x0.shape[0]
        self.x = x0.copy()
        self.gradient = np.zeros(self._n, dtype=self.dtype)
        self.req_out = np.zeros(self._n, dtype=self.dtype)
        self._info = ctypes.c_int(0)
        self._changed = ctypes.c_int(0)
        self._niter = ctypes.c_long(0)
        # bound once: the buffers never move after start()
        self._run_fn = self._fn("run")
        self._out_refs = (ctypes.byref(self._info),
                          ctypes.byref(self._changed),
                          ctypes.byref(self._niter))

    def _created(self, handle) -> None:
        if not handle:
            raise ValueError("invalid native optimizer parameters")
        self._handle = handle

    def _ptr(self, arr):
        return arr.ctypes.data_as(ctypes.POINTER(self._real))

    def _result(self, task):
        return (task, self._info.value, bool(self._changed.value),
                self.req_out, getattr(self, "req_vec_out", None))

    @property
    def niter(self) -> int:
        return int(self._niter.value)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._fn("destroy")(self._handle)
            self._handle = None


class NativeOLBFGS(_NativeBase):
    kind = "olbfgs"

    def __init__(self, mem_size=10, hess_init=0.0, min_curvature=1e-4,
                 y_reg=0.0, check_nan=True, dtype=np.float64):
        super().__init__(dtype)
        self._args = (mem_size, hess_init, min_curvature, y_reg,
                      int(check_nan))

    def start(self, x0) -> None:
        self._alloc_buffers(x0)
        mem_size, hess_init, min_curv, y_reg, check_nan = self._args
        r = self._real
        self._created(self._fn("create")(
            self._n, mem_size, r(hess_init), r(min_curv), r(y_reg),
            check_nan))
        self._run_args = (self._handle, self._n, self._ptr(self.x),
                          self._ptr(self.gradient), self._ptr(self.req_out))

    def run(self, step_size):
        h, n, xp, gp, rp = self._run_args
        return self._result(self._run_fn(h, n, self._real(step_size), xp, gp,
                                         rp, *self._out_refs))


class NativeSQN(_NativeBase):
    kind = "sqn"

    def __init__(self, mem_size=10, upd_freq=20, min_curvature=1e-4,
                 y_reg=0.0, use_grad_diff=False, check_nan=True,
                 dtype=np.float64):
        super().__init__(dtype)
        self._args = (mem_size, upd_freq, min_curvature, y_reg,
                      int(use_grad_diff), int(check_nan))

    def start(self, x0) -> None:
        self._alloc_buffers(x0)
        self.hess_vec = np.zeros(self._n, dtype=self.dtype)
        self.req_vec_out = np.zeros(self._n, dtype=self.dtype)
        mem, upd, mc, yr, ugd, cn = self._args
        self._created(self._fn("create")(
            self._n, mem, upd, self._real(mc), self._real(yr), ugd, cn))
        self._run_args = (self._handle, self._n, self._ptr(self.x),
                          self._ptr(self.gradient), self._ptr(self.hess_vec),
                          self._ptr(self.req_out),
                          self._ptr(self.req_vec_out))

    def run(self, step_size):
        h, n, xp, gp, hp, rp, rvp = self._run_args
        return self._result(self._run_fn(h, n, self._real(step_size), xp, gp,
                                         hp, rp, rvp, *self._out_refs))


class NativeAdaQN(_NativeBase):
    kind = "adaqn"

    def __init__(self, mem_size=10, fisher_size=100, upd_freq=20,
                 max_incr=1.01, min_curvature=1e-4, scal_reg=1e-4,
                 rmsprop_weight=0.0, y_reg=0.0, use_grad_diff=False,
                 check_nan=True, h0_exact_reference=True, dtype=np.float64):
        super().__init__(dtype)
        self._args = (mem_size, fisher_size, upd_freq, max_incr,
                      min_curvature, scal_reg, rmsprop_weight, y_reg,
                      int(use_grad_diff), int(check_nan),
                      int(h0_exact_reference))
        self.f = 0.0

    def start(self, x0) -> None:
        self._alloc_buffers(x0)
        (mem, fs, upd, mi, mc, sr, rw, yr, ugd, cn, h0ref) = self._args
        r = self._real
        self._created(self._fn("create")(
            self._n, mem, fs, upd, r(mi), r(mc), r(sr), r(rw), r(yr), ugd,
            cn, h0ref))
        self._run_args = (self._handle, self._n, self._ptr(self.x),
                          self._ptr(self.gradient), self._ptr(self.req_out))

    def run(self, step_size):
        h, n, xp, gp, rp = self._run_args
        return self._result(self._run_fn(h, n, self._real(step_size), xp, gp,
                                         self._real(self.f), rp,
                                         *self._out_refs))
