"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, which is loaded with :mod:`ctypes`. The library
lives under ``kernels/_build/<hash>/``, keyed by a hash of the sources and
the flags, so an edited source rebuilds and an unchanged tree reuses its
build. Nothing is compiled at import time: the first CUDA launch calls
:func:`library`, or a caller builds ahead with :func:`build`.

There is no ``--use_fast_math``: it would turn ``/`` into an approximate
divide and ``tanhf`` into an approximation, and the kernels must round int8
codes exactly as the plain versions do. ``-fmad=false`` keeps each multiply
and add separately rounded, as the plain versions' separate PyTorch ops (and
the JAX epilogues) round them, instead of contracting them into FMAs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libsamp_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    library: Path
    seconds: float          # compile + link time; 0.0 when reused
    compiled: bool          # False when an existing build was reused
    ptxas: tuple[str, ...]  # the register / shared-memory report lines


_lock = threading.Lock()
_info: Optional[BuildInfo] = None
_lib: Optional[ctypes.CDLL] = None
_funcs: dict[str, ctypes._CFuncPtr] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(text: str) -> tuple[str, ...]:
    keep = ("Compiling entry function", "registers", "spill")
    return tuple(line.split("ptxas info    : ")[-1].strip()
                 for line in text.splitlines()
                 if any(k in line for k in keep))


def _compile(out_dir: Path) -> tuple[str, ...]:
    cc = nvcc()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [cc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (exit {proc.returncode})\n{out}")
        report.extend(_ptxas_lines(out))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    objs = [str(out_dir / (s.stem + ".o")) for s in sources()]
    link = subprocess.run([cc, "-shared", "-o", str(out_dir / LIB_NAME),
                           *objs], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    return tuple(report)


def build() -> BuildInfo:
    """Compile the kernels unless a build of these exact sources exists."""
    global _info
    with _lock:
        if _info is not None:
            return _info
        final = BUILD_ROOT / source_hash()
        lib = final / LIB_NAME
        if lib.exists():
            report = tuple((final / "ptxas.txt").read_text().splitlines())
            _info = BuildInfo(lib, 0.0, False, report)
            return _info
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
        t0 = time.perf_counter()
        try:
            report = _compile(tmp)
            (tmp / "ptxas.txt").write_text("\n".join(report))
            try:
                os.rename(tmp, final)      # atomic publish
            except OSError:
                # fine only if a concurrent build published these sources
                if not lib.exists():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _info = BuildInfo(lib, time.perf_counter() - t0, True, report)
        return _info


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        info = build()
        with _lock:
            if _lib is None:
                _lib = ctypes.CDLL(str(info.library))
    return _lib


def function(name: str, argtypes: Sequence,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The library's C entry point ``name`` with its argument types set (a
    pointer or the stream is ``c_void_p``; without ``argtypes`` ctypes would
    pass a Python int as a 32-bit int and cut the pointer). Launchers
    return a CUDA error code (``c_int``)."""
    fn = _funcs.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _funcs[name] = fn
    return fn


def operand(kernel: str, name: str, t, dtype, device) -> torch.Tensor:
    """Validate one tensor handed to a kernel: on ``device``, of ``dtype``,
    contiguous. Raises on anything the kernel does not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, the kernel "
                         f"runs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    return t


def scalar(kernel: str, name: str, v, device) -> torch.Tensor:
    """A scalar operand as a 0-d float32 tensor on ``device`` (kernels read
    scales through a device pointer, so a recalibrated scale is data)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"{kernel}: {name} must hold one value, got "
                             f"shape {tuple(v.shape)}")
        return operand(kernel, name, v.reshape(()), torch.float32, device)
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        try:
            torch.cuda.check_error(rc)
        except torch.cuda.CudaError as err:
            raise RuntimeError(f"{kernel}: {err}") from err
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
