"""Build and bind the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source has a plain C interface (no PyTorch headers), so ``nvcc``
takes seconds. The sources compile in parallel, one ``nvcc`` each, and
link into one shared library under ``<repo>/build/kernels/<hash>/``,
keyed by a hash of the sources and flags: the first call that needs a
kernel builds it, later calls (and later processes) load the cached
library. The library is loaded with ``ctypes``; every entry point takes
device pointers, sizes and the CUDA stream as plain integers and returns
``cudaGetLastError()`` after its launch.

No ``--use_fast_math``: flushing denormals would break the bitwise
parity with the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.obs.profiler import record_build

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]
LIB_NAME = "libislabel_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types (pointers and the stream as c_void_p, so
# ctypes does not cut them to 32 bits)
SIGNATURES = {
    "islabel_label_intersect": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I,
                                _I, _P],
    "islabel_label_intersect_packed": [_P, _P, _P, _P, _I, _P, _P, _P, _P,
                                       _I, _P, _I, _I, _I, _I, _P],
    "islabel_spmv_relax": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                           _I, _P],
    "islabel_fused_relax": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P],
    "islabel_minplus_matmul": [_P, _P, _P, _I, _I, _I, _P],
}

_LIB = None


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Key of the build: the flags, and every source and header."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the library; returns
    its path. A no-op when the library for these sources exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    try:
        for src in sources():
            cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        objs = [str(tmp / f"{src.stem}.o") for src in sources()]
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o",
                               str(tmp / LIB_NAME), *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (out_dir / "ptxas.log").write_text("\n".join(logs))
        os.replace(tmp / LIB_NAME, lib)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load():
    """The kernel library (built on first use), with typed entry points."""
    global _LIB
    if _LIB is None:
        record_build("kernel_library")
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.islabel_error_string.argtypes = [ctypes.c_int]
        lib.islabel_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(name: str, *args) -> None:
    """Call one entry point on the current stream; raise on a launch
    error. Tensor arguments pass their device pointers."""
    lib = load()
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands on several devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*conv, stream)
    if err:
        msg = lib.islabel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    """Validate a kernel operand: a contiguous CUDA tensor of the given
    type and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be {dtype} with {ndim} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
