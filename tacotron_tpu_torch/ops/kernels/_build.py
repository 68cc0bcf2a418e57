"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface and loaded with ``ctypes``; no PyTorch header is included, which
keeps a build to seconds.  Libraries go to ``tacotron_tpu_torch/build/`` (not
committed) at first use and are rebuilt when a source or a shared header in
``csrc/`` is newer than the library.  :func:`build` starts one ``nvcc`` per
out-of-date source, all at once, and waits for all of them.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` (or, for the GEMM kernels,
a tensor-map encoding error); :func:`check` raises on a nonzero value.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

#: kernel library name -> its source under csrc/
SOURCES = {"ola": "ola.cu", "gl_fused": "gl_fused.cu",
           "griffin_lim": "griffin_lim.cu", "gru": "gru.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas resource report of the last build of each library
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
            "tacotron_tpu_torch/csrc at first use")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC_DIR.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return newest > lib.stat().st_mtime


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the given libraries (default: all) that are out of date, in
    parallel.  Returns {name: seconds} for the ones compiled."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


#: what a C entry point returns, above this, when a TMA tensor map cannot be
#: encoded (wg::MAP_ERROR in csrc/wgmma_gemm.cuh): MAP_ERROR + the CUresult
MAP_ERROR = 100000


def check(err: int, what: str) -> None:
    if err >= MAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {err}")


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
