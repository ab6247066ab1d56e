"""Builds the port's CUDA kernels with nvcc and binds them with ctypes.

Each source under ``deep_recommenders_torch/csrc/`` compiles, at first use,
into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

One nvcc process per source, all started together, so the build takes as
long as the slowest file. The file name carries a hash of the source, of the
shared headers (``csrc/*.cuh``) and of the flags: an edited source or header
builds anew, an unchanged one is loaded as it is.
The build directory (``build/kernels`` at the root of the checkout) is
listed in ``.gitignore``. Every exported C function launches on the stream it
is given and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, because a refused launch never runs and a later
``torch.cuda.synchronize()`` does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")

# Every kernel source of the package, by file stem.
SOURCES = ("scatter_add_rows", "fm_interaction", "cin2d", "cin_stack",
           "flash_attention", "flash_attention_bf16", "flash_attention_wide",
           "flash_attention_wide_bf16", "flash_attention_cluster_bf16",
           "flash_attention_tma_bf16")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libraries: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
        "needed to build the kernels in deep_recommenders_torch/csrc"
    )


def build() -> Dict[str, str]:
    """Compile every source in ``SOURCES`` that is not built yet.

    Returns ``{name: compiler output}`` for the sources compiled now (with
    ``-Xptxas -v``: registers, shared memory and spills of each kernel).
    Raises ``RuntimeError`` naming every source that failed.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    pending = []
    for name in SOURCES:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               source_path(name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending.append((name, out, tmp, proc))
    logs, failed = {}, []
    for name, out, tmp, proc in pending:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build loads either
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of source ``name``, building it if needed;
    it returns a CUDA error code (``int``) unless ``restype`` says else."""
    lib = _libraries.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build()
        lib = _libraries[name] = ctypes.CDLL(path)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
