"""Build the package's CUDA kernels at first use and load them with ctypes.

Each source under ``aline_tpu_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, so an edited source is
rebuilt and a built one is reused.  Libraries go to
``aline_tpu_torch/build/`` (git-ignored); ``nvcc``'s output, including
the registers and shared memory that ``-Xptxas -v`` reports, is kept
beside each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel library name → its C entry point's argtypes and restype
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "gmm_head_fwd": ([_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P], _I),
    "gmm_head_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
                     _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "aline_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; raise with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, paths[name])   # atomic: readers see whole files
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` with its entry point typed."""
    lib = ctypes.CDLL(str(build([name])[name]))
    argtypes, restype = SIGNATURES[name]
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype
    return lib
