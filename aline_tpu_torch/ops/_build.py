"""Build the package's CUDA kernels at first use and load them with ctypes.

Each source under ``aline_tpu_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the headers beside
it (``csrc/*.cuh``), so an edited source is rebuilt and a built one is
reused.  Libraries go to
``aline_tpu_torch/build/`` (git-ignored); ``nvcc``'s output, including
the registers and shared memory that ``-Xptxas -v`` reports, is kept
beside each library as ``<name>-<hash>.log``.

Host code goes the same way (``build_host``): a CPython extension in
``csrc/<name>.cpp`` is compiled by the host's ``g++`` against the running
Python's headers (``sysconfig``)::

    g++ -O3 -shared -fPIC -std=c++17 -I<python include> \
        -o build/<name>-<hash><EXT_SUFFIX> csrc/<name>.cpp

Every kernel call goes through ``launch``, which counts it in
``LAUNCHES``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# kernel library name → its C entry point's argtypes and restype
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
SIGNATURES = {
    "gmm_head_fwd": ([_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P], _I),
    "gmm_head_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
                     _I),
    # kcode, qrow, key_perm, row_perm, n_ctx, n_vis, n_query, dense; B, N;
    # stream
    "flash_plan": ([_P] * 8 + [_I] * 2 + [_P], _I),
    # q, k, v, the plan's six arrays, o, lse; B, H, N, Np - N, dh; scale;
    # stream
    "flash_attn_fwd": ([_P] * 11 + [_I] * 5 + [_F, _P], _I),
    # q, k, v, the plan's six arrays, o, lse, do, dq, dk, dv, delta;
    # B, H, N, dh; scale; stream
    "flash_attn_bwd": ([_P] * 16 + [_I] * 4 + [_F, _P], _I),
    # x, y, thetas, max_in, sumexp_in, max_out, sumexp_out, scratch;
    # n_valid; B, Th, K, D; base_signal, max_signal, noise_scale; stream
    "loc_eig_fold": ([_P] * 8 + [_LL] + [_I] * 4 + [_F] * 3 + [_P], _I),
    # x, y, thetas, max_in, sumexp_in, max_out, sumexp_out, scratch;
    # n_valid; B, Th; noise_scale, lower, upper; stream
    "ces_eig_fold": ([_P] * 8 + [_LL] + [_I] * 2 + [_F] * 3 + [_P], _I),
}
# other entry points of a library: library name → {entry: (argtypes, restype)}
HELPERS = {
    # the scratch floats of a call with (rows, D, C, F)
    "gmm_head_bwd": {"gmm_head_bwd_scratch": ([_LL, _I, _I, _I], _LL)},
    # the bfloat16 forms: the float32 entry's arguments, with q, k, v, o,
    # do, dq, dk and dv pointing at bfloat16 arrays
    "flash_attn_fwd": {"flash_attn_fwd_bf16": SIGNATURES["flash_attn_fwd"]},
    "flash_attn_bwd": {"flash_attn_bwd_bf16": SIGNATURES["flash_attn_bwd"]},
    # the scratch floats of a call with (n_valid, B, Th)
    "loc_eig_fold": {"loc_eig_fold_scratch": ([_LL, _I, _I], _LL)},
    "ces_eig_fold": {"ces_eig_fold_scratch": ([_LL, _I, _I], _LL)},
}

# Kernel launches since the last reset, by entry point (every entry but the
# scratch sizes); chip runs and tests read it to show that a path went
# through the kernels.
LAUNCHES = {entry: 0 for name in SIGNATURES
            for entry in (name, *HELPERS.get(name, ()))
            if not entry.endswith("_scratch")}


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
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
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
    """The built library of kernel ``name`` with its entry points typed
    (``name`` and its ``HELPERS``)."""
    lib = ctypes.CDLL(str(build([name])[name]))
    for entry, (argtypes, restype) in {name: SIGNATURES[name],
                                       **HELPERS.get(name, {})}.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def on_device(device):
    """``torch.cuda.device(device)``, or nothing where ``device`` is
    current already (the check costs less than entering the guard)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(name: str, tensors, *numbers, entry: Optional[str] = None,
           aligned: bool = False) -> None:
    """Launch entry point ``entry`` (default ``name``) of kernel library
    ``name`` on the device of ``tensors``: the tensors as device pointers,
    then ``numbers``, then the device's current stream.  Raise naming the
    entry on a nonzero cudaError; else count the launch under ``entry``.
    ``aligned``: first refuse a tensor that is not 16-byte aligned."""
    entry = entry or name
    ptrs = [t.data_ptr() for t in tensors]
    if aligned and any(p % 16 for p in ptrs):
        raise ValueError(f"a tensor argument of {entry} is not 16-byte "
                         f"aligned")
    fn = getattr(load(name), entry)
    device = tensors[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*ptrs, *numbers, stream)
    else:                               # the stream's device must be current
        with torch.cuda.device(device):
            err = fn(*ptrs, *numbers, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    LAUNCHES[entry] += 1


def host_library_path(name: str) -> Path:
    """Where ``build_host`` puts the extension of ``csrc/<name>.cpp``."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cpp").read_bytes()
                            + " ".join(HOST_FLAGS).encode()).hexdigest()
    return BUILD_DIR / (f"{name}-{digest[:12]}"
                        f"{sysconfig.get_config_var('EXT_SUFFIX')}")


def build_host(name: str) -> Path:
    """Compile the CPython extension ``csrc/<name>.cpp`` with the host's
    ``g++`` unless it is built; raise with the compiler's output on
    failure."""
    path = host_library_path(name)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {name}.cpp is built with the "
                           f"host's C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [cxx, *HOST_FLAGS, f"-I{sysconfig.get_paths()['include']}",
           str(CSRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    path.with_name(f"{path.name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}")
    os.replace(tmp, path)
    return path
