"""HPO-B dataset loading, natively or with ``json``
(``aline_tpu/tasks/hpob_native.py``).

The native path is a CPython extension, ``csrc/hpob_loader.cpp``: it
parses the numeric payload of an HPO-B file straight into float64
buffers, without the nested lists of Python floats that ``json.load``
builds.  It is compiled by the host's ``g++`` at first use into
``aline_tpu_torch/build/`` (``ops/_build.py`` ``build_host``).  Both
paths return the same arrays, bit for bit: each number is read as a
double (``strtod``, Python's float) and then rounded to float32.

Unlike the JAX package, which falls back to ``json`` when its extension
is absent, a failed build here raises with the compiler's output;
``native=False`` is the explicit ``json`` path.
"""
from __future__ import annotations

import functools
import importlib.machinery
import importlib.util
import json
from typing import Dict, Tuple

import numpy as np

from aline_tpu_torch.ops import _build

EXTENSION = "hpob_loader"


@functools.cache
def _import(path: str):
    loader = importlib.machinery.ExtensionFileLoader("hpob_native", path)
    spec = importlib.util.spec_from_file_location("hpob_native", path,
                                                  loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def native_module():
    """The built extension (built now if it is not); raises RuntimeError
    with the compiler's output when the build fails."""
    return _import(str(_build.build_host(EXTENSION)))


def native_available() -> bool:
    """Whether the extension builds and loads on this host."""
    try:
        native_module()
    except (RuntimeError, ImportError):
        return False
    return True


def load_hpob_arrays(path: str, native: bool = True
                     ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{dataset_id: (X [n, d] float32, y [n, 1] float32)} of one file, in
    the file's order: by the extension, or with ``json`` when ``native``
    is false."""
    if not native:
        with open(path) as f:
            data = json.load(f)
        return {did: (np.asarray(v["X"], np.float32),
                      np.asarray(v["y"], np.float32).reshape(-1, 1))
                for did, v in data.items()}
    out = {}
    for did, ((xr, xc), xb, (yr, yc), yb) in native_module().load(
            path).items():
        X = np.frombuffer(xb, dtype=np.float64).reshape(xr, xc)
        y = np.frombuffer(yb, dtype=np.float64).reshape(yr, yc)
        # as the json path: every y value a row of its own
        out[did] = (X.astype(np.float32), y.astype(np.float32).reshape(-1, 1))
    return out
