"""The NaN guard of ``debug_nans=true`` (``train.py``'s
``jax_debug_nans``).

``nan_guard()`` raises ``FloatingPointError`` on the first floating
output of an aten op that holds a NaN, naming the op (a
``TorchDispatchMode``), and on the first NaN in a gradient
(``torch.autograd.detect_anomaly(check_nan=True)``).  Two things escape
a dispatch mode and are handled apart:

* allocation ops (``empty``, ``empty_like``, ``new_empty``, ...) return
  uninitialised memory, which may hold anything: they are not checked;
* the CUDA kernels are launched through ctypes, which no dispatch mode
  sees: their wrappers call ``check_kernel_outputs`` while the guard is
  on.

Every check reads a flag back from the device, so the guard costs a host
sync per op: a debugging mode, off by default.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ACTIVE = [0]

# ops whose outputs are not values: uninitialised memory, or collective
# buffers that fill in when the transfer completes
_SKIPPED_NAMESPACES = ("c10d", "_c10d_functional")


def _unchecked(func) -> bool:
    name = func.__name__
    return ("empty" in name.split(".")[0]
            or func.namespace in _SKIPPED_NAMESPACES)


def _first_nan(tensors) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_floating_point()
               and t.numel() and bool(torch.isnan(t).any())
               for t in tensors)


class NaNGuard(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the aten op whose floating
    output first holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _unchecked(func) and _first_nan(tree_leaves(out)):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


def guard_active() -> bool:
    return _ACTIVE[0] > 0


def check_kernel_outputs(name: str, *tensors) -> None:
    """While the guard is on, raise ``FloatingPointError`` if an output of
    kernel ``name`` holds a NaN."""
    if guard_active() and _first_nan(tensors):
        raise FloatingPointError(f"NaN in the output of kernel {name}")


@contextlib.contextmanager
def nan_guard(enabled: bool = True):
    """The NaN guard over the block (forward ops, kernel outputs and the
    backward pass); a no-op when not ``enabled``."""
    if not enabled:
        yield
        return
    _ACTIVE[0] += 1
    try:
        with NaNGuard(), torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        _ACTIVE[0] -= 1
