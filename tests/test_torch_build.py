"""The ctypes bindings of the port's CUDA libraries match their C entries.

ctypes passes whatever argtypes say, so a binding that drifts from the
``extern "C"`` prototype in ``aline_tpu_torch/csrc/<library>.cu`` would
hand the kernel wrong arguments without an error.  The prototypes are read
from the sources, so this runs without ``nvcc`` or a card.
"""
import ctypes
import re

import pytest

from aline_tpu_torch.ops import _build

ENTRIES = [(lib, lib, sig) for lib, sig in _build.SIGNATURES.items()] + [
    (lib, entry, sig) for lib, helpers in _build.HELPERS.items()
    for entry, sig in helpers.items()]


def _prototypes(lib):
    """{entry: (parameter C types, return C type)} of a library's source."""
    src = (_build.CSRC_DIR / f"{lib}.cu").read_text()
    found = {}
    for ret, name, params in re.findall(
            r'extern "C"\s+([\w ]+?)\s+(\w+)\s*\(([^)]*)\)', src):
        # drop each parameter's name, keep its type
        found[name] = ([re.sub(r"\s*\b\w+$", "", p.strip())
                        for p in params.split(",")], ret)
    return found


def _ctype(c_type):
    if "*" in c_type:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[c_type]


@pytest.mark.parametrize("lib,entry,sig", ENTRIES,
                         ids=[e for _, e, _ in ENTRIES])
def test_binding_matches_the_c_prototype(lib, entry, sig):
    argtypes, restype = sig
    params, ret = _prototypes(lib)[entry]
    assert [_ctype(p) for p in params] == argtypes
    assert _ctype(ret) == restype


def test_every_c_entry_is_bound():
    bound = {(lib, entry) for lib, entry, _ in ENTRIES}
    for lib in _build.SIGNATURES:
        for entry in _prototypes(lib):
            assert (lib, entry) in bound, f"{lib}.cu: {entry} has no binding"
