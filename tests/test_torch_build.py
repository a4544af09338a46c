"""The ctypes bindings of the port's CUDA libraries match their C entries,
and the one launcher (``_build.launch``) calls them as they are bound.

ctypes passes whatever argtypes say, so a binding that drifts from the
``extern "C"`` prototype in ``aline_tpu_torch/csrc/<library>.cu`` would
hand the kernel wrong arguments without an error.  The prototypes are read
from the sources, and a fake library stands in for a built one (each entry
records what it is called with), so this runs without ``nvcc`` or a card.
"""
import ctypes
import re
import types

import pytest
import torch

from aline_tpu_torch import config as tcfg
from aline_tpu_torch.ops import _build
from aline_tpu_torch.ops import eig_fold_kernel as efk
from aline_tpu_torch.ops import gmm_head_kernel as ghk
from aline_tpu_torch.parallel.collectives import lse_init
from aline_tpu_torch.tasks import build_task

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


# -- the launcher, against a fake library ------------------------------------

STREAM = 77
SCRATCH = 8


class FakeLibrary:
    """A built library's stand-in: every entry records its arguments and
    returns ``err`` (a ``*_scratch`` entry: ``SCRATCH`` floats)."""

    def __init__(self):
        self.calls, self.err = [], 0

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return SCRATCH if entry.endswith("_scratch") else self.err
        return call


@pytest.fixture
def fake(monkeypatch):
    """The fake library behind every ``_build.load``, a fixed stream, and
    CPU tensors taken as on the current device."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=STREAM))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    return lib


def test_launch_passes_pointers_numbers_and_the_stream(fake):
    a, b = torch.zeros(4), torch.zeros(8)
    _build.launch("flash_plan", (a, b), 3, 5)
    assert fake.calls == [("flash_plan", (a.data_ptr(), b.data_ptr(), 3, 5,
                                          STREAM))]


def test_a_launch_counts_once_under_its_entry(fake):
    before = dict(_build.LAUNCHES)
    _build.launch("flash_attn_fwd", (torch.zeros(4),), 1,
                  entry="flash_attn_fwd_bf16")
    assert [e for e, _ in fake.calls] == ["flash_attn_fwd_bf16"]
    assert _build.LAUNCHES == dict(
        before, flash_attn_fwd_bf16=before["flash_attn_fwd_bf16"] + 1)


def test_a_failed_launch_raises_naming_its_entry(fake):
    fake.err = 700
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_attn_bwd_bf16.*700"):
        _build.launch("flash_attn_bwd", (torch.zeros(4),),
                      entry="flash_attn_bwd_bf16")
    assert _build.LAUNCHES == before        # a failed launch is not counted


@pytest.mark.parametrize("aligned", [True, False])
def test_alignment_is_refused_only_where_asked(fake, aligned):
    """A view one float in (a fold's slice of given thetas can be one)
    launches unless the caller asks for 16-byte alignment."""
    shifted = torch.zeros(9)[1:]
    if aligned:
        with pytest.raises(ValueError, match="aligned"):
            _build.launch("loc_eig_fold", (shifted,), aligned=True)
        assert fake.calls == []
    else:
        _build.launch("loc_eig_fold", (shifted,))
        assert fake.calls == [("loc_eig_fold", (shifted.data_ptr(), STREAM))]


def test_every_entry_has_a_counter():
    kernels = {e for _, e, (_, restype) in ENTRIES if restype is ctypes.c_int}
    assert set(_build.LAUNCHES) == kernels


def _fold_task(name):
    return build_task(tcfg.parse_overrides([f"task={name}"]).task)


def _fold_call(name, B):
    """A kernel task's fold of a chunk of 10 draws (5 valid) at batch B
    with rows of 3 steps, on the launch path."""
    task = _fold_task(name)
    g = torch.Generator().manual_seed(0)
    x = task.sample_data(g, B, 3)
    y = torch.rand(B, 3, generator=g)
    thetas = task.sample_theta(g, (10, B))
    state = lse_init((B, 3))
    return task, (state, x, y, thetas, 5)


@pytest.mark.parametrize("name", ["location_finding", "ces"])
def test_a_fold_launches_as_its_kernel_is_bound(fake, monkeypatch, name):
    """The fold launcher passes a kernel task's chunk as the C entry
    takes it: the eight arrays, the valid draws, B, Th and the task's
    numbers, then the stream; one launch, counted."""
    monkeypatch.setattr(efk, "_check", lambda *a: True)   # the card's path
    task, (state, x, y, thetas, n) = _fold_call(name, 2)
    kernel = f"{'loc' if name == 'location_finding' else 'ces'}_eig_fold"
    before = _build.LAUNCHES[kernel]
    new = task.fold_eig_chunk(state, x, y, thetas, n)
    (scratch, sizes), (entry, args) = fake.calls
    assert (scratch, sizes) == (f"{kernel}_scratch", (n, 2, 3))
    assert entry == kernel and _build.LAUNCHES[kernel] == before + 1
    ptrs = [t.data_ptr() for t in (x, y, thetas, state.max, state.sumexp,
                                   new.max, new.sumexp)]
    assert list(args[:7]) == ptrs
    numbers = ((1, 2, task.base_signal, task.max_signal, task.noise_scale)
               if name == "location_finding" else
               (task.noise_scale, task.epsilon, 1.0 - task.epsilon))
    assert args[8:] == (n, 2, 3, *numbers, STREAM)
    assert len(args) == len(_build.SIGNATURES[kernel][0])


@pytest.mark.parametrize("name", ["location_finding", "ces"])
def test_an_empty_fold_launches_nothing(fake, monkeypatch, name):
    monkeypatch.setattr(efk, "_check", lambda *a: True)   # the card's path
    task, args = _fold_call(name, 0)
    before = dict(_build.LAUNCHES)
    new = task.fold_eig_chunk(*args)
    assert new.max.shape == (0, 3)
    assert fake.calls == [] and _build.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["gmm_head_fwd", "gmm_head_bwd"])
def test_the_gmm_head_launches_as_it_is_bound(fake, monkeypatch, kernel):
    monkeypatch.setattr(ghk, "_kernel_device", lambda z: True)
    g = torch.Generator().manual_seed(1)
    z, w1, b1, w2, b2 = (torch.randn(*s, generator=g) for s in
                         ((2, 5, 32), (4, 32, 128), (4, 128), (4, 128, 3),
                          (4, 3)))
    if kernel == "gmm_head_fwd":
        ghk.gmm_head_fwd(z, w1, b1, w2, b2)
        want = [kernel]
    else:
        ghk.gmm_head_bwd(z, w1, b1, w2, torch.randn(2, 5, 4, 3, generator=g))
        want = ["gmm_head_bwd_scratch", kernel]
    assert [e for e, _ in fake.calls] == want
    args = fake.calls[-1][1]
    assert args[-5:] == (10, 32, 4, 128, STREAM)      # rows, D, C, F
    assert len(args) == len(_build.SIGNATURES[kernel][0])
