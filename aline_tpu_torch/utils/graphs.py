"""What the port's CUDA graphs share (``eval/al_curves.py``'s rollout
graph, ``train/graph.py``'s training graphs).

* ``side_stream(device)``: the one stream that captures run on, so that
  the graphs of a cache can share its memory pool.
* ``counted_apart()``: a capture launches nothing, but its Python runs
  the kernels' wrappers, which count their launches
  (``ops/_build.py`` ``LAUNCHES``) and the program's counters
  (``utils/metrics.py`` ``count``).  The block's counts are kept apart
  in a ``Counted``, ``LAUNCHES`` is left as it was, and each replay adds
  them (``Counted.add``) where the eager call would have counted them.
* ``form``, ``batch_form`` and ``addresses``: the parts of a graph's key
  that describe tensors without their values, and the parameters and
  buffers a graph reads by address; ``tensor_inputs``: the tensors a
  graph copies into its static inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
from typing import Dict

import torch

from aline_tpu_torch.ops import _build
from aline_tpu_torch.utils.metrics import count, recorded_counts


@functools.cache
def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that runs the captures on ``device``."""
    return torch.cuda.Stream(device)


class Counted:
    """The kernel launches (by ``LAUNCHES`` entry) and the ``count``
    calls (by name) of a captured block."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}

    def add(self) -> None:
        """Count them once more, as a replay of the block runs them:
        the launches in ``LAUNCHES``, the counts in the span open here."""
        for k, n in self.launches.items():
            _build.LAUNCHES[k] += n
        for k, n in self.counts.items():
            count(k, n)


@contextlib.contextmanager
def counted_apart():
    """Yield a ``Counted`` that holds, once the block ends, its launches
    and ``count`` calls, which neither ``LAUNCHES`` nor any span keeps."""
    rec = Counted()
    before = dict(_build.LAUNCHES)
    try:
        with recorded_counts() as counts:
            yield rec
    finally:
        rec.launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                        if n != before[k]}
        rec.counts = dict(counts)
        _build.LAUNCHES.update(before)


def form(v):
    """A tensor's shape, dtype and device; any other value as it is."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype, v.device
    return v


def batch_form(batch) -> tuple:
    """(name, ``form``) of every field of the dataclass ``batch``."""
    return tuple((f.name, form(getattr(batch, f.name)))
                 for f in dataclasses.fields(batch))


def tensor_inputs(batch, **extra) -> Dict[str, torch.Tensor]:
    """A graph's tensor inputs by name: the tensor fields of the dataclass
    ``batch`` and the tensors among ``extra``."""
    named = {f.name: getattr(batch, f.name)
             for f in dataclasses.fields(batch)}
    named.update(extra)
    return {n: t for n, t in named.items() if isinstance(t, torch.Tensor)}


def addresses(model) -> tuple:
    """The addresses of ``model``'s parameters and buffers, which a graph
    reads: a model whose tensors were replaced is captured anew, one
    loaded in place is not."""
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers()))
