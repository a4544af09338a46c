"""What the port's CUDA graphs share (``eval/al_curves.py``'s rollout
graph, ``eval/live.py``'s trial graph, ``train/graph.py``'s training
graphs).

* ``GraphCache``: model → its ``Graphs`` (the graphs by key and the one
  memory pool they share), for one model at a time.  ``inference_graphs``
  is the cache of the rollouts and the live trials, which so share a
  model's pool; the trainer keeps its own.
* ``Static``: a graph's static copies of its tensor inputs, which a
  replay's new values are copied into; ``Captured``: one block captured
  as one graph from them, its static outputs and what it counted.
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
import weakref
from typing import Callable, Dict

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


class Graphs:
    """One model's graphs by key (``graphs``) and the memory pool they
    share (``handle``)."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, object] = {}


class GraphCache(weakref.WeakKeyDictionary):
    """model → its ``Graphs`` (made by ``make``), held weakly, for one
    model at a time: ``of`` a model whose graphs are not here drops the
    others', since their pool keeps the memory of their largest capture.
    A pool dies with its graphs, and its id is never used again."""

    def __init__(self, make: Callable[[], Graphs] = Graphs):
        super().__init__()
        self._make = make

    def of(self, model) -> Graphs:
        if model not in self:
            self.clear()
            self[model] = self._make()
        return self[model]


# the rollouts' (eval/al_curves.py) and the live trials' (eval/live.py)
inference_graphs = GraphCache()


class Static:
    """A graph's static copies of its tensor inputs by name (``inputs``),
    contiguous; ``load`` copies new values into them."""

    def __init__(self, inputs: Dict[str, torch.Tensor]):
        self.inputs = {n: t.clone(memory_format=torch.contiguous_format)
                       for n, t in inputs.items()}

    def load(self, inputs: Dict[str, torch.Tensor]) -> None:
        for n, t in inputs.items():
            self.inputs[n].copy_(t)


class Captured(Static):
    """One block captured as one CUDA graph from its static inputs: the
    graph, its static outputs, and the kernel launches and counts
    (``Counted``) that a replay runs."""

    def __init__(self, inputs: Dict[str, torch.Tensor]):
        super().__init__(inputs)
        self.graph = torch.cuda.CUDAGraph()
        self.outputs: Dict[str, torch.Tensor] = {}
        self.counted = Counted()

    def capture(self, run, stream, pool) -> Dict[str, torch.Tensor]:
        """Run ``run(static inputs)`` eagerly on ``stream``, then capture
        it there into ``pool``; return the eager pass's outputs."""
        here = torch.cuda.current_stream()
        stream.wait_stream(here)
        with torch.cuda.stream(stream):
            first = run(self.inputs)
        here.wait_stream(stream)
        for t in first.values():          # used on this stream from here on
            t.record_stream(here)
        # ``torch.cuda.graph`` empties the allocator's cache first: no block
        # the eager pass left cached can be freed while the capture runs
        with counted_apart() as self.counted, \
                torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.outputs = run(self.inputs)
        return first

    def replay(self) -> None:
        """Replay the graph and count what its capture counted."""
        self.graph.replay()
        self.counted.add()
