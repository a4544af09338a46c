"""What every cell shares: finding a cell's files by name, the record of
a run (spans, counts, the trace), the checks against their limits, and
the result line.

A cell is ``<config>.<traffic>`` in ``BENCHMARK.json``.  Its parts are
files found by name, so that a new one is added without editing any file
that is here:

* ``configs/<config>.json``  the configuration (sizes, precision,
  weights, source, ``assumed`` and ``reduced``);
* ``traffic/<traffic>.json`` the traffic mix's parameters, whose
  ``kind`` names the runner ``kinds/<kind>.py`` that runs it;
* ``limits/<cell>.json``     the limit of each number compared;
* ``metrics/<metric>.py``    the reader of a per-layer metric
  (``metrics/<name before the first dot>.py`` where no file has the
  whole name), whose ``read(run)`` returns a number or None.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class UnknownName(KeyError):
    pass


def _json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise UnknownName(f"no {kind[:-1] if kind.endswith('s') else kind} "
                          f"named {name!r} ({path.relative_to(base.parent)} "
                          f"does not exist)")
    return json.loads(path.read_text())


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise UnknownName(f"no workload named {name!r} in BENCHMARK.json")


def load_config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def load_traffic(name: str, base: Path = HERE) -> dict:
    return _json("traffic", name, base)


def load_limits(cell: str, base: Path = HERE) -> dict:
    return _json("limits", cell, base)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str, base: Path = HERE):
    path = base / "kinds" / f"{kind}.py"
    if not path.is_file():
        raise UnknownName(f"no traffic kind named {kind!r}")
    return _module(path, f"portbench_kind_{kind}")


def load_reader(metric: str, base: Path = HERE):
    """The reader of ``metric``: ``metrics/<metric>.py``, else
    ``metrics/<metric up to its first dot>.py``."""
    for stem in (metric, metric.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.is_file():
            return _module(path, "portbench_metric_"
                           + stem.replace(".", "_"))
    raise UnknownName(f"no reader for the metric {metric!r}")


def load_peaks(base: Path = HERE) -> dict:
    return json.loads((base / "peaks.json").read_text())


@dataclass
class Run:
    """What a run recorded, for the metric readers.

    ``units``: units of work completed in the measured window (epochs,
    batches, experiments); ``window_s`` its length; ``spans``: seconds of
    each named span of the benchmark's own calls, synchronised;
    ``counts``: numbers the runner computed from shapes (FLOPs, the
    kernels' least times); ``trace``: ``trace.summarise`` of the traced
    units, and ``trace_units`` their number."""
    config: dict
    traffic: dict
    units: int = 0
    window_s: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    trace: Optional[dict] = None
    trace_units: int = 0

    @contextlib.contextmanager
    def span(self, name: str, sync):
        """Time the block between two calls of ``sync``."""
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_from(readings: Dict[str, float], limits: dict) -> List[Check]:
    """One check per reading, against the limit of the same name; a
    reading without a limit is an error."""
    missing = sorted(set(readings) - set(limits))
    if missing:
        raise UnknownName(f"no limit for {missing}")
    return [Check(k, float(v), float(limits[k])) for k, v in readings.items()]


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by linear interpolation."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
