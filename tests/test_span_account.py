"""``scripts/span_account.py`` on synthetic profiles: the program's
annotations (``aline/<span>`` ranges on the host, their user annotations
on the device) leave ``portbench/trace.py`` ``summarise``'s numbers as they
are without them, and the idle time and device operations are put down to
the right spans."""
import importlib.util
import os
import sys

import pytest
import torch
from torch.autograd.profiler_util import FunctionEvent

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench.trace import summarise  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "span_account", os.path.join(ROOT, "scripts", "span_account.py"))
span_account = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(span_account)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, device=CPU, corr=0, annotation=False, thread=1):
    return FunctionEvent(id=corr, name=name, thread=thread, start_us=start,
                         end_us=end, device_type=device,
                         is_user_annotation=annotation)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _profile():
    """Two kernels launched inside ``model.forward`` (itself inside
    ``al.rollout``), one inside ``al.choose``, one outside any span; the
    program's ranges on the host and their annotations on the device."""
    plain = [
        _ev("aten::mm", 0, 12), _ev("cudaLaunchKernel", 1, 2, corr=11),
        _ev("cudaLaunchKernel", 5, 6, corr=12),
        _ev("aten::add", 40, 52), _ev("cudaLaunchKernel", 41, 42, corr=13),
        _ev("cudaMemcpyAsync", 70, 71, corr=14),
        _ev("gemm", 10, 20, CUDA, corr=11), _ev("gemm", 22, 30, CUDA, 12),
        _ev("add", 45, 50, CUDA, corr=13), _ev("Memcpy", 80, 90, CUDA, 14),
    ]
    ours = [
        _ev("aline/al.rollout", 0, 60), _ev("aline/model.forward", 0, 35),
        _ev("aline/al.choose", 38, 60),
        _ev("aline/al.rollout", 0, 60, CUDA, annotation=True),
        _ev("aline/model.forward", 3, 35, CUDA, annotation=True),
    ]
    return plain, ours


def test_annotations_leave_the_summary_as_without_them():
    plain, ours = _profile()
    got = span_account.slice_account(plain + ours, 100.0)
    want = summarise(_Prof(plain), 100.0)
    for k in ("busy_s", "window_s", "n_device", "by_name"):
        assert got[k] == want[k], k
    assert got["breakdown"]["device_ops"] == want["breakdown"]["device_ops"]
    assert got["breakdown"]["idle_gaps"] == want["breakdown"]["idle_gaps"]
    # with the annotations counted, the parent's reading would move
    assert summarise(_Prof(plain + ours), 100.0)["n_device"] != \
        want["n_device"]


def test_idle_time_and_launches_by_span():
    plain, ours = _profile()
    got = span_account.slice_account(plain + ours, 100.0)
    # gaps 20-22 (mid 21: model.forward), 30-45 (mid 37.5: al.rollout),
    # 50-80 (mid 65: outside any span)
    assert dict(got["breakdown"]["idle_spans"]) == pytest.approx(
        {"model.forward": 2e-6, "al.rollout": 15e-6,
         span_account.OUTSIDE: 30e-6})
    assert got["idle_in"] == pytest.approx(
        {"al.rollout": 100 * 17 / 47, "model.forward": 100 * 2 / 47,
         "al.choose": 0.0})
    assert got["ops_per_span"] == {"al.rollout": 3.0, "model.forward": 2.0,
                                   "al.choose": 1.0}
    assert got["ops_unmatched"] == 0
    assert got["span_counts"] == {"al.rollout": 1, "model.forward": 1,
                                  "al.choose": 1}


def test_window_shares_and_chunk_median():
    class S:
        def __init__(self, name, ms):
            self.name, self.start_ns, self.end_ns = name, 0, int(ms * 2e6)
            self._ms = ms

        def stream_s(self):
            return self._ms / 1e3

    spans = ([S("train.epoch", 100)] + [S("train.rollout", 30),
             S("train.backward", 50), S("train.optimizer", 10)]
             + [S("eig.chunk", ms) for ms in (3, 1, 2)])
    acc = span_account.window_account(spans)
    assert acc["rollout.share.train"] == pytest.approx(30)
    assert acc["backward.share.train"] == pytest.approx(50)
    assert acc["optimizer.share.train"] == pytest.approx(10)
    assert "forward.share.al" not in acc
    assert acc["eig_chunk_ms"] == pytest.approx(2)
    assert acc["spans"]["train.epoch"] == {"n": 1, "host_s": 0.2,
                                           "stream_s": 0.1}
