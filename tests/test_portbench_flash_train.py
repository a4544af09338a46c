"""The benchmark's flash training cell (``portbench/kinds/train_flash.py``)
and the flash launch counters (``aline_tpu_torch/ops/flash_attention.py``)
on the CPU, at the kind's tiny sizes and the published widths.

* The tiny cell is correct against the plain reference
  (``reference/train.py``) in float32 and in bfloat16 under the committed
  limits, and its program ran the flash path (``flash.fwd`` counted);
  the compact cell's tiny run counts no flash launch.
* The kind's control (the reference one precision lower) and each of its
  three planted faults make the tiny cell not correct.
* Every plan the cell's rollouts build has every row seeing at least one
  key: the flash kernels depart from a dense softmax only for a row that
  sees none (it averages v over the padded columns), so the reference's
  dense masked softmax stands for them on this traffic.
* The reference's flash attention (``reference/flash.py``): in float32
  its encoder is ``model.encoder`` bit for bit (they differ only in
  where they round); in bfloat16 a layer's attention output is the
  program's plain flash forward's within one bf16 rounding; the
  configuration's ``precision.attention`` swaps it in for the block and
  back, and a configuration without it keeps the dense path.
* ``counts/flash_attn.py``: its pairs are the allowed pairs of
  ``flash_plan_plain`` on random roles; its least times are the kernel
  table's (PERF.md) 0.0051 ms forward and 0.0100 ms backward at B=200,
  H=4, N=303, dh=8, bound by bytes; a T=30 rollout under remat launches
  180 forwards and 90 backwards.
* A traced run reads the cell's six per-layer metrics (the profiled
  slice's summary given, as the card's trace would give it); on a
  program without the flash counters the two rooflines are left out.
* The counters: one forward and backward of a 3-layer flash encoder
  counts 1 plan, 3 forwards and 3 backwards, the backward's in the span
  open where ``backward`` was called, also when autograd runs it on
  another thread (as it does on the card); with tracing off nothing is
  made or recorded.
"""
import copy
import os
import sys
import threading

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from aline_tpu_torch.config import EncoderConfig  # noqa: E402
from aline_tpu_torch.models import encoder as enc  # noqa: E402
from aline_tpu_torch.ops import flash_attention as fa  # noqa: E402
from aline_tpu_torch.ops.roles import build_roles, roles_to_codes  # noqa: E402
from aline_tpu_torch.utils import metrics  # noqa: E402
from portbench import harness  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench.counts import flash_attn as counts  # noqa: E402
from portbench.reference import flash as ref_flash  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.harness import (  # noqa: E402
    checks_from, load_config, load_kind, load_limits, load_peaks,
    load_traffic)

torch.set_num_threads(1)
CELL = "al1d_200k_flash.train_b200"
COMPACT = "al1d_200k.train_b200"
KIND = load_kind("train_flash")
SEED = 2**31 + 977
METRICS = ("idle_share.train_flash", "kernels_per_epoch.train_flash",
           "mfu.train_flash", "flash_attn_fwd_roofline",
           "flash_attn_bwd_roofline", "flash_share.train_flash")
COUNTED = ("flash_attn_fwd_roofline", "flash_attn_bwd_roofline")


@pytest.fixture(autouse=True)
def tracing_reset():
    metrics.set_tracing(False)
    metrics.collect()
    yield
    metrics.set_tracing(False)
    metrics.collect()


def _parts(cell=CELL, f32=False):
    c = harness.find_cell(harness.load_benchmark(), cell)
    cf = copy.deepcopy(load_config(c["config"]))
    tr = dict(load_traffic(c["traffic"]), **KIND.TINY)
    if f32:
        cf["run"]["dtype"] = "float32"
        cf["precision"]["model"] = "float32"
    return cf, tr


def _run(cell=CELL, f32=False, trace=False):
    cf, tr = _parts(cell, f32)
    return R.execute(cell, SEED, 0.1, trace, "cpu", config=cf, traffic=tr)


def _counted(spans, name):
    return sum(s.counts.get(name, 0) for s in spans)


# -- the cell ---------------------------------------------------------------

@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_sound_runs_are_correct_through_flash(f32):
    metrics.set_tracing(True)
    res, _ = _run(f32=f32)
    spans = metrics.collect()
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"loss_gap", "first_predict_gap",
                                  "design_gap", "change_gap"}
    assert set(res["metrics"]) == {"train_rollouts_per_s", "setup_s"}
    assert _counted(spans, "flash.fwd") > 0
    assert _counted(spans, "flash.plan") > 0
    assert _counted(spans, "flash.bwd") > 0


def test_compact_cell_counts_no_flash_launch():
    metrics.set_tracing(True)
    res, _ = _run(COMPACT, f32=True)
    spans = metrics.collect()
    assert res["correct"], res["checks"]
    assert spans
    for name in ("flash.plan", "flash.fwd", "flash.bwd"):
        assert _counted(spans, name) == 0, name


def test_control_is_not_correct():
    cf, tr = _parts()
    readings = KIND.control(cf, tr, torch.device("cpu"), 2**31 + 3)
    assert not all(c.ok for c in checks_from(readings, load_limits(CELL)))


@pytest.mark.parametrize("fault", KIND.FAULTS)
def test_broken_path_is_not_correct(fault, monkeypatch):
    KIND.plant(fault, monkeypatch.setattr)
    res, _ = _run(f32=True)
    assert not res["correct"], res["checks"]


def test_every_row_sees_a_key(monkeypatch):
    plans = []

    def flash_plan(kcode, qrow):
        plan = fa.flash_plan(kcode, qrow)
        plans.append(plan)
        return plan

    monkeypatch.setattr(enc, "flash_plan", flash_plan)
    res, _ = _run(f32=True)
    assert res["correct"] and plans
    for plan in plans:
        assert int(plan.dense.sum()) == 0
        assert bool((plan.n_ctx >= 1).all())


# -- the reference's flash attention ----------------------------------------

def _ref_layer_inputs(seed=3):
    g = torch.Generator().manual_seed(seed)
    P = ref_model.load_params(
        os.path.join(ROOT, load_config("al1d_200k_flash")["weights"]), "cpu")
    B, n_points, n_target = 3, 12, 5
    ctx = torch.zeros(B, n_points, dtype=torch.bool)
    ctx[:, :3] = True
    sel = torch.tensor([True, True, False, False, True])
    h = torch.randn(B, n_points + n_target, 32, generator=g)
    return P, h, ctx, sel, ref_model.allowed_mask(ctx, n_target, sel)


def test_reference_flash_encoder_is_the_dense_one_in_float32():
    P, h, _, _, allowed = _ref_layer_inputs()
    r = ref_model.Rounder("float32")
    assert torch.equal(ref_flash.encoder(P, h, allowed, 3, 4, r),
                       ref_model.encoder(P, h, allowed, 3, 4, r))


def test_reference_flash_attention_is_the_programs_in_bfloat16():
    P, h, ctx, sel, allowed = _ref_layer_inputs()
    r = ref_model.Rounder("bfloat16")
    B, N, _ = h.shape
    qkv = ref_model.dense(P, "encoder/layer_0/self_attn/qkv_proj", h, r)
    q, k, v = (t.reshape(B, N, 4, 8).transpose(1, 2).contiguous()
               for t in qkv.chunk(3, dim=-1))
    bias = torch.where(allowed, 0.0, ref_model.NEG)[:, None]
    want = r(torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5 + bias, -1)
             @ v)
    kcode, qrow = roles_to_codes(build_roles(ctx, sel.shape[0], sel))
    got, _ = fa.flash_attn_fwd_plain(q.bfloat16(), k.bfloat16(),
                                     v.bfloat16(), kcode, qrow)
    ulp = want.abs().clamp(min=2.0 ** -126) * 2.0 ** -7
    assert ((got.float() - want).abs() <= ulp).all()


def test_reference_attention_follows_the_configuration():
    dense = ref_model.encoder
    with ref_flash.attention(load_config("al1d_200k_flash")["precision"]):
        assert ref_model.encoder is ref_flash.encoder
    assert ref_model.encoder is dense
    with ref_flash.attention(load_config("al1d_200k")["precision"]):
        assert ref_model.encoder is dense


# -- counts/flash_attn.py ---------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pairs_are_the_plans_allowed_pairs(seed):
    g = torch.Generator().manual_seed(seed)
    B, N = 5, 37
    kcode = torch.randint(0, 3, (B, N), generator=g, dtype=torch.int32)
    qrow = torch.randint(0, 2, (B, N), generator=g, dtype=torch.int32)
    plan = fa.flash_plan_plain(kcode, qrow)
    kc = kcode[:, None, :]
    allowed = (kc == 1) | ((qrow[:, :, None] == 1) & (kc == 2))
    got = sum(counts.pairs(N, int(plan.n_ctx[b]), int(plan.n_query[b]),
                           int(plan.n_vis[b] - plan.n_ctx[b]))
              for b in range(B))
    assert got == int(allowed.sum())


@pytest.mark.parametrize("n_ctx", [1, 30])
def test_least_times_are_the_kernel_tables(n_ctx):
    peaks = load_peaks()
    B, H, N, dh = 200, 4, 303, 8
    p = B * counts.pairs(N, n_ctx, 201 - n_ctx, 100)
    fwd = counts.fwd_least_s(B, H, N, dh, p, peaks)
    bwd = counts.bwd_least_s(B, H, N, dh, p, peaks)
    assert round(fwd * 1e3, 4) == 0.0051
    assert round(bwd * 1e3, 4) == 0.0100
    assert fwd == counts.fwd_bytes(B, H, N, dh) / peaks["hbm_bytes_per_s"]
    assert bwd == counts.bwd_bytes(B, H, N, dh) / peaks["hbm_bytes_per_s"]


def test_rollout_calls_are_six_and_three_t():
    cf = load_config("al1d_200k_flash")
    sizes = dict(D=32, F=128, C=10, dim_x=1, num_layers=3)
    n, s = counts.rollout_least_s(sizes, 4, 200, 201, 1, 102, 100, 30,
                                  cf["run"]["rollout_remat"], load_peaks())
    assert n == dict(fwd=180, bwd=90)
    assert s["fwd"] == pytest.approx(180 * 0.0051e-3, rel=0.01)
    assert s["bwd"] == pytest.approx(90 * 0.0100e-3, rel=0.01)


# -- the traced run ---------------------------------------------------------

def _summary(calls):
    """The profiled slice's summary, as the card's trace would give it
    with ``calls`` launches of each flash kernel."""
    def summarise(prof, window):
        assert not any(e.name.startswith("aline/") for e in prof.events())
        by_name = {"void flash_attn_fwd_bf16_kernel<8>(...)": (calls["fwd"],
                                                             2e-3),
                   "void flash_attn_bwd_dq_bf16_kernel<8>(...)": (
                       calls["bwd"], 2e-3),
                   "void flash_attn_bwd_dkdv_bf16_kernel<8>(...)": (
                       calls["bwd"], 2e-3),
                   "flash_plan_kernel(...)": (calls["plan"], 1e-4),
                   "ampere_bf16_gemm": (500, 0.05)}
        return dict(busy_s=0.1, window_s=1.0, n_device=2000,
                    by_name=by_name, breakdown={})
    return summarise


@pytest.mark.parametrize("program_counts", [True, False],
                         ids=["with_counters", "without_counters"])
def test_traced_run_reads_the_metrics(program_counts, monkeypatch):
    T, layers = KIND.TINY["T"], 3
    calls = dict(plan=2 * T, fwd=2 * layers * T, bwd=layers * T)
    load = harness.load_kind

    def load_kind_profiled(name, base=harness.HERE):
        mod = load(name, base)
        if name == "train_flash":
            mod.summarise = _summary(calls)
        return mod

    monkeypatch.setattr(R, "load_kind", load_kind_profiled)
    if not program_counts:
        monkeypatch.setattr(fa, "count", lambda name, n: None)
    res, _ = _run(f32=True, trace=True)
    want = set(METRICS) - (set() if program_counts else set(COUNTED))
    assert set(res["metrics"]) == want
    for name in want:
        m = res["metrics"][name]
        assert 0 < m["value"] and (m["unit"] != "%" or m["value"] <= 100), \
            name


# -- the counters -----------------------------------------------------------

def _encoder_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    B, n_points, n_target = 3, 9, 4
    ctx = torch.zeros(B, n_points, dtype=torch.bool)
    ctx[:, :2] = True
    roles = build_roles(ctx, n_target, torch.tensor([True, False, True,
                                                     False]))
    x = torch.randn(B, n_points + n_target, 32, generator=g)
    return x.requires_grad_(), roles


@pytest.mark.parametrize("thread", ["same", "other"])
def test_a_flash_step_counts_one_plan_and_each_layers_launches(thread):
    torch.manual_seed(0)
    model = enc.Encoder(EncoderConfig(num_layers=3, attention_impl="flash"))
    x, roles = _encoder_inputs()
    metrics.set_tracing(True)
    with metrics.span("forward") as fwd:
        out = model(x, roles)
    with metrics.span("backward") as bwd:
        if thread == "same":
            out.sum().backward()
        else:
            # as autograd's device thread runs a CUDA backward: no span
            # open on the thread that launches the backward kernels
            th = threading.Thread(target=lambda: out.sum().backward())
            th.start()
            th.join(timeout=60)
            assert not th.is_alive()
    metrics.collect()
    assert fwd.counts == {"flash.plan": 1, "flash.fwd": 3}
    assert bwd.counts == {"flash.bwd": 3}
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_flash_counters_off_record_nothing(monkeypatch):
    def made(*a, **kw):
        raise AssertionError("a span was made with tracing off")

    monkeypatch.setattr(metrics, "Span", made)
    model = enc.Encoder(EncoderConfig(num_layers=3, attention_impl="flash"))
    x, roles = _encoder_inputs(1)
    model(x, roles).sum().backward()
    assert metrics.collect() == []


def test_count_on_a_thread_without_a_span_adds_to_the_open_one():
    metrics.set_tracing(True)
    with metrics.span("outer") as outer:
        th = threading.Thread(target=lambda: metrics.count("n", 3))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    metrics.collect()
    assert outer.counts == {"n": 3}
    metrics.count("n", 1)                  # no span open anywhere: dropped
    assert metrics.collect() == []
