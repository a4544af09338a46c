"""The AL rollout's CUDA-graph path (``aline_tpu_torch/eval/al_curves.py``)
on the CPU, at a tiny configuration.

* On CPU tensors no strategy captures or replays a graph (the counters
  ``al.graph_captures`` and ``al.graph_replays`` stay 0 with tracing on),
  and the curves are bit for bit those of the plain step loop.
* ``graph_key`` tells apart what a captured rollout depends on besides
  its inputs' values, and is the same for new values of the same form.
* ``take_static``, the compact attention's capture-safe selection of the
  mask's targets, equals indexing with the list.

The graph itself runs on the card: tests/test_torch_cuda.py.
"""
import pytest
import torch

from aline_tpu_torch import config as tcfg
from aline_tpu_torch.distributions.gmm import gmm_log_prob, gmm_variance
from aline_tpu_torch.eval import al_curves
from aline_tpu_torch.eval.al_curves import al_rollout_curves, graph_key
from aline_tpu_torch.eval.metrics import compute_rmse
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.ops.attention import take_static
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import init_ctx_idx, select_design
from aline_tpu_torch.utils import metrics

torch.set_num_threads(1)
SMALL = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
         "task.n_context_init=1", "task.n_query_init=8",
         "task.n_target_data=4", "encoder.dim_embedding=16",
         "encoder.dim_feedforward=32", "encoder.n_head=2",
         "encoder.num_layers=2", "head.num_components=4"]
T = 4


@pytest.fixture(autouse=True)
def tracing_reset():
    metrics.set_tracing(False)
    metrics.collect()
    yield
    metrics.set_tracing(False)
    metrics.collect()


def _setup(*extra, seed=1, B=3, n_query=8):
    cfg = tcfg.parse_overrides(SMALL + list(extra))
    torch.manual_seed(0)
    model = build_model(cfg, "cpu").eval()
    batch = build_task(cfg.task).sample_batch(
        torch.Generator().manual_seed(seed), B, n_query)
    return cfg, model, batch


def _masked(batch, mask):
    if mask == "default":
        return batch
    sel = torch.arange(batch.n_target) < batch.n_target_data
    return batch.replace(target_mask=sel if mask == "data" else ~sel)


@torch.no_grad()
def _step_loop(model, batch, T, generator, strategy, time_token):
    """The rollout's steps written out as one plain loop."""
    sel = tuple(torch.nonzero(batch.target_mask)[:, 0].tolist())
    sel = None if len(sel) == batch.n_target else sel
    n_ctx0 = int(batch.ctx_mask[0].sum())
    b = init_ctx_idx(batch, min(n_ctx0 + T, batch.n_points))
    vals = b.target_all[..., 0]
    m = b.target_mask.float()
    w = m / torch.clamp(m.sum(), min=1.0)
    lps, rmses, idxs = [], [], []
    for t in range(T + 1):
        if time_token and t < T:
            b = b.replace(t=(T - torch.full((), t, dtype=torch.float32)) / T)
        out = model(b, training=False, sel_targets=sel)
        po = out.posterior_out
        ll = gmm_log_prob(vals, po.mixture_means, po.mixture_stds,
                          po.mixture_weights)
        lps.append(torch.sum(ll * w[None], dim=-1))
        rmses.append(compute_rmse(vals, po.mixture_means, po.mixture_stds,
                                  po.mixture_weights, target_weights=w))
        if t == T:
            break
        pool = b.query_mask
        if strategy == "aline":
            idx = out.design_out.idx
        elif strategy == "random":
            idx = torch.multinomial(pool.float(), 1, generator=generator)[:, 0]
        else:
            pq = out.posterior_out_query
            var = gmm_variance(pq.mixture_means, pq.mixture_stds,
                               pq.mixture_weights)
            idx = torch.argmax(torch.where(pool, var, -torch.inf), dim=-1)
        b, _, _ = select_design(b, idx)
        idxs.append(idx)
    return {"log_prob": torch.stack(lps, dim=1),
            "rmse": torch.stack(rmses, dim=1),
            "idx": torch.stack(idxs, dim=1)}


@pytest.mark.parametrize("strategy", al_curves.STRATEGIES)
def test_cpu_rollout_never_captures(strategy):
    _, model, batch = _setup()
    metrics.set_tracing(True)
    al_rollout_curves(model, batch, T, torch.Generator().manual_seed(3),
                      strategy=strategy)
    al_rollout_curves(model, batch, T, torch.Generator().manual_seed(3),
                      strategy=strategy)
    rollouts = [s for s in metrics.collect() if s.name == "al.rollout"]
    assert len(rollouts) == 2
    for s in rollouts:
        assert s.counts.get("al.graph_captures", 0) == 0
        assert s.counts.get("al.graph_replays", 0) == 0
    assert model not in al_curves._graphs


@pytest.mark.parametrize("strategy", al_curves.STRATEGIES)
@pytest.mark.parametrize("extra,mask", [
    ((), "default"), ((), "data"), ((), "theta"),
    (("time_token=true", "encoder.with_time_token=true"), "default"),
    (("encoder.attention_impl=naive",), "data"),
])
def test_cpu_rollout_equals_the_step_loop_bitwise(strategy, extra, mask):
    cfg, model, batch = _setup(*extra)
    batch = _masked(batch, mask)
    got = al_rollout_curves(model, batch, T,
                            torch.Generator().manual_seed(3),
                            strategy=strategy, time_token=cfg.time_token)
    want = _step_loop(model, batch, T, torch.Generator().manual_seed(3),
                      strategy, cfg.time_token)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _key(model, batch, target_weights=None, T=T, strategy="aline",
         time_token=False, sel_targets=None, n_ctx0=1):
    return graph_key(model, batch, target_weights, T, strategy, time_token,
                     sel_targets, n_ctx0)


def _changed(what, model, batch):
    """The key of the base call with ``what`` changed."""
    if what == "batch_size":
        return _key(model, _setup(B=4)[2])
    if what == "pool_size":
        return _key(model, _setup(n_query=9)[2])
    if what == "dtype":
        return _key(model, batch.replace(x=batch.x.double()))
    if what == "device":
        return _key(model, batch.replace(t=batch.t.to("meta")))
    if what == "ctx_idx":
        return _key(model, init_ctx_idx(batch, 5))
    if what == "ctx_capacity":
        return _key(model, batch.replace(ctx_capacity=7))
    if what == "target_weights":
        return _key(model, batch, target_weights=torch.ones(6))
    if what == "strategy":
        return _key(model, batch, strategy="uncertainty")
    if what == "T":
        return _key(model, batch, T=T + 1)
    if what == "time_token":
        return _key(model, batch, time_token=True)
    if what == "sel_targets":
        return _key(model, batch, sel_targets=(0, 1, 2, 3))
    if what == "n_ctx0":
        return _key(model, batch, n_ctx0=2)
    if what == "parameter":
        p = model.encoder.layer_0.linear1.weight
        p.data = p.data.clone()
        return _key(model, batch)
    raise AssertionError(what)


@pytest.mark.parametrize("what", [
    "batch_size", "pool_size", "dtype", "device", "ctx_idx", "ctx_capacity",
    "target_weights", "strategy", "T", "time_token", "sel_targets", "n_ctx0",
    "parameter"])
def test_graph_key_separates(what):
    _, model, batch = _setup()
    base = _key(model, batch)
    assert _changed(what, model, batch) != base


def test_graph_key_same_for_new_values_of_the_same_form():
    _, model, batch = _setup()
    base = _key(model, batch)
    other = _setup(seed=7)[2]
    assert not torch.equal(other.x, batch.x)
    assert _key(model, other) == base
    # weights loaded in place keep the addresses the graph reads
    model.load_state_dict({k: v + 1 for k, v in model.state_dict().items()})
    assert _key(model, other) == base


@pytest.mark.parametrize("idx", [(0, 1, 2), (1, 3), (0, 2, 3, 5), (4,), (),
                                 (0, 1, 2, 3, 4, 5)])
def test_take_static_equals_list_indexing(idx):
    a = torch.randn(2, 3, 6, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(take_static(a, idx, 2), a[:, :, list(idx)])
    cols = torch.rand(2, 6) < 0.5
    assert torch.equal(take_static(cols, idx, 1), cols[:, list(idx)])
