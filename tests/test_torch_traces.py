"""The port's BED traces (``aline_tpu_torch.eval.traces.get_traces``) and
baseline designs (``models/baselines.py``) against the JAX package's, on
the committed location-finding weights (checkpoints/loc_100k, through
``aline_tpu_torch/assets/loc_100k_params.npz``) and JAX-drawn batches
(B=4, n_query=40, T=6).

* float32 (a copy of the run's config.json set to float32): the same
  designs are chosen at every step, and x (unnormalised) and y agree to
  1e-6.
* bfloat16, the run's own dtype, against JAX run without jit (every
  declared bfloat16 rounding, as ``tests/test_torch_bf16_slice.py``
  explains): chosen designs are equal, or a row leaves JAX's trajectory
  at an exact tie of JAX's own bfloat16 design scores.
* The time token runs backwards in the traces, (T - t)/T.
* The grid designs are bitwise JAX's; the random designs' log-probs are
  JAX's formula on the port's draws, exactly.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.distributions.gmm import normal_log_prob as jax_normal_lp
from aline_tpu.eval.traces import get_traces as jax_get_traces
from aline_tpu.models import baselines as jbase
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.base import select_design as jax_select_design
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu.utils.serialization import load_config_and_model
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval.traces import get_traces
from aline_tpu_torch.models import baselines as tbase
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.utils.serialization import (
    LOC_100K_PARAMS, convert_flax_params, load_model)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOC_RUN = os.path.join(ROOT, "checkpoints", "loc_100k")
T = 6


def _flat(params):
    return {k: np.asarray(v)
            for k, v in flatten_dict(params, sep="/").items()}


def _f32_copy(run_dir):
    with open(os.path.join(LOC_RUN, "config.json")) as f:
        run_cfg = json.load(f)
    run_cfg["dtype"] = "float32"
    (run_dir / "config.json").write_text(json.dumps(run_cfg))
    return str(run_dir)


@pytest.fixture(scope="module")
def loc(tmp_path_factory):
    cfg = jax_load_config(LOC_RUN)
    assert cfg.dtype == "bfloat16"
    cfg32 = copy.deepcopy(cfg)          # build_model sets cfg.encoder.dtype
    cfg32.dtype = "float32"
    with np.load(LOC_100K_PARAMS) as f:
        params = unflatten_dict({k: jnp.asarray(f[k]) for k in f.files},
                                sep="/")
    jtask = JaxLocation(cfg.task)
    jbatch = jtask.sample_batch(jax.random.key(3), 4, n_query=40)
    _, model = load_model(LOC_RUN, LOC_100K_PARAMS, "cpu")
    _, model32 = load_model(_f32_copy(tmp_path_factory.mktemp("loc_f32")),
                            LOC_100K_PARAMS, "cpu")
    return dict(jmodel=jax_build_model(cfg), jmodel32=jax_build_model(cfg32),
                params=params, jtask=jtask, jbatch=jbatch, model=model,
                model32=model32, task=build_task(tcfg.load_config(
                    LOC_RUN).task))


def _indices(x_trace, batch_x):
    """[B, T] pool indices of the chosen designs (x_trace [B, n_ctx + T,
    D], unnormalised at design_scale 1) among the batch's points."""
    hits = (x_trace[:, 1:, None, :] == batch_x[:, None]).all(-1)
    assert (hits.sum(-1) == 1).all()
    return hits.float().argmax(-1)


def test_committed_npz_equals_orbax_checkpoint():
    _, _, params = load_config_and_model(LOC_RUN, "aline_loc")
    want = _flat(params)
    with np.load(LOC_100K_PARAMS) as f:
        assert sorted(f.files) == sorted(want)
        for k in f.files:
            assert f[k].dtype == np.float32
            np.testing.assert_array_equal(f[k], want[k], err_msg=k)


def test_npz_fits_the_theta_embedder(loc):
    model = loc["model"]
    assert model.embedder.theta_tokens.shape == (2, 32)
    assert model.embedder.x_embedder.fc1.weight.shape == (128, 2)
    assert model.embedder.embedding_type == "theta"
    with np.load(LOC_100K_PARAMS) as f:
        np.testing.assert_array_equal(
            model.embedder.theta_tokens.detach().numpy(),
            f["params/embedder/theta_tokens"])


def test_f32_traces_match_jax(loc):
    jbatch = loc["jbatch"]
    w0, wx, wy = jax_get_traces(loc["jmodel32"], loc["params"],
                                loc["jtask"], jbatch, T, jax.random.key(0))
    batch = batch_from_numpy(jbatch)
    g0, gx, gy = get_traces(loc["model32"], loc["task"], batch, T)
    assert gx.shape == (4, 1 + T, 2) and gy.shape == (4, 1 + T, 1)
    assert gx.dtype == gy.dtype == torch.float32
    np.testing.assert_array_equal(_indices(gx, batch.x).numpy(),
                                  _indices(torch.from_numpy(np.array(wx)),
                                           batch.x).numpy())
    np.testing.assert_array_equal(g0.numpy(), np.asarray(w0))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=0, atol=1e-6)
    # the initial context comes first
    assert torch.equal(gx[:, 0], batch.x[:, 0])
    assert torch.equal(gy[:, 0], batch.y[:, 0])


def _jax_scores(jmodel, params, jbatch, idx, t):
    """JAX's own bf16 design scores at step t of the trajectory idx."""
    b = jax_init_ctx_idx(jbatch, 1 + T)
    for s in range(t):
        b = jax_select_design(b, jnp.asarray(idx[:, s]))[0]
    with jax.disable_jit():
        out = jmodel.apply(params, b, training=False)
    return np.asarray(out.design_out.zt)


def test_bf16_traces_match_jax_bf16_except_at_ties(loc):
    jbatch = loc["jbatch"]
    with jax.disable_jit():
        _, wx, wy = jax_get_traces(loc["jmodel"], loc["params"],
                                   loc["jtask"], jbatch, T,
                                   jax.random.key(0))
    batch = batch_from_numpy(jbatch)
    _, gx, gy = get_traces(loc["model"], loc["task"], batch, T)
    assert gx.dtype == gy.dtype == torch.float32
    gidx = _indices(gx, batch.x).numpy()
    widx = _indices(torch.from_numpy(np.array(wx)), batch.x).numpy()
    differs = (gidx != widx).any(axis=1)
    for r in np.flatnonzero(differs):
        t = int(np.argmax(gidx[r] != widx[r]))
        scores = _jax_scores(loc["jmodel"], loc["params"], jbatch, widx, t)
        assert scores[r, gidx[r, t]] == scores[r, widx[r, t]], (
            f"row {r} leaves JAX's trajectory at step {t} off a tie")
    same = ~differs
    assert same.sum() >= 3, f"{differs.sum()} of 4 rows left at ties"
    np.testing.assert_array_equal(gx.numpy()[same], np.asarray(wx)[same])
    np.testing.assert_array_equal(gy.numpy()[same], np.asarray(wy)[same])


def test_time_token_runs_backwards_in_traces():
    """A small random-init location model with the time token: the traces
    equal JAX's, and step t feeds (T - t)/T."""
    args = ["task=location_finding", "task.n_query_init=12",
            "encoder.dim_embedding=16", "encoder.dim_feedforward=32",
            "encoder.n_head=2", "encoder.num_layers=2",
            "head.num_components=4", "encoder.with_time_token=true",
            "time_token=true", "task.design_scale=2.0"]
    jc, tc = jcfg.parse_overrides(args), tcfg.parse_overrides(args)
    jtask = JaxLocation(jc.task)
    jbatch = jtask.sample_batch(jax.random.key(4), 3)
    jmodel = jax_build_model(jc)
    params = jmodel.init(jax.random.key(1), jbatch, training=False)
    model = build_model(tc, "cpu")
    model.load_state_dict(convert_flax_params(_flat(params), model))
    seen = []
    model.register_forward_pre_hook(
        lambda mod, args: seen.append(float(args[0].t)))
    Ts = 5
    _, wx, wy = jax_get_traces(jmodel, params, jtask, jbatch, Ts,
                               jax.random.key(0), time_token=True)
    _, gx, gy = get_traces(model, build_task(tc.task),
                           batch_from_numpy(jbatch), Ts, time_token=True)
    assert seen == [np.float32(Ts - t) / np.float32(Ts) for t in range(Ts)]
    # design_scale 2: the history is unnormalised, twice the batch's x
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=0,
                               atol=1e-6)
    assert torch.equal(gx[:, 0], 2.0 * torch.from_numpy(
        np.array(jbatch.x))[:, 0])


@pytest.mark.parametrize("scales", [None, [1.0, 2.5]])
def test_grid_design_is_jax_bitwise(scales):
    jg, tg = jbase.GridDesign(2, scales), tbase.GridDesign(2, scales)
    want = np.asarray(jg.design_candidates(3, 7))
    got = tg.design_candidates(3, 7)
    assert got.shape == (3, 49, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    for t in (0, 11, 48):
        np.testing.assert_array_equal(tg(t, 3).numpy(),
                                      np.asarray(jg(t, 3)))
    np.testing.assert_array_equal(
        tbase.GridDesign(1).design_candidates(1, 30).numpy(),
        np.asarray(jbase.GridDesign(1).design_candidates(1, 30)))
    with pytest.raises(ValueError, match="conflicts"):
        tbase.GridDesign(3, [1.0, 2.0])


@pytest.mark.parametrize("kind,kw", [
    ("uniform", dict(low=-1.0, high=3.0)),
    ("normal", dict(loc=0.5, scale=2.0))])
def test_random_design_log_probs_are_jax(kind, kw):
    jr = jbase.RandomDesign(2, kind, **kw)
    tr = tbase.RandomDesign(2, kind, **kw)
    xi, lp = tr(torch.Generator().manual_seed(0), 500)
    assert xi.shape == (500, 2) and lp.shape == (500,)
    if kind == "uniform":
        assert -1.0 <= xi.min() and xi.max() <= 3.0
        want = -jnp.log(jr.high - jr.low) * jnp.ones((500, 2))
    else:
        assert abs(xi.mean().item() - 0.5) < 0.3
        want = jax_normal_lp(jnp.asarray(xi.numpy()), jr.loc, jr.scale)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(want.sum(-1)))
    cands = tr.design_candidates(torch.Generator().manual_seed(1), 4, 9)
    assert cands.shape == (4, 9, 2)
    with pytest.raises(ValueError, match="not supported"):
        tbase.RandomDesign(2, "beta")
