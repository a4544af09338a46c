"""The port's analytic benchmark task (``aline_tpu_torch.tasks.benchmarks``)
against ``aline_tpu/tasks/benchmarks.py`` on the CPU.

The ten functions and the domain rescaling agree to 1e-5 relative plus
1e-6 on the same inputs; ``sample_batch`` in ``data`` and ``mix`` modes
gives JAX's layout and values on JAX's draws (``split(key)``: the
uniform designs from the first key, the noise from the second), without
changing the task; a 2-D function on a 1-D run raises JAX's ValueError,
through ``eval_al --benchmark`` too.
"""
import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.tasks.benchmarks import BENCHMARKS as JAX_BENCHMARKS
from aline_tpu.tasks.benchmarks import BenchmarkTask as JaxBenchmarkTask
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval_al import main as eval_al_main
from aline_tpu_torch.tasks import BENCHMARKS, BenchmarkTask, build_task

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _tasks(**kw):
    jc = dataclasses.replace(jcfg.parse_overrides(["task=benchmark"]).task,
                             **kw)
    tc = dataclasses.replace(tcfg.parse_overrides(["task=benchmark"]).task,
                             **kw)
    return JaxBenchmarkTask(jc), BenchmarkTask(tc)


def test_config_and_registry_match_jax():
    assert tcfg.to_dict(tcfg.parse_overrides(["task=benchmark"])) == \
        jcfg.to_dict(jcfg.parse_overrides(["task=benchmark"]))
    assert isinstance(build_task(tcfg.parse_overrides(
        ["task=benchmark"]).task), BenchmarkTask)
    assert set(BENCHMARKS) == set(JAX_BENCHMARKS)
    for name, spec in BENCHMARKS.items():
        assert spec["dim"] == JAX_BENCHMARKS[name]["dim"]
        assert spec["domain"] == JAX_BENCHMARKS[name]["domain"]


@pytest.mark.parametrize("name", sorted(BENCHMARKS))
def test_functions_and_rescaling_match_jax(name):
    dim = BENCHMARKS[name]["dim"]
    jt, tt = _tasks(dim_x=dim, design_scale=2.5)
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-2.5, 2.5, size=(3, 50, dim)).astype(np.float32)
    want_x = jt._scale_input_to_domain(jnp.asarray(x), name)
    got_x = tt._scale_input_to_domain(torch.from_numpy(x), name)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-6)
    xd = np.array(want_x)
    want = JAX_BENCHMARKS[name]["func"](jnp.asarray(xd))
    got = BENCHMARKS[name]["func"](torch.from_numpy(xd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the noisy observation on JAX's own noise draw
    key = jax.random.key(3)
    want_y = jt.simulate(key, jnp.asarray(x), name)
    eps = np.asarray(jax.random.normal(key, want_y.shape))
    got_y = tt.observe(torch.from_numpy(x), torch.from_numpy(eps), name)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("emb,mode", [("data", "data"), ("mix", "mix"),
                                      ("data", "mix")])
def test_sample_batch_matches_jax_on_its_draws(emb, mode):
    kw = dict(dim_x=1, embedding_type=emb, n_target_theta=2,
              benchmark_name="higdon")
    jt, tt = _tasks(**kw)
    B, n_query = 4, 7
    key = jax.random.key(5)
    want = jt.sample_batch(key, B, n_query=n_query, mode=mode)
    k_x, k_y = jax.random.split(key)
    n_total = tt.n_context_init + n_query + tt.n_target_data
    x_all = jax.random.uniform(k_x, (B, n_total, 1), minval=-5.0,
                               maxval=5.0)
    eps = jax.random.normal(k_y, (B, n_total, 1))
    got = tt.batch_from_draws(
        torch.from_numpy(np.asarray(x_all)),
        tt.observe(torch.from_numpy(np.asarray(x_all)),
                   torch.from_numpy(np.asarray(eps))), n_query, mode)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if g is None or w is None:
            assert g is None and w is None, f.name
        elif f.name == "ctx_capacity":
            assert g == w
        else:
            assert tuple(g.shape) == tuple(np.shape(w)), f.name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=f.name)
    # no attribute of the task moves, unlike JAX's temporary mutation
    before = dict(vars(tt))
    tt.sample_batch(torch.Generator().manual_seed(0), B, n_query, mode=mode)
    assert vars(tt) == before
    assert (tt.embedding_type, tt.n_target_theta) == (
        emb, 2 if emb == "mix" else 0)


def test_two_dimensional_function_on_a_1d_run_raises_jax_error(tmp_path):
    jt, tt = _tasks(dim_x=1)
    x = np.zeros((2, 3, 1), np.float32)
    with pytest.raises(ValueError) as want:
        jt.simulate(jax.random.key(0), jnp.asarray(x), "branin")
    with pytest.raises(ValueError) as got:
        tt.simulate(torch.Generator(), torch.from_numpy(x), "branin")
    assert str(got.value) == str(want.value)
    run = tmp_path / "al"
    run.mkdir()
    shutil.copy(ROOT / "checkpoints" / "al1d_200k" / "config.json", run)
    with pytest.raises(ValueError, match="requires dim 2"):
        eval_al_main([str(run), "--device", "cpu", "--batch-size", "2",
                      "--T", "1", "--n-query", "4", "--benchmark",
                      "branin"])


def test_eval_al_benchmark_writes_the_jax_keys(tmp_path):
    run = tmp_path / "al"
    run.mkdir()
    shutil.copy(ROOT / "checkpoints" / "al1d_200k" / "config.json", run)
    res = eval_al_main([str(run), "--device", "cpu", "--batch-size", "2",
                        "--T", "2", "--n-query", "8", "--benchmark",
                        "forrester"])
    for s in ("aline", "random", "uncertainty"):
        r = res[f"bench_forrester_{s}_rmse"]
        assert r.shape == (2, 3) and np.isfinite(r).all(), s


def test_benchmark_curves_do_not_depend_on_the_gp_section(tmp_path):
    """The benchmark section draws from its own generator, as JAX's does
    from its fixed keys: adding ``--with-gp-baselines`` leaves it be."""
    run = tmp_path / "al"
    run.mkdir()
    shutil.copy(ROOT / "checkpoints" / "al1d_200k" / "config.json", run)
    argv = [str(run), "--device", "cpu", "--batch-size", "2", "--T", "2",
            "--n-query", "8", "--benchmark", "higdon"]
    alone = eval_al_main(argv)
    both = eval_al_main(argv + ["--with-gp-baselines", "--gp-fit-steps",
                                "2"])
    keys = [k for k in alone if k.startswith("bench_")]
    assert len(keys) == 3 and "gp_random_rmse" in both
    for k in keys:
        np.testing.assert_array_equal(both[k], alone[k], err_msg=k)
