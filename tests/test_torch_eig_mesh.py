"""The port's sharded sPCE/sNMC bounds (``aline_tpu_torch/eval/eig.py``
with ``mesh``) on location finding's fixed histories, over 4 gloo ranks
(``tests/torch_ranks.py``, spawned once for the module).

* On the port's own draws, the 1-D contrastive meshes (2 and 4 ranks) and
  the 2-D (data, contrastive) meshes (2,2), (1,4), (4,1) give the
  single-process bounds at the same seed within 1e-5: one draw rule for
  every mesh (chunk i draws [Lc, B] for the global batch from
  ``derive_seed(seed, i)``), so only the order of the fold differs.  The
  4-way contrastive split of 3 chunks leaves one rank with none.
* On JAX's given thetas, the sharded bounds equal
  ``aline_tpu/eval/eig.py compute_eig_from_history(thetas=...)`` within
  1e-4, as ``tests/test_torch_eig.py`` holds the single-process ones.
* sNMC - sPCE >= log(L / (L + 1)) - 1e-5 on every row.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.eval.eig import compute_eig_from_history as jax_eig
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval.eig import (compute_eig_from_history,
                                      eval_eig_from_history)
from aline_tpu_torch.tasks.location_finding import HiddenLocation
from torch_ranks import EIG_MESHES, eig_mesh_worker, run_ranks

torch.set_num_threads(1)
WORLD = 4
B, TH, SEED = 8, 5, 11
# (L, L_chunk): 10 chunks (the last one short), and 3 chunks over up to 4
# contrastive ranks
CASES = {"ten": (1000, 96), "three": (300, 100)}


def _histories(L):
    rng = np.random.default_rng(L)
    f32 = np.float32
    theta_0 = rng.uniform(size=(B, 1, 2)).astype(f32)
    x = rng.uniform(size=(B, TH, 2)).astype(f32)
    task = _port_task()
    signal = task.total_density(torch.from_numpy(x),
                                torch.from_numpy(theta_0)[:, None]).numpy()
    y = (signal + 0.5 * rng.normal(size=signal.shape)).astype(f32)
    thetas = rng.uniform(size=(L, B, 1, 2)).astype(f32)
    return theta_0, x, y, thetas


def _port_task():
    return HiddenLocation(tcfg.parse_overrides(
        ["task=location_finding"]).task)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    L, L_chunk = CASES[request.param]
    stepwise = request.param == "ten"
    hist = _histories(L)
    ranks = run_ranks(eig_mesh_worker, WORLD,
                      tmp_path_factory.mktemp("eig_mesh"), *hist, L,
                      L_chunk, SEED, stepwise)
    return dict(L=L, L_chunk=L_chunk, stepwise=stepwise, hist=hist,
                ranks=ranks)


def _members(kind, shape):
    n = shape if kind == "1d" else shape[0] * shape[1]
    return range(n)


def _single(case, thetas=None):
    theta_0, x, y, _ = case["hist"]
    return compute_eig_from_history(
        _port_task(), *(torch.from_numpy(a) for a in (theta_0, x, y)),
        case["L"], SEED, L_chunk=case["L_chunk"],
        stepwise=case["stepwise"], thetas=thetas)


@pytest.mark.parametrize("kind,shape", EIG_MESHES)
def test_sharded_bounds_equal_single_process(case, kind, shape):
    want = [w.numpy() for w in _single(case)]
    for r in _members(kind, shape):
        got = case["ranks"][r][(kind, shape, False)]
        for g, w, name in zip(got, want, ("pce", "nmc")):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} rank {r}")
        pce, nmc = got
        assert (nmc - pce >= math.log(case["L"] / (case["L"] + 1))
                - 1e-5).all()
    for r in range(WORLD):
        if r not in _members(kind, shape):
            assert (kind, shape, False) not in case["ranks"][r]


@pytest.mark.parametrize("kind,shape", EIG_MESHES)
def test_sharded_bounds_on_jax_thetas(case, kind, shape):
    theta_0, x, y, thetas = case["hist"]
    jt = JaxLocation(jcfg.parse_overrides(["task=location_finding"]).task)
    want = jax_eig(jt, jnp.asarray(theta_0), jnp.asarray(x), jnp.asarray(y),
                   case["L"], jax.random.key(0), L_chunk=case["L_chunk"],
                   stepwise=case["stepwise"], thetas=jnp.asarray(thetas))
    for r in _members(kind, shape):
        got = case["ranks"][r][(kind, shape, True)]
        for g, w, name in zip(got, want, ("pce", "nmc")):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("shape", [s for k, s in EIG_MESHES if k == "2d"])
def test_eval_eig_from_history_on_the_mesh(case, shape):
    theta_0, x, y, _ = case["hist"]
    want = eval_eig_from_history(
        _port_task(), *(torch.from_numpy(a) for a in (theta_0, x, y)),
        case["L"], SEED, batch_size=4, stepwise=case["stepwise"],
        L_chunk=case["L_chunk"])
    for r in _members("2d", shape):
        got = case["ranks"][r][("2d", shape, "eval")]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {r}")


def test_mesh_refuses_L_checkpoints_and_uneven_rows():
    from aline_tpu_torch.parallel.mesh import Mesh
    theta_0, x, y, _ = _histories(300)
    args = [torch.from_numpy(a) for a in (theta_0, x, y)]
    mesh = Mesh(("data", "contrastive"), np.arange(3).reshape(3, 1), 0, {},
                None)
    with pytest.raises(ValueError, match="batch 8 must divide mesh data"):
        compute_eig_from_history(_port_task(), *args, 300, 0, mesh=mesh)
    with pytest.raises(ValueError, match="L_checkpoints"):
        compute_eig_from_history(_port_task(), *args, 300, 0, mesh=mesh,
                                 L_checkpoints=[100])
