"""The port's sharded sPCE/sNMC bounds over 8 gloo ranks
(``aline_tpu_torch/eval/eig.py`` with ``mesh``; ``tests/torch_ranks.py``,
spawned once for the module), as ``tests/test_eig.py``
``test_one_vs_eight_device_mesh_equal`` holds JAX's on 8 devices:
location finding, B=2, Th=3, L=1024, L_chunk=64, the final-step bounds.

* On the port's own draws, the 1-D contrastive mesh of 8 ranks and the
  2-D (data, contrastive) meshes (2, 4) and (1, 8) give one process's
  bounds within rtol 2e-5 and atol 2e-5.
* On JAX's draws (rebuilt here from JAX's keys: chunk i of the 1-D mesh
  draws ``sample_theta(fold_in(key, i), (Lc, B))``, the 2-D mesh draws
  row b of chunk i from ``fold_in(fold_in(key, i), b)``), the port's 8
  ranks give JAX's bounds on its 8-device CPU meshes within the same
  limits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from aline_tpu import config as jcfg
from aline_tpu.eval.eig import _auto_chunk
from aline_tpu.eval.eig import compute_eig_from_history as jax_eig
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval.eig import compute_eig_from_history
from aline_tpu_torch.tasks.location_finding import HiddenLocation
from torch_ranks import eig_mesh_worker, run_ranks

torch.set_num_threads(1)
WORLD = 8
B, TH, L, L_CHUNK, SEED = 2, 3, 1024, 64, 11
MESHES = (("1d", 8), ("2d", (2, 4)), ("2d", (1, 8)))
RTOL = ATOL = 2e-5


def _jax_task():
    return JaxLocation(jcfg.parse_overrides(["task=location_finding"]).task)


def _jax_mesh(kind, shape):
    devices = np.asarray(jax.devices()[:WORLD])
    if kind == "1d":
        return JaxMesh(devices, ("contrastive",))
    return JaxMesh(devices.reshape(shape), ("data", "contrastive"))


def _jax_draws(task, key, kind):
    """[L, B, 1, 2] the thetas JAX's ``kind`` mesh draws from ``key``."""
    Lc = _auto_chunk(L, B, TH, L_CHUNK)
    chunks = []
    for i in range(-(-L // Lc)):
        k = jax.random.fold_in(key, i)
        if kind == "1d":
            chunks.append(task.sample_theta(k, (Lc, B)))
        else:
            chunks.append(jnp.stack([task.sample_theta(
                jax.random.fold_in(k, b), (Lc,)) for b in range(B)], axis=1))
    return np.asarray(jnp.concatenate(chunks)[:L])


@pytest.fixture(scope="module")
def eig8(tmp_path_factory):
    task = _jax_task()
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    theta_0 = task.sample_theta(k1, (B,))
    x = task.sample_data(k2, B, TH)
    y = task.simulate(k3, x, theta_0[:, None])
    hist = tuple(np.array(a, np.float32) for a in (theta_0, x, y))
    thetas = {m: _jax_draws(task, k1, m[0]) for m in MESHES}
    ranks = run_ranks(eig_mesh_worker, WORLD, tmp_path_factory.mktemp("eig8"),
                      *hist, thetas, L, L_CHUNK, SEED, False, MESHES)
    return dict(task=task, key=k1, hist=hist, thetas=thetas, ranks=ranks)


@pytest.mark.parametrize("kind,shape", MESHES)
def test_eight_ranks_equal_one_process(eig8, kind, shape):
    task = HiddenLocation(tcfg.parse_overrides(
        ["task=location_finding"]).task)
    want = compute_eig_from_history(
        task, *(torch.from_numpy(a) for a in eig8["hist"]), L, SEED,
        L_chunk=L_CHUNK)
    for r in range(WORLD):
        got = eig8["ranks"][r][(kind, shape, False)]
        for g, w, name in zip(got, want, ("pce", "nmc")):
            assert g.shape == (B,)
            np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("kind,shape", MESHES)
def test_eight_ranks_on_jax_draws_equal_jax_eight_devices(eig8, kind, shape):
    task, key = eig8["task"], eig8["key"]
    args = [jnp.asarray(a) for a in eig8["hist"]]
    want = jax_eig(task, *args, L, key, L_chunk=L_CHUNK,
                   mesh=_jax_mesh(kind, shape))
    # the draws rebuilt here are JAX's: on them JAX's one device agrees
    given = jax_eig(task, *args, L, key, L_chunk=L_CHUNK,
                    thetas=jnp.asarray(eig8["thetas"][(kind, shape)]))
    for g, w in zip(given, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    for r in range(WORLD):
        got = eig8["ranks"][r][(kind, shape, True)]
        for g, w, name in zip(got, want, ("pce", "nmc")):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} rank {r}")
