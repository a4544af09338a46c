"""The port's process meshes (``aline_tpu_torch/parallel/mesh.py``) and
sharded logsumexp (``parallel/collectives.py``) against the JAX package's
on the 8 virtual CPU devices.

Rank r of a port mesh sits where device r sits in the JAX mesh of the same
shape: its blocks of ``shard_leading_axis`` and ``pool_bounds`` are the
``addressable_shards`` of device r (JAX's ``shard_query_pool`` for the
pool), the eval meshes' rank grids are the device grids, and each axis'
process group holds the ranks of r's line along it (a 1-D mesh's one
group spans it).  The ranks are 4 gloo processes (``tests/torch_ranks.py``,
spawned once for the module); ``sharded_logsumexp`` over 2 and 4 of them
equals JAX's under ``shard_map`` within 1e-6.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from aline_tpu.parallel import collectives as jcoll
from aline_tpu.parallel import mesh as jmesh
from aline_tpu_torch.parallel import mesh as tmesh
from torch_ranks import mesh_worker, run_ranks

WORLD = 4


def _blocks(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n * 5, 3, 2)).astype(np.float32) * 10
    x[:5, 0, 0] = -np.inf            # a whole block of -inf in one column
    return x


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    blocks = {n: np.split(_blocks(n), n) for n in (2, 4)}
    return run_ranks(mesh_worker, WORLD, tmp_path_factory.mktemp("mesh"),
                     blocks)


def _port_mesh(shape, names, rank):
    """A port mesh seen from ``rank``, without a process group (the
    shard functions read only the rank's position)."""
    devices = np.arange(int(np.prod(shape))).reshape(shape)
    return tmesh.Mesh(tuple(names), devices, rank, {}, None)


def _jax_shards(x, mesh, spec):
    arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("n", [2, 4])
def test_shard_leading_axis_is_jax_placement(n):
    rng = np.random.default_rng(n)
    tree = {"a": rng.normal(size=(8, 3)).astype(np.float32),
            "odd": rng.normal(size=(6, 2)).astype(np.float32),
            "scalar": np.float32(2.0)}
    jm = jmesh.get_mesh(n)
    want = {k: _jax_shards(v, jm, P("data") if np.ndim(v) and
                           v.shape[0] % n == 0 else P())
            for k, v in tree.items()}
    for r in range(n):
        got = tmesh.shard_leading_axis(
            {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()},
            _port_mesh((n,), ("data",), r))
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), want[k][r],
                                          err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("n", [2, 4])
def test_shard_query_pool_is_jax_placement(n):
    """``pool_bounds``' block of each pool field is JAX's shard on device
    r; the fields JAX replicates are those the sharded rollout keeps
    whole."""
    from aline_tpu.tasks.gp import GPTask as JaxGP
    from aline_tpu import config as jcfg
    cfg = jcfg.parse_overrides(["task=al_mix", "task.dim_x=1",
                                "task.n_target_theta=2",
                                "task.n_context_init=1"])
    jbatch = JaxGP(cfg.task).sample_batch(jax.random.key(n), 2,
                                          n_query=4 * n - 1)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    jsharded = jmesh.shard_query_pool(jbatch, jm)
    n_pool = jbatch.x.shape[1]
    for r in range(n):
        lo, hi = tmesh.pool_bounds(n_pool, _port_mesh((n,), ("seq",), r))
        for f in ("x", "y", "ctx_mask", "target_x", "theta"):
            whole = np.asarray(getattr(jbatch, f))
            got = whole[:, lo:hi] if f in ("x", "y", "ctx_mask") else whole
            want = {s.device.id: np.asarray(s.data) for s in
                    getattr(jsharded, f).addressable_shards}[r]
            np.testing.assert_array_equal(got, want, err_msg=f"{f} rank {r}")


def test_mesh_errors_match_jax():
    # the world here is one process, JAX's 8 devices
    for port_call, jax_call, n in (
            (lambda: tmesh.get_mesh(2), lambda: jmesh.get_mesh(9), None),
            (lambda: tmesh.get_eval_mesh(1, 2),
             lambda: jmesh.get_eval_mesh(3, 3), None)):
        with pytest.raises(ValueError) as got:
            port_call()
        with pytest.raises(ValueError) as want:
            jax_call()
        strip = partial(__import__("re").sub, r"\d+", "N")
        assert strip(str(got.value)) == strip(str(want.value))
    # the pool's message is JAX's, word for word
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    with pytest.raises(ValueError) as want:
        jmesh.shard_query_pool(_FakePool(np.zeros((1, 15, 1))), jm)
    with pytest.raises(ValueError) as got:
        tmesh.pool_bounds(15, _port_mesh((2,), ("seq",), 0))
    assert str(got.value) == str(want.value)


class _FakePool:
    def __init__(self, x):
        self.x = x


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_eval_mesh_grids_are_jax_device_grids(ranks, shape):
    jm = jmesh.get_eval_mesh(*shape)
    jgrid = np.vectorize(lambda d: d.id)(jm.devices)
    for r, res in enumerate(ranks):
        g = res["grids"][shape]
        np.testing.assert_array_equal(g["devices"], jgrid)
        pos = tuple(int(i) for i in np.argwhere(jgrid == r)[0])
        assert g["coords"] == {"data": pos[0], "contrastive": pos[1]}
        # each axis' group: the devices of r's line along that axis
        assert g["groups"]["data"] == sorted(jgrid[:, pos[1]].tolist())
        assert g["groups"]["contrastive"] == sorted(jgrid[pos[0]].tolist())


def test_get_mesh_takes_every_rank(ranks):
    jgrid = np.vectorize(lambda d: d.id)(jmesh.get_mesh(WORLD).devices)
    for r, (devices, coords, one_group) in enumerate(r["get_mesh"]
                                                     for r in ranks):
        np.testing.assert_array_equal(devices, jgrid)
        assert coords == {"data": r}
        assert one_group


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_logsumexp_matches_jax(ranks, n):
    x = _blocks(n)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("contrastive",))
    want = jax.jit(jax.shard_map(
        partial(jcoll.sharded_logsumexp, axis_name="contrastive"), mesh=jm,
        in_specs=P("contrastive"), out_specs=P(),
        check_vma=False))(jnp.asarray(x))
    outside = [r for r in range(WORLD) if r >= n]
    assert all(n not in ranks[r]["lse"] for r in outside)
    for r in range(n):
        got = ranks[r]["lse"][n]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")
    # and the single-device logsumexp of the whole array
    np.testing.assert_allclose(ranks[0]["lse"][n],
                               torch.logsumexp(torch.from_numpy(x), 0),
                               rtol=1e-6, atol=1e-6)


def test_init_distributed_keeps_the_device(monkeypatch):
    """One process: no process group, and an unindexed ``cuda`` stays as
    it is (no ``set_device`` of it); more local ranks than cards is an
    error, never a fallback."""
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.init_distributed("cuda") == torch.device("cuda")
    assert calls == [] and not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no card of its own"):
        tmesh.init_distributed("cuda", rank=1, world=2)
    assert tmesh.init_distributed("cpu") == torch.device("cpu")


def test_run_ranks_starts_on_the_card_by_default():
    """``spawn.run_ranks``, like every entry point of the port, runs on the
    card unless the caller names the CPU (``tests/torch_ranks.py`` does)."""
    import inspect
    from aline_tpu_torch.parallel import spawn
    params = inspect.signature(spawn.run_ranks).parameters
    assert params["device"].default == "cuda"
    assert params["backend"].default is None    # NCCL on the card
