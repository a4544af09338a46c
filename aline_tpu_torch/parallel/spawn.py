"""Ranks as spawned processes on one host.

``run_ranks(worker, world, *args)`` starts ``world`` processes
(``torch.multiprocessing``, spawn), starts rank r's process group in each
through a file in a fresh temporary directory (no TCP port to collide),
runs ``worker(rank, world, *args)`` and returns every rank's result.  A
rank sends its tensors back as numpy arrays: a tensor put on a queue is
shared through a file descriptor that dies with its process.  Every wait
has a timeout, so a rank that hangs fails the call instead of holding it.
``worker`` must be importable by name (a module's top-level function).
"""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import traceback
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from aline_tpu_torch.parallel.mesh import init_distributed, map_leaves

RANK_TIMEOUT_S = 300


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _entry(rank, world, device, backend, init_file, timeout, num_threads,
           worker, args, out):
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        init_distributed(device, backend=backend,
                         init_method=f"file://{init_file}", rank=rank,
                         world=world, timeout=timeout)
        result = worker(rank, world, *args)
        dist.barrier()
        out.put((rank, True, map_leaves(_numpy, result)))
    except BaseException:                        # noqa: BLE001 (reported)
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(worker, world: int, *args, device="cuda",
              backend: Optional[str] = None, tmp_dir=None,
              timeout: float = RANK_TIMEOUT_S,
              num_threads: Optional[int] = None) -> list:
    """[result of rank 0, ..., rank world-1] of ``worker(rank, world,
    *args)``, tensors as numpy arrays.  Each rank runs on ``device``
    (``init_distributed``: ``"cuda"``, the default, is one card a rank;
    an indexed device is shared; ``"cpu"`` runs the ranks on the CPU)
    over ``backend`` (NCCL on CUDA, gloo on the CPU by
    default); the rendezvous file lies in a directory made under
    ``tmp_dir`` (the system's temporary directory by default) and removed
    after.  Raises if a rank fails or does not answer within ``timeout``
    seconds."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="pg_",
                           dir=None if tmp_dir is None else str(tmp_dir))
    init_file = os.path.join(tmp, "init")
    procs = [ctx.Process(target=_entry, daemon=True, args=(
        r, world, device, backend, init_file, timeout, num_threads, worker,
        args, out)) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, ok, res = out.get(timeout=timeout)
            except queue_mod.Empty:
                errors.append(f"no answer within {timeout} s")
                break
            if ok:
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise AssertionError("ranks failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
