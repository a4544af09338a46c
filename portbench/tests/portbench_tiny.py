"""Tiny sizes of every cell, for the CPU tests: the published widths,
small batches, pools, horizons and contrastive counts."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.harness import find_cell, load_benchmark, load_config, \
    load_traffic  # noqa: E402

TINY = {
    "train_epochs": dict(batch_size=8, T=4, n_query=12, checked_steps=3,
                         warmup_units=1, reference_block_rows=4),
    "bed_batches": dict(batch_size=6, n_query=20, T=4, L=3000, L_chunk=700,
                        n_inputs=3, check_rows=4, reference_block_rows=2),
    "al_eval": dict(batch_size=4, n_query=30, T=4, n_inputs=2, check_rows=3,
                    reference_block_rows=3),
    "live_experiments": dict(n_query=20, T=4, n_inputs=20, check_units=5),
}
CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEED = 2**31 + 977


def parts(cell: str, f32: bool = False):
    """(config, traffic) of a cell at its tiny size; ``f32``: the model
    computed in float32 by the program and the reference alike."""
    c = find_cell(load_benchmark(), cell)
    cf = copy.deepcopy(load_config(c["config"]))
    tr = load_traffic(c["traffic"])
    tr = dict(tr, **TINY[tr["kind"]])
    if f32:
        cf["run"]["dtype"] = "float32"
        cf["precision"]["model"] = "float32"
    return cf, tr


def run_tiny(cell: str, f32: bool = False, seconds: float = 0.3,
             seed: int = SEED):
    cf, tr = parts(cell, f32)
    return R.execute(cell, seed, seconds, False, "cpu", config=cf,
                     traffic=tr)
