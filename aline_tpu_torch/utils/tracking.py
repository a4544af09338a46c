"""Per-epoch metric series (``aline_tpu/utils/tracking.py``): an
append-only ``metrics.jsonl`` in the run directory."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class RunTracker:
    def __init__(self, output_dir: str, config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()
        if config is not None:
            self._write({"_type": "config", "config": config})

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log(self, metrics: Dict[str, float], step: int) -> None:
        self._write({"_type": "metrics", "step": step,
                     "time": time.time() - self._t0,
                     **{k: float(v) for k, v in metrics.items()}})

    def finish(self) -> None:
        self._f.close()
