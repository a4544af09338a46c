"""The psychometric benchmark's inputs, drawn on the device from a seed:
each subject's parameters uniform on the task's ranges
(``reference/psych.py`` ``RANGES``), the candidate stimuli uniform on
[-design_scale, design_scale], and one uniform for each initial context
point (``u0``) and each trial (``u``), from which ``reference/psych.py``
``respond`` makes the subject's answers.  Like ``gen.py``, it imports
nothing of the program."""
from __future__ import annotations

import torch

from portbench.reference.psych import RANGES


def subjects(gen: torch.Generator, n: int, n_query: int, T: int,
             task: dict) -> dict:
    """``theta`` [n, 4], stimuli ``x`` [n, n_ctx + n_query, 1], ``u0``
    [n, n_ctx] and ``u`` [n, T]."""
    dev = gen.device
    lo = torch.tensor([r[0] for r in RANGES], device=dev)
    hi = torch.tensor([r[1] for r in RANGES], device=dev)
    theta = lo + (hi - lo) * torch.rand((n, len(RANGES)), generator=gen,
                                        device=dev)
    n_ctx, s = task["n_context_init"], task["design_scale"]
    x = -s + 2.0 * s * torch.rand((n, n_ctx + n_query, task["dim_x"]),
                                  generator=gen, device=dev)
    u0 = torch.rand((n, n_ctx), generator=gen, device=dev)
    u = torch.rand((n, T), generator=gen, device=dev)
    return dict(theta=theta, x=x, u0=u0, u=u)
