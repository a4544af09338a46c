"""Target masks and target weights (``aline_tpu/ops/target_mask.py``).

The port's own copy of the two framework-free functions it trains with.
A mask is built on the host with numpy once per epoch and shared across
the batch; the reference's branches on ``(embedding_type, mask_type)``
collapse into two weight vectors, so that

    nll_query      = -(target_ll * w_query).sum(-1)
    nll_prediction = -(target_ll * w_prediction).sum(-1)
"""
from __future__ import annotations

import random as pyrandom
from typing import Optional, Sequence, Tuple

import numpy as np


def create_target_mask(
    mask_type: str,
    embedding_type: str,
    n_target_data: int,
    n_target_theta: int,
    n_selected_targets: Optional[int] = None,
    predefined_masks: Optional[Sequence[Sequence[bool]]] = None,
    predefined_mask_weights: Optional[Sequence[float]] = None,
    mask_index: Optional[int] = None,
    attend_to: Optional[str] = None,
    rng: Optional[pyrandom.Random] = None,
) -> np.ndarray:
    """A boolean [n_target_data + n_target_theta] mask.

    - ``all``:        every target.
    - ``none``:       no target.
    - ``partial``:    a random subset of ``n_selected_targets`` (data and
                      theta modes).
    - ``predefined``: one of ``predefined_masks``, by ``mask_index`` if
                      given, else a weighted (or uniform) random choice.
    - ``split``:      mix mode only: all data targets or all theta targets,
                      by ``attend_to`` or a fair coin.
    """
    rng = rng or pyrandom
    n_target = n_target_data + n_target_theta
    mask = np.zeros(n_target, dtype=bool)

    if mask_type == "all":
        mask[:] = True
    elif mask_type == "none":
        pass
    elif mask_type == "partial":
        if embedding_type in ("data", "theta"):
            idx = rng.sample(range(n_target), int(n_selected_targets))
            mask[idx] = True
    elif mask_type == "predefined":
        if mask_index is not None:
            chosen = predefined_masks[mask_index]
        elif (predefined_mask_weights is not None
              and len(predefined_mask_weights) == len(predefined_masks)):
            w = np.asarray(predefined_mask_weights, dtype=np.float64)
            p = (w / w.sum()).tolist()
            idx = rng.choices(range(len(predefined_masks)), weights=p)[0]
            chosen = predefined_masks[int(idx)]
        else:
            chosen = rng.choice(list(predefined_masks))
        for i, should_attend in enumerate(chosen):
            if i < n_target and should_attend:
                mask[i] = True
    elif mask_type == "split":
        if embedding_type == "mix":
            if attend_to is not None:
                attend_to_data = attend_to == "data"
            else:
                attend_to_data = rng.choice([True, False])
            if attend_to_data:
                mask[:n_target_data] = True
            else:
                mask[n_target_data:] = True
    else:
        raise ValueError(f"unknown mask_type {mask_type!r}")
    return mask


def target_weight_vectors(
    mask: np.ndarray,
    embedding_type: str,
    mask_type: str,
    n_target_data: int,
    n_target_theta: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(w_query, w_prediction)``, float32 [n_target], such that
    ``-(ll * w).sum(-1)`` is, for a per-target log-likelihood ``ll``:

    * query NLL: ``-mean(ll[mask])``; in mix mode with ``mask_type='all'``
      the data part and the theta part are averaged apart and summed;
    * prediction NLL: ``-mean(ll)``; in mix mode the data-part mean plus
      the theta-part mean.
    """
    mask = np.asarray(mask, dtype=bool)
    n_target = n_target_data + n_target_theta
    assert mask.shape == (n_target,)

    def _normalized(m: np.ndarray) -> np.ndarray:
        w = m.astype(np.float32)
        s = w.sum()
        return w / s if s > 0 else w

    def _mix_split_weights(m: np.ndarray) -> np.ndarray:
        data_part = np.zeros(n_target, dtype=bool)
        data_part[:n_target_data] = True
        w = np.zeros(n_target, dtype=np.float32)
        for part in (m & data_part, m & ~data_part):
            c = part.sum()
            if c > 0:
                w[part] = 1.0 / c
        return w

    if embedding_type == "mix" and mask_type == "all":
        w_query = _mix_split_weights(mask)
    else:
        w_query = _normalized(mask)

    if embedding_type == "mix":
        w_pred = _mix_split_weights(np.ones(n_target, dtype=bool))
    else:
        w_pred = _normalized(np.ones(n_target, dtype=bool))

    return w_query, w_pred
