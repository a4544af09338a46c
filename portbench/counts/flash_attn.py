"""The bfloat16 role-masked flash pair (``flash_attn_fwd_bf16``,
``flash_attn_bwd_bf16``), counted from the shapes [B, H, N, dh] and the
(row, key) pairs the mask allows, as ``chip_smoke.py`` bounds it.

Pairs: every row reads the ``n_ctx`` context keys, and the ``n_query``
query rows (the pool points outside the context) also read the
``n_sel`` selected targets: ``N·n_ctx + n_query·n_sel`` a batch row and
head, the pairs of ``aline_flops.forward``.

Operations, 2 FLOPs a multiply-add over the pairs:

* forward: q·kᵀ of two bfloat16 operands, P·V with P in float32;
* backward: q·kᵀ again and dO·vᵀ of two bfloat16 operands, dS·K, Pᵀ·dO
  and dSᵀ·Q with a float32 operand.

A product of two bfloat16 operands runs at the bf16 tensor cores' peak;
one with a float32 operand at the lesser time of two forms, the float32
FMA units or three bfloat16 products on the tensor cores (as the kernels
run it).  Bytes: each element of q, k, v, O (and dO, dQ, dK, dV) read or
written once at 2 bytes, lse (and the backward's Δ) at 4 a row, and the
plan's two int32 permutations a token.  The least time is the larger of
the operations' and the bytes' times.
"""
from __future__ import annotations


def pairs(N: int, n_ctx: int, n_query: int, n_sel: int) -> int:
    """Allowed (row, key) pairs of one batch row and head."""
    return N * n_ctx + n_query * n_sel


def fwd_bytes(B: int, H: int, N: int, dh: int) -> int:
    return 2 * 4 * B * H * N * dh + 4 * B * H * N + 4 * 2 * B * N


def bwd_bytes(B: int, H: int, N: int, dh: int) -> int:
    return 2 * 8 * B * H * N * dh + 4 * 2 * B * H * N + 4 * 2 * B * N


def least_s(bf16_flops: float, f32_flops: float, nbytes: float,
            peaks: dict) -> float:
    t_bf16 = bf16_flops / peaks["bf16_flops"]
    t_ops = t_bf16 + min(f32_flops / peaks["fp32_flops"],
                         3 * f32_flops / peaks["bf16_flops"])
    return max(t_ops, nbytes / peaks["hbm_bytes_per_s"])


def fwd_least_s(B: int, H: int, N: int, dh: int, n_pairs: int,
                peaks: dict) -> float:
    """One forward; ``n_pairs`` summed over the batch rows, per head."""
    f = 2 * H * n_pairs * dh
    return least_s(f, f, fwd_bytes(B, H, N, dh), peaks)


def bwd_least_s(B: int, H: int, N: int, dh: int, n_pairs: int,
                peaks: dict) -> float:
    """One backward (its dQ and dK/dV passes); ``n_pairs`` as above."""
    f = 2 * H * n_pairs * dh
    return least_s(2 * f, 3 * f, bwd_bytes(B, H, N, dh), peaks)


def rollout_least_s(sizes: dict, n_head: int, B: int, n_points: int,
                    n_ctx0: int, n_target: int, n_sel: int, T: int,
                    remat: bool, peaks: dict):
    """(calls, least seconds) of the forwards and of the backwards of a
    trained T-step rollout: each step a forward of every layer at the
    step's context (``n_ctx0 + t``), recomputed in the backward pass
    under ``remat``, and a backward of every layer."""
    D, layers = sizes["D"], sizes["num_layers"]
    dh, N = D // n_head, n_points + n_target
    fwd = bwd = 0.0
    for t in range(T):
        n_ctx = n_ctx0 + t
        p = B * pairs(N, n_ctx, n_points - n_ctx, n_sel)
        fwd += fwd_least_s(B, n_head, N, dh, p, peaks)
        bwd += bwd_least_s(B, n_head, N, dh, p, peaks)
    passes = 2 if remat else 1
    return (dict(fwd=passes * layers * T, bwd=layers * T),
            dict(fwd=passes * layers * fwd, bwd=layers * bwd))
