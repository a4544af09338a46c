"""The GMM head's forward over a token set, counted from its shapes:
for each of C components an MLP z·W1 + b1 → relu → ·W2 + b2 (3 outputs)
on every token.  Each product is counted once (2 FLOPs a multiply-add),
whatever an implementation does to keep float32 accuracy; each input
byte (z, the weights) is read once and each output byte written once.

The least time divides the FLOPs by the card's TF32 tensor-core peak:
a product to float32 accuracy needs at least one tensor-core product of
a format at least as wide as TF32, or several narrower ones (three
bfloat16 products at 989 TFLOP/s give 330), or the float32 FMA units
(67 TFLOP/s), so no float32-accurate implementation passes the TF32
rate.
"""
from __future__ import annotations


def fwd_flops(B: int, T: int, D: int, F: int, C: int) -> int:
    return 2 * B * T * C * (D * F + F * 3)


def fwd_bytes(B: int, T: int, D: int, F: int, C: int) -> int:
    return 4 * (B * T * D + C * (D * F + F + 3 * F + 3) + B * T * C * 3)


def fwd_least_s(B: int, T: int, D: int, F: int, C: int,
                peaks: dict) -> float:
    return max(fwd_flops(B, T, D, F, C) / peaks["tf32_flops"],
               fwd_bytes(B, T, D, F, C) / peaks["hbm_bytes_per_s"])
