"""The bf16 flash backward's share of its roofline: the traced unit's
backwards' least time (``counts/flash_attn.py``) over the summed device
time of its two passes by name, ``flash_attn_bwd_dq_bf16_kernel`` and
``flash_attn_bwd_dkdv_bf16_kernel`` (one ``flash_attn_bwd`` launches
both).  Read only where each pass's calls equal the program's counted
launches (``flash.bwd``) and the calls the least time covers; None on a
program without the counter."""

NAMES = ("flash_attn_bwd_dq_bf16_kernel", "flash_attn_bwd_dkdv_bf16_kernel")


def read(run):
    t, c = run.trace, run.counts
    if not t or not c.get("flash_bwd_least_s"):
        return None
    secs = 0.0
    for name in NAMES:
        calls = sum(n for k, (n, _) in t["by_name"].items() if name in k)
        if not calls or not calls == c.get("flash_bwd_launches") \
                == c["flash_bwd_least_calls"]:
            return None
        secs += sum(s for k, (_, s) in t["by_name"].items() if name in k)
    return 100.0 * c["flash_bwd_least_s"] / secs
