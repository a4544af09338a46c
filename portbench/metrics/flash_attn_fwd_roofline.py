"""The bf16 flash forward's share of its roofline: the traced unit's
forwards' least time (``counts/flash_attn.py`` at each rollout's shapes
and mask) over the device time of ``flash_attn_fwd_bf16_kernel`` by
name in the trace.  Read only where the trace's calls equal the
program's counted launches (``flash.fwd``) and the calls the least time
covers; None on a program without the counter."""

NAME = "flash_attn_fwd_bf16_kernel"


def read(run):
    t, c = run.trace, run.counts
    if not t or not c.get("flash_fwd_least_s"):
        return None
    calls = sum(n for k, (n, _) in t["by_name"].items() if NAME in k)
    secs = sum(s for k, (_, s) in t["by_name"].items() if NAME in k)
    if not calls or not calls == c.get("flash_fwd_launches") \
            == c["flash_fwd_least_calls"]:
        return None
    return 100.0 * c["flash_fwd_least_s"] / secs
