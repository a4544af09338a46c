"""The flash mechanism's share of the traced unit's device work: the
device time of the plan, forward and backward kernels by name over the
union of the device intervals (``busy_s``).  None where no such kernel
ran."""

NAMES = ("flash_plan_kernel", "flash_attn_fwd_bf16_kernel",
         "flash_attn_bwd_dq_bf16_kernel", "flash_attn_bwd_dkdv_bf16_kernel")


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    secs = sum(s for k, (_, s) in t["by_name"].items()
               if any(n in k for n in NAMES))
    if not secs:
        return None
    return 100.0 * secs / t["busy_s"]
