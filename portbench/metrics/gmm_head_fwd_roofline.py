"""The GMM head kernel's least time on the pool (``counts/gmm_head.py``)
over its device time by name in the trace.  Read only where every
traced launch is a pool call (``gmm_pool_calls_per_unit`` a unit)."""

NAME = "gmm_head_fwd"


def read(run):
    t = run.trace
    least = run.counts.get("gmm_pool_least_s")
    if not t or not least:
        return None
    calls = sum(c for n, (c, _) in t["by_name"].items() if NAME in n)
    secs = sum(s for n, (_, s) in t["by_name"].items() if NAME in n)
    want = run.counts.get("gmm_pool_calls_per_unit", 0) * run.trace_units
    if not calls or calls != want:
        return None
    return 100.0 * least * calls / secs
