"""The median live experiment's time in the window, a steadier
statistic beside the 95th percentile."""
import statistics


def read(run):
    spans = run.spans.get("unit")
    if not spans:
        return None
    return 1e3 * statistics.median(spans)
