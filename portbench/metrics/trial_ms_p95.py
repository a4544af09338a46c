"""The 95th percentile of a live trial's host time: the program's
``live.trial`` spans (a proposal, from its call until the design is on
the host) of the traced experiments."""
from portbench.harness import quantile


def read(run):
    spans = run.spans.get("trial")
    if not spans:
        return None
    return 1e3 * quantile(spans, 0.95)
