"""The whole step's share of the card's peak: the least time of the
window's work (model FLOPs, ``counts/aline_flops.py``, over the peak of
the configuration's compute dtype, plus ``other_least_s``, the least
time of other counted work such as the EIG fold) over the time of the
units that did it (synchronised spans of the benchmark's calls)."""


def read(run):
    spans = run.spans.get("unit")
    flops = run.counts.get("model_flops")
    if not spans or not flops:
        return None
    least = flops / run.counts["peak_flops"] + run.counts.get(
        "other_least_s", 0.0)
    return 100.0 * least / sum(spans)
