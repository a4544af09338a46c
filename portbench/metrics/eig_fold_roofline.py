"""The EIG fold's least time (``counts/eig_fold.py``) over its measured
time: synchronised spans around each ``compute_eig_from_history``
call."""


def read(run):
    spans = run.spans.get("eig_fold")
    least = run.counts.get("eig_fold_least_s")
    if not spans or not least:
        return None
    return 100.0 * least * len(spans) / sum(spans)
