"""The EIG fold's spans over the measured window."""


def read(run):
    spans = run.spans.get("eig_fold")
    if not spans or run.window_s <= 0:
        return None
    return 100.0 * sum(spans) / run.window_s
