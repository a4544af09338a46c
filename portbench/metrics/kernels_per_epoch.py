"""Device operations (every kernel, copy and fill in the trace) per
training epoch traced."""


def read(run):
    if not run.trace or not run.trace_units:
        return None
    return run.trace["n_device"] / run.trace_units
