"""Device operations (every kernel, copy and fill in the trace) per live
trial traced: the trace's count over the program's ``live.trials``
counter (the posterior's forward included in its experiment's)."""


def read(run):
    n = run.counts.get("live_trials")
    if not run.trace or not n:
        return None
    return run.trace["n_device"] / n
