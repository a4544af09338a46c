"""The likelihood's share of the generic EIG fold: the stream seconds of
the program's ``eig.loglik`` spans (the task's log-likelihood over
[Lc, B, Th], its running sum, the padding) over those of its
``eig.chunk`` spans, in the measured window of a traced run.  None where
the program has no such spans."""


def read(run):
    loglik = run.spans.get("prog.eig.loglik")
    chunk = run.spans.get("prog.eig.chunk")
    if not loglik or not chunk or sum(chunk) <= 0:
        return None
    return 100.0 * sum(loglik) / sum(chunk)
