"""The EIG fold's throughput: the (draw, row, step) terms that the
program counted as folded (``eig.terms``) over the stream seconds of its
``eig.chunk`` spans, in 1e9 terms a second, in the measured window of a
traced run.  None where the program has no such counter or spans."""


def read(run):
    terms = run.counts.get("eig_terms")
    chunk = run.spans.get("prog.eig.chunk")
    if not terms or not chunk or sum(chunk) <= 0:
        return None
    return terms / sum(chunk) / 1e9
