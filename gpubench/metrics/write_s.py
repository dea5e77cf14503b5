"""write_s: seconds a run spends writing its matrices (the program's
"write" spans, host clock; runner.py:384, parallel/multihost.py:809 for
several processes: io/writers.write_dist_matrix, the flush and the
checkpoint sidecar).  The union per run, mean over the runs in the
window."""

from gpubench.trace import span_seconds


def read(record):
    return span_seconds(record, ("write",))
