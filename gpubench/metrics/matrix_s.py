"""matrix_s: seconds a run's host spends turning fetched pair vectors
into corrected matrices (the program's "matrix" spans, host clock;
core/distance.py:784 on one device, :1045 for models 3-6, :1423 on a
mesh: the pair scatter, the division, the distance model, the stats
hook).  The union per run, mean over the runs in the window."""

from gpubench.trace import span_seconds


def read(record):
    return span_seconds(record, ("matrix",))
