"""fetch_s: seconds a run's host waits for replicates' pair vectors to
reach it from the card (the program's "fetch" spans, host clock;
core/distance.py:781 on one device, :1043 for models 3-6, :1420 on a
mesh): the copy and whatever the card ran before it, the next
replicate's kernels included.  The union per run, mean over the runs in
the window."""

from gpubench.trace import span_seconds


def read(record):
    return span_seconds(record, ("fetch",))
