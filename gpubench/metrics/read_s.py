"""read_s: seconds a run spends reading its input (the program's "read"
and "scan" spans, host clock; runner.load_inputs and the fused reader of
io/readers.py), the union per run, mean over the runs in the window."""

from gpubench.trace import span_seconds


def read(record):
    return span_seconds(record, ("read", "scan"))
