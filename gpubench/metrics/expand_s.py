"""expand_s: seconds a run's code planes take to expand into triples on
the card (the program's "expand" spans, CUDA events on the upload's copy
stream, inside "upload"; core/distance.py ChunkPipe, expand_codes), the
union per run, mean over the runs in the window."""

from gpubench.trace import span_seconds


def read(record):
    return span_seconds(record, ("expand",))
