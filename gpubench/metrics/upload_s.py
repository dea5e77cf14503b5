"""upload_s: seconds a run's uploads to the card take (the program's
"upload" spans, CUDA events; core/distance.py ChunkPipe), the union per
run, mean over the runs in the window."""

from gpubench.trace import span_seconds


def read(record):
    return span_seconds(record, ("upload",))
