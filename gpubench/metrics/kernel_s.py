"""kernel_s: seconds a run's statistics kernels take (the program's
"kernel" spans, CUDA events; ops/em.py and csrc/em.cu), the union per
run, mean over the runs in the window."""

from gpubench.trace import span_seconds


def read(record):
    return span_seconds(record, ("kernel",))
