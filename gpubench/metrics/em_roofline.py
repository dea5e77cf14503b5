"""em_roofline: the least time of the EM's work on the H100
(gpubench/roofline.py: every live lane of the data once; a run's
"bound_s" of the kernel), over the time
the EM kernels took (torch.profiler's device events named em_kernel)
in the same runs, in %; summed over the runs that ended in the window."""

KERNEL = "em_kernel"


def read(record):
    bound = took = 0.0
    for run in record["runs"]:
        if KERNEL not in run["bound_s"]:
            continue
        t = sum(e - s for name, s, e in record["device"]
                if KERNEL in name and run["start"] <= s <= run["end"])
        if t > 0:
            bound += run["bound_s"][KERNEL]
            took += t
    return 100.0 * bound / took if took > 0 else None
