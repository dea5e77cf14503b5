"""indep_roofline: the least time of the indep kernel's work on the H100
(gpubench/roofline_indep.py: the contraction over the data once a run; a
run's "bound_s" of the kernel), over the time the kernels named indep_
took (torch.profiler's device events: the tensor-core pass and the
chunks' sum) in the same runs, in %; summed over the runs that ended in
the window."""

KERNEL = "indep_"


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
