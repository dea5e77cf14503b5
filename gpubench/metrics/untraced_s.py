"""untraced_s: seconds of a run that no span of the program covers (the
writer, the bootstrap maps, the distance transform, Python): its wall
time less the union of all its spans, mean over the runs in the
window."""

from gpubench.trace import clip, length, mean_over_runs


def read(record):
    def untraced(run):
        spans = [iv for ivs in run["spans"].values() for iv in ivs]
        return run["wall_s"] - length(clip(spans, run["start"], run["end"]))

    return mean_over_runs(record, untraced)
