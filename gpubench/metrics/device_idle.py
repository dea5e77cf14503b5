"""device_idle: the share of the traced window, in %, in which no kernel
and no copy ran on the card (torch.profiler's device events)."""

from gpubench.trace import device_busy_s


def read(record):
    if not record["device"]:
        return None
    lo, hi = record["window"]
    return 100.0 * (1.0 - device_busy_s(record) / (hi - lo))
