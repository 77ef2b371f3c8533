"""Kernel B1: the probes' least time on the card (max of modelled bytes
over peak bandwidth and f32 operations over the f32 peak, over real
patterns) as a share of the device's busy time over those probes, in %."""


def read(m):
    t = m.trace
    if m.kind != "probe" or t is None or not t["busy_s"]:
        return None
    return 100.0 * t["least_s"] / t["busy_s"]
