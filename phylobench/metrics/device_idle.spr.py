"""Device: the share of the traced SPR sub-window with nothing running
on the device, in %."""


def read(m):
    t = m.trace
    if m.kind != "spr" or t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
