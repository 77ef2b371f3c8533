"""Instance and chunk tier: device operations (kernels, copies, sets)
per probe in the traced sub-window."""


def read(m):
    t = m.trace
    if m.kind != "probe" or t is None or not t["steps"]:
        return None
    return t["device_ops"] / t["steps"]
