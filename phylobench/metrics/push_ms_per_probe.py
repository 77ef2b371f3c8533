"""Models layer: host ms per probe to set every partition's model and
push the stacked models to the device (the benchmark's span around
`set_model` + `push_models`, ending in a synchronize)."""


def read(m):
    span = m.spans.get("push")
    if m.kind != "probe" or not span or not span[1]:
        return None
    return 1e3 * span[0] / span[1]
