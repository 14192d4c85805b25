"""Device: the share of the traced window's wall time in which no device
operation ran, 100 (1 - busy / wall), busy being the union of the device
operations' time ranges."""


def read(ctx):
    t = ctx["trace"]
    if not t.device_events:
        return None
    return {"value": 100.0 * (1.0 - t.busy_s / t.wall_s), "unit": "%"}
