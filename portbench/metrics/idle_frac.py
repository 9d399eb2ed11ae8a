"""The share of the traced window in which nothing of the cell's processes
ran on the card (one minus the union of the device operations of every
process, on the profiler's timeline), in %."""


def read(world: dict):
    dv = world["device"]
    if dv is None or dv["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dv["busy_s"] / dv["window_s"])
