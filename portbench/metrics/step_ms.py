"""The window's time over the steps it completed, in ms (host clock): all
the time and all the steps of the window."""


def read(world: dict):
    return 1e3 * world["window_s"] / world["n_steps"]
