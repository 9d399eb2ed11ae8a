"""The largest over the ranks of the transport's exchange time (the
program's CUDA events on the rank's stream, waits for peers included) over
the rank's window, in %."""


def read(world: dict):
    ms = world["exchange_ms"]
    if not ms:
        return None
    return max(100.0 * m / 1e3 / w
               for m, w in zip(ms, world["rank_window_s"]))
