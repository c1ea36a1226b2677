"""frame_ms.p95: the 95th percentile, nearest rank, over every call of the
window of the host clock from before ``forward`` to after that call's
synchronise.  Only a cell with one call in flight times calls alone."""

import math


def read(ctx):
    ms = sorted(ctx.window.call_ms)
    if not ms:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
