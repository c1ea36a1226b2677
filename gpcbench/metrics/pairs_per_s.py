"""pairs_per_s: every pair of the window over the whole window, host clock.

A pair counts once its supports reached their consumer, the device total
of row counts; the window runs from the first call's dispatch to the
final synchronise after the last, so the rate is all the work over all
the time."""


def read(ctx):
    w = ctx.window
    return w.pairs / w.seconds
