"""gpack_ms.per_pair.global4k: device ms a pair launched under
``ogpc.gpack``, the global-rows route's (y, x, d) pack, segmented sort,
unpack and counts (``match._global_rows_core``), summed over the ranks."""

from gpcbench.spans import _stage_ms


def read(ctx):
    return _stage_ms(ctx, "ogpc.gpack")
