"""gsort_ms.per_pair.global4k: device ms a pair launched under
``ogpc.gsort``, the global-rows route's whole-frame (key, pos) sort
(``match._global_rows_core``), summed over the ranks."""

from gpcbench.spans import _stage_ms


def read(ctx):
    return _stage_ms(ctx, "ogpc.gsort")
