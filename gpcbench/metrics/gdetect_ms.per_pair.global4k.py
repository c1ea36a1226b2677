"""gdetect_ms.per_pair.global4k: device ms a pair launched under
``ogpc.gdetect``, the global-rows route's collision windows, cross-image
check and disparity and vertical-tolerance filter
(``match._global_rows_core``), summed over the ranks."""

from gpcbench.spans import _stage_ms


def read(ctx):
    return _stage_ms(ctx, "ogpc.gdetect")
