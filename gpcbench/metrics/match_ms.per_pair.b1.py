"""match_ms.per_pair.b1: ``gpcbench.metrics_common.match_ms``."""

from gpcbench.metrics_common import match_ms as read  # noqa: F401
