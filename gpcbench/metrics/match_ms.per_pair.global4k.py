"""match_ms.per_pair.global4k: ``gpcbench.metrics_common.match_ms``."""

from gpcbench.metrics_common import match_ms as read  # noqa: F401
