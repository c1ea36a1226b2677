"""enqueue_ms.per_call.b1: ``gpcbench.metrics_common.enqueue_ms``."""

from gpcbench.metrics_common import enqueue_ms as read  # noqa: F401
