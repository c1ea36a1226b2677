"""enqueue_ms.per_call.global4k: ``gpcbench.metrics_common.enqueue_ms``."""

from gpcbench.metrics_common import enqueue_ms as read  # noqa: F401
