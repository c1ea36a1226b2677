"""detect_ms.per_pair.batch: ``gpcbench.spans.detect_ms``."""

from gpcbench.spans import detect_ms as read  # noqa: F401
