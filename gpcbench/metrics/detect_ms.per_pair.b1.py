"""detect_ms.per_pair.b1: ``gpcbench.spans.detect_ms``."""

from gpcbench.spans import detect_ms as read  # noqa: F401
