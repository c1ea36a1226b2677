"""emit_ms.per_pair.b1: ``gpcbench.spans.emit_ms``."""

from gpcbench.spans import emit_ms as read  # noqa: F401
