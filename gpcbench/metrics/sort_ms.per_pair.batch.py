"""sort_ms.per_pair.batch: ``gpcbench.spans.sort_ms``."""

from gpcbench.spans import sort_ms as read  # noqa: F401
