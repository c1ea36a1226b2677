"""fold_ms.per_pair.batch: ``gpcbench.spans.fold_ms``."""

from gpcbench.spans import fold_ms as read  # noqa: F401
