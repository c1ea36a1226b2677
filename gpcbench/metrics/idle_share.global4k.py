"""idle_share.global4k: ``gpcbench.metrics_common.idle_share``."""

from gpcbench.metrics_common import idle_share as read  # noqa: F401
