"""idle_share.b1: ``gpcbench.metrics_common.idle_share``."""

from gpcbench.metrics_common import idle_share as read  # noqa: F401
