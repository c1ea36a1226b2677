"""launches.per_call.global4k: ``gpcbench.spans.launches_per_call``."""

from gpcbench.spans import launches_per_call as read  # noqa: F401
