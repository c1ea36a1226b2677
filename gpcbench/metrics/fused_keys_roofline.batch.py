"""fused_keys_roofline.batch: ``gpcbench.metrics_common.key_roofline``."""

from gpcbench.metrics_common import key_roofline as read  # noqa: F401
