"""fused_keys_global4k_roofline.b1: ``gpcbench.metrics_common.key_roofline``
in the global 4K cell."""

from gpcbench.metrics_common import key_roofline as read  # noqa: F401
