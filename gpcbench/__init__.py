"""The benchmark of the PyTorch and CUDA port, ``opengpc_tpu_torch``: see
``gpcbench.run``."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "opengpc_tpu")


def forbidden_modules():
    """The top-level names of loaded modules that the benchmark may not
    load, compared whole (``opengpc_tpu_torch`` is not ``opengpc_tpu``)."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))
