"""Host file formats: the raw array container and PNG images."""

from opengpc_tpu_torch.io.png import (read_gray, read_gray_batch, read_png,
                                      read_rgb, write_png)
from opengpc_tpu_torch.io.raw import read_raw, write_raw

__all__ = ["read_gray", "read_gray_batch", "read_png", "read_raw", "read_rgb",
           "write_png", "write_raw"]
