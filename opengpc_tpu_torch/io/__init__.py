"""Host file formats: the raw array container."""

from opengpc_tpu_torch.io.raw import read_raw, write_raw

__all__ = ["read_raw", "write_raw"]
