"""Host file formats: the raw array container, PNG images, Middlebury
``.flo`` flow, the binary triplet dataset and the Sintel catalogs."""

from opengpc_tpu_torch.io.flo import read_flo, write_flo
from opengpc_tpu_torch.io.png import (read_gray, read_gray_batch, read_png,
                                      read_rgb, write_png)
from opengpc_tpu_torch.io.raw import read_raw, write_raw
from opengpc_tpu_torch.io.sintel import (SintelFlow, SintelStereo,
                                         decode_stereo_disparity)
from opengpc_tpu_torch.io.triplets import load_triplets, save_triplets

__all__ = ["SintelFlow", "SintelStereo", "decode_stereo_disparity",
           "load_triplets", "read_flo", "read_gray", "read_gray_batch",
           "read_png", "read_raw", "read_rgb", "save_triplets", "write_flo",
           "write_png", "write_raw"]
