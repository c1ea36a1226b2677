"""Entry: the global-mode segmented module on one card.

``opengpc_tpu_torch.infer.build_sparsematch_global_rows(forest, settings)``'s
``forward`` on (B, H, W) uint8 batches already on the card.  The port runs
a batch pair by pair: for each pair one key-kernel launch for both images,
one whole-image (key, pos) sort that finds the codes unique in the pair,
the disparity and vertical-tolerance filter, and a segmented sort that
packs the supports; the pairs' outputs are stacked.  The ((xs, ys, ds)
(B, R, C), counts (B, R)) buffers stay on the card.
"""

from __future__ import annotations

from gpcbench.entries.masked import Masked
from gpcbench.port import load_kernels, settings  # noqa: F401

KEY_OP = "fused_key_image"


class GlobalRows(Masked):
    """The masked entry's calls (``prepare``) and consumer (``counts``)
    over the global-rows module."""

    def __init__(self, ctx):
        from opengpc_tpu_torch.forest import load_forest
        from opengpc_tpu_torch.infer import build_sparsematch_global_rows
        self.cfg, self.batch = ctx.config, ctx.traffic["batch"]
        self.module = build_sparsematch_global_rows(
            load_forest(ctx.config["forest_path"]), settings(ctx.config),
            device=ctx.device)

    def key_launch(self):
        """[(pairs, rows read, rows written, first row, first pair of the
        batch)] of the call's key launches: one a pair."""
        h = self.cfg["height"]
        return [(1, h, h, 0, p) for p in range(self.batch)]

    @staticmethod
    def gather(out):
        """The call's whole ((xs, ys, ds), counts) on the host."""
        (xs, ys, ds), counts = out
        return (tuple(t.cpu().numpy() for t in (xs, ys, ds)),
                counts.cpu().numpy())


def build(ctx):
    return GlobalRows(ctx)
