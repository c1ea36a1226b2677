"""Entry: the masked epipolar module on one card.

``opengpc_tpu_torch.infer.build_sparsematch_masked(forest, settings)``'s
``forward`` on (B, H, W) uint8 batches already on the card: one key-kernel
launch for both images of the batch, the batch's interior rows folded into
one row sort, pair detection and the masked emit.  The (B, H, 2W) buffer
and (B, H) row counts stay on the card.
"""

from __future__ import annotations

from gpcbench.port import load_kernels, settings  # noqa: F401

KEY_OP = "fused_key_image"


class Masked:
    def __init__(self, ctx):
        from opengpc_tpu_torch.forest import load_forest
        from opengpc_tpu_torch.infer import build_sparsematch_masked
        self.cfg, self.batch = ctx.config, ctx.traffic["batch"]
        self.module = build_sparsematch_masked(
            load_forest(ctx.config["forest_path"]), settings(ctx.config),
            device=ctx.device)

    def prepare(self, lefts, rights):
        """The pool's calls: consecutive (B, H, W) batches of pairs."""
        b = self.batch
        return [(lefts[i:i + b].contiguous(), rights[i:i + b].contiguous())
                for i in range(0, lefts.shape[0] - b + 1, b)]

    def __call__(self, inputs):
        return self.module(*inputs)

    @staticmethod
    def counts(out):
        return out[1]

    def key_launch(self):
        """[(pairs, rows read, rows written, first row, first pair of the
        batch)] of the call's one key launch."""
        h = self.cfg["height"]
        return [(self.batch, h, h, 0, 0)]

    @staticmethod
    def gather(out):
        """The call's whole (buf, counts) on the host."""
        return out[0].cpu().numpy(), out[1].cpu().numpy()


def build(ctx):
    return Masked(ctx)
