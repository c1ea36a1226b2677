"""Entry: the row-sharded batched frame on the ranks of a 2-D grid.

``opengpc_tpu_torch.parallel.frame.build_batched_sharded_frame_sparsematch``
(``contract="masked"``, grid ``make_mesh_2d(n_data, n_rows)``) on each
rank's (B / n_data, H / n_rows, W) row slabs of every pair, already on its
card: one halo exchange with its neighbours (``groups.exchange_halos``,
one ``all_to_all_single`` over NCCL), one slab-mode key launch for all its
slabs, one folded row sort, detection and emit.  Each rank's row blocks
stay on its card; after the window the harness joins them with its own
all-gather.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gpcbench.port import load_kernels, settings  # noqa: F401

KEY_OP = "fused_key_image"


class ShardedRows:
    def __init__(self, ctx):
        from opengpc_tpu_torch.forest import load_forest
        from opengpc_tpu_torch.parallel.frame import \
            build_batched_sharded_frame_sparsematch
        from opengpc_tpu_torch.parallel.groups import make_mesh_2d
        self.cfg, self.batch = ctx.config, ctx.traffic["batch"]
        self.n_data, self.n_rows = ctx.traffic["grid"]
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        grid = make_mesh_2d(self.n_data, self.n_rows)
        self.d, self.r = grid.data_rank, grid.row_rank
        self.module = build_batched_sharded_frame_sparsematch(
            load_forest(ctx.config["forest_path"]), settings(ctx.config),
            group=grid, contract="masked", device=ctx.device)
        self.sh = ctx.config["height"] // self.n_rows
        self.bd = self.batch // self.n_data

    def prepare(self, lefts, rights):
        """Each call's block of this rank: frames of its data group, rows
        of its row shard, contiguous."""
        out = []
        f0, y0 = self.d * self.bd, self.r * self.sh
        for i in range(0, lefts.shape[0] - self.batch + 1, self.batch):
            blk = slice(i + f0, i + f0 + self.bd)
            out.append(tuple(x[blk, y0:y0 + self.sh].contiguous()
                             for x in (lefts, rights)))
        return out

    def __call__(self, inputs):
        return self.module(*inputs)

    @staticmethod
    def counts(out):
        return out[1]

    def key_launch(self):
        from opengpc_tpu_torch.ops.fused import PAD
        return [(self.bd, self.sh + 2 * PAD, self.sh, self.r * self.sh,
                 self.d * self.bd)]

    def gather(self, out):
        """Every rank's blocks joined into the call's whole (buf, counts)
        on rank 0's host (None elsewhere); all ranks call it."""
        joined = []
        for t in out[:2]:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t)
            if self.rank == 0:
                rows = [torch.cat(parts[d * self.n_rows:(d + 1) * self.n_rows],
                                  dim=1) for d in range(self.n_data)]
                joined.append(torch.cat(rows, dim=0).cpu().numpy())
        return tuple(joined) if self.rank == 0 else None


def build(ctx):
    return ShardedRows(ctx)
