"""Row-sharded pyramid matching: one frame over a process group, and a
batch of frames over a 2-D grid (``opengpc_tpu.parallel``'s
``build_sharded_frame_pyramid`` and ``build_batched_sharded_frame_pyramid``).

Every rank owns the same level-0 row range at every level: rank r of a
frame group of n holds level-l rows [r * sh_l, (r + 1) * sh_l), sh_l =
sh / 2^l, which scale back to its level-0 rows.  At each level the rank
swaps PAD halo rows with its neighbours, makes the keys of all its frame
slabs with one slab-mode launch of the key kernel (y0 = r * sh_l, h_l = n
* sh_l), runs the row-form matcher on them folded into one row sort and
turns the rows into packed finest-wins dedup keys; ``downscale2`` of its
slab gives the next level's (2x2 means never cross a slab boundary, the
slab heights being even).  The dedup groups by level-0 pixel, so it is
rank-local: one ``_dedup_unpack`` of the rank's keys (a (b, K) row sort),
and one ``all_reduce(SUM)`` of the per-level counts over the frame group.
The buffers keep the JAX package's per-rank block order.

Requires ``H % (n * 2^(L-1)) == 0`` and the coarsest slab >= PAD rows;
``_rows_ok`` of the whole frame and dedup keys below 2^31.
"""

from __future__ import annotations

import torch

from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.infer import _as_mask, _rows_ok
from opengpc_tpu_torch.match import match_epipolar_rows
from opengpc_tpu_torch.ops.fused import PAD
from opengpc_tpu_torch.parallel.frame import (_check_batch, _grid_1d,
                                              _RowSharded, _slab_keys)
from opengpc_tpu_torch.parallel.groups import (Grid, _split_rows,
                                               neighbour_halos, split_batch,
                                               split_frame)
from opengpc_tpu_torch.pyramid import (_SENT, _dedup_unpack, _level_keys,
                                       _pack_params, downscale2)


def _level_dedup_keys(mod, key, level: int, y0: int, w0: int):
    """A level's (b, sh_l * W_l) packed dedup keys from the rank's (b,
    sh_l, 2W_l) slab keys: the row-form matcher on the folded rows, each
    support keyed by its level-0 pixel."""
    b, shl, w2 = key.shape
    wl = w2 // 2
    s, dev = mod.settings, key.device
    (xs, ds), counts = match_epipolar_rows(
        None, None, None, None, s.disp_high, key=key.reshape(b * shl, w2),
        num_tests=mod.mask.num_tests)
    xs, ds = xs.reshape(b, shl, wl), ds.reshape(b, shl, wl)
    scale = 1 << level
    yy = ((y0 + torch.arange(shl, dtype=torch.int32, device=dev))
          * scale)[None, :, None]
    valid = (torch.arange(wl, dtype=torch.int32, device=dev)[None, None, :]
             < counts.reshape(b, shl)[:, :, None])
    pix = yy * w0 + xs * scale
    return _level_keys(valid, pix, level, ds + s.disp_high, mod.mult,
                       mod.nbd).reshape(b, shl * wl)


class _ShardedPyramid(_RowSharded):
    """The stages of both sharded pyramids on a rank's (b, sh0, W0) frame
    slabs."""

    def _setup(self, settings, num_levels: int) -> None:
        if not settings.epipolar_mode:
            raise ValueError("the sharded pyramid is epipolar-only (like "
                             "build_pyramid_sparsematch's fast path)")
        self.num_levels = num_levels
        self.mult, self.nbd = _pack_params(settings, num_levels)

    def _check_shard(self, sh0: int, w0: int, n_rows: int) -> None:
        h_total, lv = n_rows * sh0, self.num_levels
        if not _rows_ok(self.mask, (h_total, w0), self.settings):
            raise ValueError(
                "sharded pyramid needs <=30-test forests and a packable "
                "(x, d) key; see infer._rows_ok")
        if (h_total * w0 * self.mult) << self.nbd >= _SENT:
            raise ValueError(
                f"pyramid dedup keys for {h_total}x{w0} x {lv} levels "
                "exceed int32 packing")
        if sh0 % (1 << (lv - 1)):
            raise ValueError(
                f"image height {h_total} must divide by the group size x "
                f"2^(levels-1) = {n_rows << (lv - 1)} (pad the pair; the "
                "result then matches the single-device pyramid on the "
                "padded pair)")
        if (sh0 >> (lv - 1)) < PAD:
            raise ValueError(
                f"coarsest-level slabs of {sh0 >> (lv - 1)} rows are below "
                f"the {PAD}-row halo; use fewer levels or fewer 'rows' "
                "shards")

    def _keys(self, both, r: int, n_rows: int, halos):
        """Every level's dedup keys of one rank: ``both`` its (2, b, sh0,
        W0) rows, ``halos(level, both_l)`` the level's (top, bottom)."""
        w0 = both.shape[-1]
        keys = []
        for level in range(self.num_levels):
            shl = both.shape[-2]
            key = _slab_keys(self, both, *halos(level, both), r * shl,
                             n_rows * shl)
            keys.append(_level_dedup_keys(self, key, level, r * shl, w0))
            if level + 1 < self.num_levels:
                both = downscale2(both)
        return torch.cat(keys, dim=1)

    def _dedup(self, keys, w0: int):
        return _dedup_unpack(keys, self.mult, self.nbd, w0,
                             self.settings.disp_high, self.num_levels)

    def _forward(self, l_slabs, r_slabs):
        (_, r), (_, nr) = self._cell()
        sh0, w0 = l_slabs.shape[-2:]
        self._check_shard(sh0, w0, nr)
        keys = self._keys(torch.stack([l_slabs, r_slabs]), r, nr,
                          lambda level, both: self._halos(both))
        out = self._dedup(keys, w0)
        counts = out[4]
        if self.rows_group is not None:
            torch.distributed.all_reduce(counts, group=self.rows_group)
        return out[:4] + (counts,)

    def _frame_group(self, lb, rb, n_rows: int):
        """The outputs of the n_rows ranks of one frame group, run in this
        process: each level's halos cut from the neighbour ranks' slabs of
        that level, the counts summed."""
        sh0, w0 = lb.shape[-2:]
        blocks = [torch.stack(p) for p in zip(_split_rows(lb, n_rows),
                                              _split_rows(rb, n_rows))]
        self._check_shard(sh0 // n_rows, w0, n_rows)
        levels = [blocks]
        for _ in range(self.num_levels - 1):
            levels.append([downscale2(b) for b in levels[-1]])
        outs = [self._dedup(self._keys(
            blocks[i], i, n_rows,
            lambda level, both, i=i: neighbour_halos(levels[level], i)),
            w0) for i in range(n_rows)]
        counts = torch.stack([o[4] for o in outs]).sum(dim=0,
                                                       dtype=torch.int32)
        return [o[:4] + (counts,) for o in outs]


class ShardedFramePyramid(_ShardedPyramid):
    """One rank's part of the row-sharded single-frame pyramid:
    ``forward(l_slab, r_slab)`` takes the rank's (sh, W) rows and returns
    its (xs, ys, ds, levels) blocks and the frame's per-level counts (the
    same on every rank)."""

    def __init__(self, mask, settings, device, group, num_levels):
        super().__init__(mask, settings, device)
        self._setup(settings, num_levels)
        self._place(_grid_1d(group, "rows"))

    def _specs(self, out):
        return [(None, 0)] * 4 + [(None, None)]

    def shard(self, left, right):
        split_frame(left, 1)
        return super().shard(left, right)

    def forward(self, l_slab, r_slab):
        self._check_slabs(l_slab, r_slab)
        return tuple(t[0] for t in self._forward(l_slab[None],
                                                 r_slab[None]))

    def _in_one_process(self, left, right, n: int):
        split_frame(left, n)
        self._check_slabs(left, right)
        outs = self._frame_group(left[None], right[None], n)
        return self.gather([tuple(t[0] for t in o) for o in outs], 1, n)


def build_sharded_frame_pyramid(forest_or_mask, settings: InferenceSettings,
                                group=None, num_levels: int = 3,
                                device="cuda") -> ShardedFramePyramid:
    """The row-sharded single-frame pyramid of one rank as an
    ``nn.Module`` on ``device``: ``group``'s n ranks (``None``: this
    process alone) split one (H, W) pair's rows at every level (see the
    module docstring).  The whole result is (xs, ys, ds, lv, counts) as
    ``build_pyramid_sparsematch``'s with dedup (decode with
    ``pyramid_supports_to_numpy``), the buffers in per-rank blocks, the
    support set and counts identical.  Needs ``H % (n * 2^(L-1)) == 0``
    and coarsest slabs of at least PAD rows."""
    return ShardedFramePyramid(_as_mask(forest_or_mask), settings,
                               torch.device(device), group, num_levels)


class BatchedShardedFramePyramid(_ShardedPyramid):
    """One rank's part of the 2-D (frames x rows) pyramid:
    ``forward(l_slabs, r_slabs)`` takes the rank's (b, sh, W) rows of its
    frame group's b frames and returns its (b, K) blocks of (xs, ys, ds,
    levels) and its frames' (b, L) counts, the same on every rank of the
    frame group."""

    def __init__(self, mask, settings, device, grid, num_levels):
        super().__init__(mask, settings, device)
        self._setup(settings, num_levels)
        self._place(grid if grid is not None else Grid(1, 1))

    def _specs(self, out):
        return [(0, 1)] * 4 + [(0, None)]

    def shard(self, left, right):
        _check_batch(left)
        return super().shard(left, right)

    def forward(self, l_slabs, r_slabs):
        self._check_slabs(l_slabs, r_slabs, dims=3)
        return self._forward(l_slabs, r_slabs)

    def _in_one_process(self, left, right, n):
        n_data, n_rows = n
        _check_batch(left)
        self._check_slabs(left, right, dims=3)
        outs = []
        for lb, rb in zip(split_batch(left, n_data),
                          split_batch(right, n_data)):
            outs += self._frame_group(lb, rb, n_rows)
        return self.gather(outs, n_data, n_rows)


def build_batched_sharded_frame_pyramid(forest_or_mask,
                                        settings: InferenceSettings,
                                        group=None, num_levels: int = 3,
                                        device="cuda"
                                        ) -> BatchedShardedFramePyramid:
    """(B, H, W) pyramids sharded both ways over a 2-D grid of ranks
    (``make_mesh_2d``; ``group=None``: this process alone) as one rank's
    ``nn.Module`` on ``device``: frames over the frame groups, every
    frame's rows over a frame group's ranks at every level.  A level's
    slabs of all the rank's frames take one slab-mode key launch and one
    folded row sort; the dedup is one (b, K) row sort.  The whole result
    is (xs, ys, ds, lv (B, n_rows * K_local) each, counts (B, L)): frame
    i decodes with ``pyramid_supports_to_numpy(xs[i], ys[i], ds[i], lv[i],
    counts[i])``, the single-device pyramid's support set.  Needs ``B %
    n_data == 0``, ``H % (n_rows * 2^(L-1)) == 0`` and coarsest slabs of
    at least PAD rows."""
    return BatchedShardedFramePyramid(_as_mask(forest_or_mask), settings,
                                      torch.device(device), group, num_levels)
