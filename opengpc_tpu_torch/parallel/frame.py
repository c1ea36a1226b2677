"""Row-sharded frame matching on ``torch.distributed``: one frame, and a
batch of frames over a 2-D grid.

One (H, W) pair's rows are split over the ranks of a process group, the
multi-device form of the reference's row-partitioned ``parFor``.  Each rank
holds rows [rank * sh, (rank + 1) * sh) of both images, swaps PAD = 14 halo
rows with its neighbours, builds both slabs' keys with one slab-mode launch
of the key kernel (``ops.fused.fused_key_image_slab``, box border and
candidate margin in frame rows) and returns its row block of the
whole-frame result.  The four
contracts of ``opengpc_tpu.parallel.build_sharded_frame_sparsematch``:

* ``"masked"`` and ``"rows"``: epipolar rows are independent, so the only
  communication is the halo exchange; each block equals the same rows of
  ``build_sparsematch_masked`` / ``build_sparsematch_rows`` on the whole
  frame.
* ``"masked-compact"``: as masked-compact on the whole frame, with the
  ranks' chunk-overflow flags combined into one flag on every rank
  (``all_reduce(MAX)``).
* ``"global-compact"`` (global mode): global uniqueness spans the frame,
  so this contract is a distributed bucket sort.  Each rank chunk-compacts
  its slab's keys, sends each surviving code to the rank that owns its
  equal-width range of [0, 2^30) with one ``all_to_all_single`` of
  fixed-capacity (key, pos) buckets, and detects unique collisions in its
  own bucket with a local sort: equal codes meet on one rank.  The chunk
  and bucket overflow flags are combined into one flag on every rank; when
  it is set the caller re-runs the full-width global matcher.  The support
  set equals ``build_sparsematch_global_compact``'s; the segments follow
  the bucket order.

``build_batched_sharded_frame_sparsematch`` composes this with the batch
axis over a 2-D grid (``groups.make_mesh_2d``): frame group d holds
frames [d * B/n_data, (d + 1) * B/n_data) and each of its n_rows ranks
the same row block of all of them.  The halos of all the rank's frame
slabs travel in one exchange on its frame group, all its slabs take one
slab-mode key launch (y0 is the same for every frame of a rank) and one
folded row sort; the epipolar contracts only.

Frame-edge shards get zero halos, the zero padding a single-device run
sees outside the frame.  Unlike the single-device modules, the sharded
path sorts the 13 margin rows too (no interior-row slicing): they hold only
sentinels and land in the edge shards.

The collectives are torch's functional ones
(``torch.distributed._functional_collectives``: the halos one
``all_to_all_single`` to the two neighbours, ``groups.exchange_halos``),
so ``torch.export`` keeps them in a program (``opengpc_tpu_torch.aot``).
``group=None`` is one process: zero halos and no collective.  The stages
(slab keys, the epipolar tail, the global send buffers, the global detect
on a received bucket) are functions that the modules glue with
collectives; ``parallel._run_in_one_process`` glues the same stages for
n shards on one device (halos cut from the neighbour slabs, the all-to-all
by slicing), which tests and ``chip_smoke.py`` use to drive n > 1 on one
card.  It is never chosen implicitly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.infer import (_as_mask, _global_rows_ok,
                                     _key_image_slab, _rows_ok)
from opengpc_tpu_torch.match import (SENTINEL_BASE, _global_rows_core,
                                     _sort_with, _strided_chunk_compact,
                                     match_epipolar_masked,
                                     match_epipolar_masked_compact,
                                     match_epipolar_rows,
                                     resolve_global_compact_chunks,
                                     resolve_masked_compact_chunks)
from opengpc_tpu_torch.ops.fused import PAD
from opengpc_tpu_torch.ops.preprocess import require_u8
from opengpc_tpu_torch.parallel.groups import (Grid, _leaves, _Parallel,
                                               _split_rows, any_rank, done,
                                               exchange_halos,
                                               neighbour_halos, split_batch,
                                               split_frame)

CONTRACTS = ("masked", "rows", "masked-compact", "global-compact")


def _grid_1d(group, axis: str) -> Grid:
    """The grid of a 1-D module: the group's ranks along ``axis``
    ("data": a batch, "rows": one frame's rows)."""
    if group is None:
        return Grid(1, 1)
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if axis == "data":
        return Grid(n, 1, group, None, rank, 0)
    return Grid(1, n, group, group, 0, rank)


def _slab_keys(mod, both, top, bottom, y0: int, h_total: int):
    """Stage 1: the (..., sh, 2W) key image of a rank's (2, ..., sh, W)
    left and right rows with their top and bottom halos: every (sh + 28,
    W) slab, left and right, of all frames in one kernel launch."""
    slabs = torch.cat([top, both, bottom], dim=-2)
    return _key_image_slab(slabs[0], slabs[1], mod.mask, mod.settings, y0,
                           h_total)


def _epipolar_tail(mod, key):
    """Stage 2, epipolar contracts: the contract on the (R, 2W) key rows;
    the masked-compact flag is the rank's own."""
    dh, nt = mod.settings.disp_high, mod.mask.num_tests
    if mod.contract == "masked":
        return match_epipolar_masked(key, dh, nt)
    if mod.contract == "rows":
        return match_epipolar_rows(None, None, None, None, dh, key=key,
                                   num_tests=nt)
    return match_epipolar_masked_compact(key, dh, mod.chunk, mod.k,
                                         num_tests=nt)


def _folded_tail(mod, keys):
    """Stage 2 of a rank's (b, sh, 2W) frame slabs: one folded row sort,
    the outputs back to (b, sh, ...) and the flag to (1,)."""
    b, sh = keys.shape[:2]
    out = _epipolar_tail(mod, keys.reshape(b * sh, -1))

    def unfold(t):
        if isinstance(t, tuple):
            return tuple(unfold(x) for x in t)
        return t.reshape(b, sh, *t.shape[1:])

    if mod.contract == "masked-compact":
        return unfold(out[:2]) + (out[2].reshape(1),)
    return unfold(out)


def _global_send(mod, key, rank: int, n: int, h_total: int):
    """Stage 2, global contract: the rank's (n, cap, 2) int32 send buffer,
    row d holding the (key, global pos) pairs that rank d owns, left-packed
    and padded with keys unique to this rank, and the rank's overflow flag
    (a chunk or a bucket over capacity)."""
    sh, w2 = key.shape
    dev = key.device
    chunk, k = resolve_global_compact_chunks(w2, mod.chunk, mod.k)
    rows = torch.arange(sh, dtype=torch.int32, device=dev) + rank * sh
    pos = rows[:, None] * w2 + torch.arange(w2, dtype=torch.int32,
                                            device=dev)[None, :]
    ks, ps, ovf_chunk = _strided_chunk_compact(key, pos, chunk, k,
                                               pos_never=h_total * w2)
    m = ks.shape[0]
    cap = mod.bucket_cap
    if cap is None:
        # hash-uniform codes put ~m/n survivors in a bucket; 2x slack takes
        # real-image skew, the overflow flag the rest
        cap = max(1024, -(-2 * m // (n * 128)) * 128)
    cap = min(cap, m)
    # the pads SENTINEL_BASE + rank * m + j stay int32 and unique per
    # (source rank, slot)
    if n * m >= (1 << 30):
        raise ValueError(f"exchange pads overflow int32: n*m = {n * m} >= "
                         "2^30")
    # a code's owner is its equal-width range of [0, 2^30); sentinels and
    # pads never pair, so they do not travel
    div = -(-SENTINEL_BASE // n)
    bucket = torch.where(ks < SENTINEL_BASE, ks // div, n)
    mine = bucket[None, :] == torch.arange(n, device=dev)[:, None]
    pads = SENTINEL_BASE + rank * m + torch.arange(m, dtype=torch.int32,
                                                   device=dev)
    tk = torch.where(mine, ks[None, :], pads[None, :])
    tp = torch.where(mine, ps[None, :], h_total * w2)
    ovf_bucket = (mine.sum(dim=1) > cap).any()
    sk, sp = _sort_with(tk, tp)
    send = torch.stack([sk[:, :cap], sp[:, :cap]], dim=-1).contiguous()
    return send, ovf_chunk | ovf_bucket


def _global_detect(mod, recv, w: int, h_total: int, sh: int):
    """Stage 3, global contract: unique collisions in the rank's received
    (n, cap, 2) bucket, packed into sh segments: ((xs, ys, ds), counts)."""
    s = mod.settings
    return _global_rows_core(recv[..., 0].reshape(-1),
                             recv[..., 1].reshape(-1), w, 2 * w, h_total,
                             s.disp_high, s.vertical_tolerance, sh, 0)


class _RowSharded(_Parallel):
    """What the row-sharded modules share: the uint8 slab checks and the
    halo exchange on the rank's frame group."""

    def _check_slabs(self, l_slab, r_slab, dims=2) -> None:
        require_u8(l_slab)
        require_u8(r_slab)
        if l_slab.dim() != dims or l_slab.shape != r_slab.shape:
            want = "(sh, W)" if dims == 2 else "(b, sh, W)"
            raise ValueError(
                f"expected matching {want} row slabs, got "
                f"{tuple(l_slab.shape)} and {tuple(r_slab.shape)}")
        dev = self.tests.device
        if l_slab.device != dev or r_slab.device != dev:
            raise ValueError(f"slabs on {l_slab.device}/{r_slab.device}, "
                             f"matcher on {dev}")

    def _halos(self, both):
        (_, r), (_, nr) = self._cell()
        if self.rows_group is None:
            return neighbour_halos([both], 0)
        return exchange_halos(both, self.rows_group, r, nr)


class ShardedFrameSparsematch(_RowSharded):
    """One rank's part of the row-sharded single-frame matcher:
    ``forward(l_slab, r_slab)`` takes the rank's (sh, W) rows of both
    images and returns its row block of the contract's whole-frame
    result."""

    def __init__(self, mask, settings: InferenceSettings, device, group,
                 contract, chunk, k, bucket_cap):
        super().__init__(mask, settings, device)
        if contract not in CONTRACTS:
            raise ValueError(
                f"contract must be 'masked', 'rows', 'masked-compact' or "
                f"'global-compact', got {contract!r}")
        if contract == "global-compact" and settings.epipolar_mode:
            raise ValueError(
                "contract='global-compact' is for global mode "
                "(epipolar_mode=False); use the masked/rows contracts for "
                "epipolar settings")
        if contract != "global-compact" and not settings.epipolar_mode:
            raise ValueError(
                "epipolar sharded-frame contracts need epipolar_mode=True; "
                "global mode rides contract='global-compact' (distributed "
                "bucket sort)")
        if contract == "masked-compact":
            chunk, k = resolve_masked_compact_chunks(chunk, k)
        self._place(_grid_1d(group, "rows"))
        self.contract = contract
        self.chunk, self.k, self.bucket_cap = chunk, k, bucket_cap

    def _specs(self, out):
        flag = [(None, None)] if self.contract.endswith("compact") else []
        return [(None, 0)] * (len(_leaves(out)) - len(flag)) + flag

    def _check_shard(self, sh: int, w: int, n: int) -> None:
        if sh < PAD:
            raise ValueError(
                f"shards of {sh} rows are below the {PAD}-row halo (one "
                f"exchange hop carries at most a full shard); use a smaller "
                f"group for images under {PAD * n} rows")
        shape = (n * sh, w)
        if self.contract == "global-compact":
            if not _global_rows_ok(self.mask, shape, self.settings):
                raise ValueError(
                    "sharded global matching needs <=30-test forests and "
                    "packable (y, x, d) keys; see infer._global_rows_ok")
        elif not _rows_ok(self.mask, shape, self.settings):
            raise ValueError(
                "sharded-frame matching needs <=30-test forests and a "
                "packable (x, d) key; see infer._rows_ok")

    def shard(self, left, right):
        split_frame(left, 1)
        return super().shard(left, right)

    def forward(self, l_slab: torch.Tensor, r_slab: torch.Tensor):
        self._check_slabs(l_slab, r_slab)
        (_, rank), (_, n) = self._cell()
        sh, w = l_slab.shape
        self._check_shard(sh, w, n)
        both = torch.stack([l_slab, r_slab])
        top, bottom = self._halos(both)
        key = _slab_keys(self, both, top, bottom, rank * sh, n * sh)
        if self.contract == "global-compact":
            send, ovf = _global_send(self, key, rank, n, n * sh)
            recv = send
            if self.group is not None:
                recv = done(funcol.all_to_all_single(send, None, None,
                                                     self.group))
            out = _global_detect(self, recv, w, n * sh, sh)
            return out + (any_rank(ovf, self.group),)
        out = _epipolar_tail(self, key)
        if self.contract == "masked-compact":
            return out[:2] + (any_rank(out[2], self.group),)
        return out

    def _in_one_process(self, left, right, n: int):
        pairs = list(zip(split_frame(left, n), split_frame(right, n)))
        self._check_slabs(left, right)
        slabs = [torch.stack(p) for p in pairs]
        sh, w = slabs[0].shape[1:]
        self._check_shard(sh, w, n)
        keys = [_slab_keys(self, s, *neighbour_halos(slabs, i), i * sh,
                           n * sh)
                for i, s in enumerate(slabs)]
        if self.contract == "global-compact":
            sends, flags = zip(*(_global_send(self, key, i, n, n * sh)
                                 for i, key in enumerate(keys)))
            flag = torch.stack(flags).any()
            return self.gather([
                _global_detect(self, torch.stack([s[i] for s in sends]), w,
                               n * sh, sh) + (flag,)
                for i in range(n)], 1, n)
        outs = [_epipolar_tail(self, key) for key in keys]
        if self.contract == "masked-compact":
            flag = torch.stack([o[2] for o in outs]).any()
            outs = [o[:2] + (flag,) for o in outs]
        return self.gather(outs, 1, n)


def build_sharded_frame_sparsematch(forest_or_mask,
                                    settings: InferenceSettings, group=None,
                                    contract: str = "masked", chunk=None,
                                    k=None, bucket_cap=None,
                                    device="cuda") -> ShardedFrameSparsematch:
    """The row-sharded single-frame matcher of one rank as an
    ``nn.Module`` on ``device``.

    ``group`` is the ``torch.distributed`` process group whose ranks share
    the frame (``None``: this process alone); the frame has n = the group's
    size times sh rows.  ``forward(l_slab, r_slab)`` takes this rank's rows
    [rank * sh, (rank + 1) * sh) of both uint8 images and returns its row
    block of the ``contract``'s result (see the module docstring):
    ``"masked"`` (buf, row_counts), ``"rows"`` ((xs, ds), row_counts),
    ``"masked-compact"`` (buf, row_counts, overflow) and
    ``"global-compact"`` ((xs, ys, ds), counts, overflow), the flag the same
    on every rank.  ``chunk``/``k`` are the compact contracts' chunking,
    ``bucket_cap`` the global exchange's per-destination capacity.
    ``shard`` cuts this rank's rows from the whole frame, ``gather`` joins
    the ranks' blocks and ``collect`` gathers the whole result on every
    rank (``run_whole`` does both)."""
    return ShardedFrameSparsematch(_as_mask(forest_or_mask), settings,
                                   torch.device(device), group, contract,
                                   chunk, k, bucket_cap)


class BatchedShardedFrameSparsematch(_RowSharded):
    """One rank's part of the 2-D (frames x rows) matcher:
    ``forward(l_slabs, r_slabs)`` takes the rank's (b, sh, W) rows of its
    frame group's b frames and returns its blocks: (b, sh, ...) leaves and,
    for masked-compact, its frame group's (1,) flag."""

    def __init__(self, mask, settings: InferenceSettings, device, grid,
                 contract, chunk, k):
        super().__init__(mask, settings, device)
        if contract not in CONTRACTS[:3]:
            raise ValueError(
                f"contract must be 'masked', 'rows' or 'masked-compact', "
                f"got {contract!r}")
        if not settings.epipolar_mode:
            raise ValueError("sharded-frame matching is epipolar-only")
        if contract == "masked-compact":
            chunk, k = resolve_masked_compact_chunks(chunk, k)
        self._place(grid if grid is not None else Grid(1, 1))
        self.contract, self.chunk, self.k = contract, chunk, k

    def _specs(self, out):
        flag = [(0, None)] if self.contract == "masked-compact" else []
        return [(0, 1)] * (len(_leaves(out)) - len(flag)) + flag

    def _check_shard(self, sh: int, w: int, n_rows: int) -> None:
        if sh < PAD:
            raise ValueError(
                f"row shards of {sh} rows are below the {PAD}-row halo; "
                f"use fewer 'rows' shards for images under {PAD * n_rows} "
                "rows")
        if not _rows_ok(self.mask, (n_rows * sh, w), self.settings):
            raise ValueError(
                "sharded-frame matching needs <=30-test forests and a "
                "packable (x, d) key; see infer._rows_ok")

    def shard(self, left, right):
        _check_batch(left)
        return super().shard(left, right)

    def forward(self, l_slabs: torch.Tensor, r_slabs: torch.Tensor):
        self._check_slabs(l_slabs, r_slabs, dims=3)
        (_, r), (_, nr) = self._cell()
        sh, w = l_slabs.shape[1:]
        self._check_shard(sh, w, nr)
        both = torch.stack([l_slabs, r_slabs])
        top, bottom = self._halos(both)
        out = _folded_tail(self, _slab_keys(self, both, top, bottom, r * sh,
                                            nr * sh))
        if self.contract == "masked-compact":
            return out[:2] + (any_rank(out[2], self.rows_group).reshape(1),)
        return out

    def _in_one_process(self, left, right, n):
        n_data, n_rows = n
        _check_batch(left)
        self._check_slabs(left, right, dims=3)
        outs = []
        for lb, rb in zip(split_batch(left, n_data),
                          split_batch(right, n_data)):
            slabs = [torch.stack(p) for p in zip(_split_rows(lb, n_rows),
                                                 _split_rows(rb, n_rows))]
            sh, w = slabs[0].shape[-2:]
            self._check_shard(sh, w, n_rows)
            group = [_folded_tail(self, _slab_keys(
                self, s, *neighbour_halos(slabs, i), i * sh, n_rows * sh))
                for i, s in enumerate(slabs)]
            if self.contract == "masked-compact":
                flag = torch.cat([o[2] for o in group]).any().reshape(1)
                group = [o[:2] + (flag,) for o in group]
            outs += group
        return self.gather(outs, n_data, n_rows)


def _check_batch(left):
    if left.dim() != 3:
        raise ValueError(
            "batched sharded-frame matching takes (B, H, W) pairs; use "
            "build_sharded_frame_sparsematch for a single pair")


def build_batched_sharded_frame_sparsematch(forest_or_mask,
                                            settings: InferenceSettings,
                                            group=None,
                                            contract: str = "masked",
                                            chunk=None, k=None,
                                            device="cuda"
                                            ) -> BatchedShardedFrameSparsematch:
    """(B, H, W) pairs sharded both ways over a 2-D grid of ranks
    (``make_mesh_2d``, ``group=None``: this process alone) as one rank's
    ``nn.Module`` on ``device``: frames over the grid's frame groups (no
    collective), every frame's rows over a frame group's ranks (the halo
    exchange).  The whole results, per frame bit-identical to the
    single-device modules:

    * ``"masked"`` (default): (buf (B, H, 2W), row_counts (B, H));
    * ``"rows"``: ((xs, ds) (B, H, W) each, row_counts (B, H));
    * ``"masked-compact"``: (buf (B, H, C), row_counts (B, H), overflow
      (n_data,) bool), one flag a frame group (``all_reduce(MAX)`` over
      its ranks); re-run that group's frames full-width when it is set.

    ``forward`` takes the rank's (B/n_data, H/n_rows, W) block and returns
    its blocks; ``shard``, ``collect`` and ``run_whole`` cut and join."""
    return BatchedShardedFrameSparsematch(_as_mask(forest_or_mask), settings,
                                          torch.device(device), group,
                                          contract, chunk, k)
