"""Row-sharded single-frame matching on ``torch.distributed``.

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

Frame-edge shards get zero halos, the zero padding a single-device run
sees outside the frame.  Unlike the single-device modules, the sharded
path sorts the 13 margin rows too (no interior-row slicing): they hold only
sentinels and land in the edge shards.

``group=None`` is one process: zero halos and no collective.  The stages
(slab keys, the epipolar tail, the global send buffers, the global detect
on a received bucket) are functions that the module glues with
collectives; ``_run_in_one_process`` glues the same stages for n shards on
one device (halos cut from the neighbour slabs, the all-to-all by
slicing), which tests and ``chip_smoke.py`` use to drive n > 1 on one
card.  It is never chosen implicitly.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from opengpc_tpu_torch.config import InferenceSettings
from opengpc_tpu_torch.infer import (_Matcher, _as_mask, _global_rows_ok,
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

CONTRACTS = ("masked", "rows", "masked-compact", "global-compact")


def init_distributed(backend=None, **kwargs) -> int:
    """Join the process group that ``torchrun`` describes (``env://``:
    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) and return the world size.
    ``backend`` defaults to NCCL when CUDA is present, one GPU per rank
    (LOCAL_RANK), and to gloo otherwise.  A process already in a group
    keeps it."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, **kwargs)
    return dist.get_world_size()


def split_frame(img: torch.Tensor, n: int):
    """The n row slabs [i * sh, (i + 1) * sh) of an (H, W) image, as views."""
    if img.dim() != 2:
        raise ValueError(
            "sharded-frame matching takes ONE (H, W) pair; got shape "
            f"{tuple(img.shape)}")
    if img.shape[0] % n:
        raise ValueError(
            f"image height {img.shape[0]} must divide by the group size {n} "
            "(pad the pair or pick a divisor group)")
    return list(torch.split(img, img.shape[0] // n))


def gather_blocks(outs):
    """The whole-frame result from the ranks' outputs in rank order: row
    blocks concatenated, the overflow flag (the same on every rank) taken
    once."""
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(gather_blocks([o[i] for o in outs])
                     for i in range(len(first)))
    return first if first.dim() == 0 else torch.cat(outs)


def _slab_keys(mod, both, top, bottom, y0: int, h_total: int):
    """Stage 1: the (sh, 2W) key image of a rank's (2, sh, W) left and
    right rows with their (2, PAD, W) top and bottom halos: both (sh +
    28, W) slabs of one contiguous tensor, one kernel launch."""
    slabs = torch.cat([top, both, bottom], dim=1)
    return _key_image_slab(slabs[0], slabs[1], mod.mask, mod.settings, y0,
                           h_total)


def _epipolar_tail(mod, key):
    """Stage 2, epipolar contracts: the rank's rows of the contract; the
    masked-compact flag is the rank's own."""
    dh, nt = mod.settings.disp_high, mod.mask.num_tests
    if mod.contract == "masked":
        return match_epipolar_masked(key, dh, nt)
    if mod.contract == "rows":
        return match_epipolar_rows(None, None, None, None, dh, key=key,
                                   num_tests=nt)
    return match_epipolar_masked_compact(key, dh, mod.chunk, mod.k,
                                         num_tests=nt)


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


class ShardedFrameSparsematch(_Matcher):
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
        self.group, self.contract = group, contract
        self.chunk, self.k, self.bucket_cap = chunk, k, bucket_cap

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

    def _check_slabs(self, l_slab, r_slab) -> None:
        require_u8(l_slab)
        require_u8(r_slab)
        if l_slab.dim() != 2 or l_slab.shape != r_slab.shape:
            raise ValueError(
                f"expected matching (sh, W) row slabs, got "
                f"{tuple(l_slab.shape)} and {tuple(r_slab.shape)}")
        dev = self.tests.device
        if l_slab.device != dev or r_slab.device != dev:
            raise ValueError(f"slabs on {l_slab.device}/{r_slab.device}, "
                             f"matcher on {dev}")

    def _rank_n(self):
        if self.group is None:
            return 0, 1
        return dist.get_rank(self.group), dist.get_world_size(self.group)

    def _halos(self, both, rank: int, n: int):
        """(top, bottom) (2, PAD, W) halos from the neighbour ranks, zeros
        at the frame's edges."""
        top = torch.zeros_like(both[:, :PAD])
        bottom = torch.zeros_like(both[:, :PAD])
        ops = []
        for nb, send, recv in ((rank - 1, both[:, :PAD], top),
                               (rank + 1, both[:, -PAD:], bottom)):
            if 0 <= nb < n:
                peer = dist.get_global_rank(self.group, nb)
                ops += [dist.P2POp(dist.isend, send.contiguous(), peer,
                                   self.group),
                        dist.P2POp(dist.irecv, recv, peer, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return top, bottom

    def _any_rank(self, flag):
        if self.group is None:
            return flag
        t = flag.to(torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t[0] > 0

    def forward(self, l_slab: torch.Tensor, r_slab: torch.Tensor):
        self._check_slabs(l_slab, r_slab)
        rank, n = self._rank_n()
        sh, w = l_slab.shape
        self._check_shard(sh, w, n)
        both = torch.stack([l_slab, r_slab])
        top, bottom = self._halos(both, rank, n)
        key = _slab_keys(self, both, top, bottom, rank * sh, n * sh)
        if self.contract == "global-compact":
            send, ovf = _global_send(self, key, rank, n, n * sh)
            recv = send
            if self.group is not None:
                recv = torch.empty_like(send)
                dist.all_to_all_single(recv, send, group=self.group)
            out = _global_detect(self, recv, w, n * sh, sh)
            return out + (self._any_rank(ovf),)
        out = _epipolar_tail(self, key)
        if self.contract == "masked-compact":
            return out[:2] + (self._any_rank(out[2]),)
        return out


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
    :func:`split_frame` and :func:`gather_blocks` cut a frame into slabs
    and join the blocks."""
    return ShardedFrameSparsematch(_as_mask(forest_or_mask), settings,
                                   torch.device(device), group, contract,
                                   chunk, k, bucket_cap)


def _run_in_one_process(mod: ShardedFrameSparsematch, left, right, n: int):
    """The whole-frame result of ``mod``'s contract for n shards of one
    (H, W) pair, every shard's stages run in this process on one device:
    halos are cut from the neighbour slabs, the all-to-all is done by
    slicing and the overflow flags are combined with ``any``.  It equals
    ``gather_blocks`` of n ranks' outputs; tests and ``chip_smoke.py`` use
    it to drive n > 1 on one card."""
    pairs = list(zip(split_frame(left, n), split_frame(right, n)))
    mod._check_slabs(left, right)
    slabs = [torch.stack(p) for p in pairs]
    sh, w = slabs[0].shape[1:]
    mod._check_shard(sh, w, n)
    zeros = torch.zeros_like(slabs[0][:, :PAD])
    keys = [_slab_keys(mod, s, slabs[i - 1][:, -PAD:] if i else zeros,
                       slabs[i + 1][:, :PAD] if i < n - 1 else zeros,
                       i * sh, n * sh)
            for i, s in enumerate(slabs)]
    if mod.contract == "global-compact":
        sends, flags = zip(*(_global_send(mod, key, i, n, n * sh)
                             for i, key in enumerate(keys)))
        flag = torch.stack(flags).any()
        return gather_blocks([
            _global_detect(mod, torch.stack([s[i] for s in sends]), w,
                           n * sh, sh) + (flag,)
            for i in range(n)])
    outs = [_epipolar_tail(mod, key) for key in keys]
    if mod.contract == "masked-compact":
        flag = torch.stack([o[2] for o in outs]).any()
        outs = [o[:2] + (flag,) for o in outs]
    return gather_blocks(outs)
