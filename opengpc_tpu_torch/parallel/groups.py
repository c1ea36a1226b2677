"""Process groups, the grid of ranks and the glue every parallel module
shares: cutting inputs into rank blocks, the halo exchange, and joining
the ranks' outputs back into the whole result.

The counterparts of the JAX package's meshes:

* 1-D (``make_mesh``): one group over the world.  The batched builders
  split the batch axis over it, the row-sharded frame and pyramid one
  frame's rows.
* 2-D (``make_mesh_2d``): ``n_data`` frame groups of ``n_rows`` ranks
  each.  Ranks fill row-major, as JAX's devices do, so
  consecutive ranks form one frame group and rank = d * n_rows + r.

Every module places its rank at a cell (d, r) of an (n_data, n_rows)
grid: a 1-D batched module at (rank, 0) of (N, 1), a row-sharded one at
(0, rank) of (1, N).  Its inputs are the block of frames d and rows r
(``_Parallel.shard``), and ``_Parallel.gather`` joins the ranks' outputs
in rank order: rows along each leaf's row axis within a frame group, frame
groups along the batch axis, and a leaf that a collective made the same on
every rank of a frame group (an overflow flag, pyramid counts) taken once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from opengpc_tpu_torch.infer import _Matcher
from opengpc_tpu_torch.ops.fused import PAD


def init_distributed(backend=None, **kwargs) -> int:
    """Join the process group that ``torchrun`` describes (``env://``:
    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) and return the world size.
    ``backend`` defaults to NCCL when CUDA is present, one GPU a rank
    (``cuda:LOCAL_RANK``), and to gloo otherwise.  NCCL fails loud when it
    is missing or LOCAL_RANK names no visible GPU; it never gives way to
    gloo.  A process already in a group keeps it."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            if not dist.is_nccl_available():
                raise RuntimeError("NCCL is not available in this torch "
                                   "build; run with --device cpu for gloo")
            local = int(os.environ.get("LOCAL_RANK", 0))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} names no GPU: "
                    f"{torch.cuda.device_count()} visible")
            torch.cuda.set_device(local)
        dist.init_process_group(backend, **kwargs)
    return dist.get_world_size()


def join_launch(device):
    """Join the group of a ``torchrun`` launch for matching on
    ``device``: NCCL on ``cuda:LOCAL_RANK`` for a CUDA device, gloo for
    the CPU.  Returns (rank, the rank's device)."""
    cpu = torch.device(device).type == "cpu"
    init_distributed("gloo" if cpu else "nccl")
    return dist.get_rank(), (torch.device("cpu") if cpu else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", 0))))


def in_launch() -> bool:
    """Whether this process is a rank of a ``torchrun`` launch."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def make_mesh():
    """The 1-D group over every rank of the world, the counterpart of the
    JAX package's ``make_mesh``; None in a process that joined no
    group."""
    return dist.group.WORLD if dist.is_initialized() else None


@dataclasses.dataclass(frozen=True)
class Grid:
    """An (n_data, n_rows) grid of ranks: ``group`` spans the grid,
    ``rows_group`` is this rank's frame group, at cell (data_rank,
    row_rank)."""

    n_data: int
    n_rows: int
    group: Optional[object] = None
    rows_group: Optional[object] = None
    data_rank: int = 0
    row_rank: int = 0


def make_mesh_2d(n_data: int, n_rows: int) -> Grid:
    """The 2-D ("data", "rows") grid over the world's ranks, the
    counterpart of the JAX package's ``make_mesh_2d``: n_data frame groups
    of n_rows consecutive ranks.  Every rank makes every frame group, in the same
    order, as ``dist.new_group`` requires; a world of one makes none."""
    if not dist.is_initialized():
        if n_data * n_rows != 1:
            raise ValueError(
                f"a {n_data}x{n_rows} grid needs {n_data * n_rows} ranks; "
                "this process joined no group (init_distributed)")
        return Grid(1, 1)
    world = dist.get_world_size()
    if world != n_data * n_rows:
        raise ValueError(f"need {n_data * n_rows} ranks for a {n_data}x"
                         f"{n_rows} grid, have {world}")
    rank = dist.get_rank()
    groups = ([dist.new_group(list(range(d * n_rows, (d + 1) * n_rows)))
               for d in range(n_data)] if world > 1 else [dist.group.WORLD])
    return Grid(n_data, n_rows, dist.group.WORLD, groups[rank // n_rows],
                rank // n_rows, rank % n_rows)


def split_frame(img: torch.Tensor, n: int):
    """The n row slabs [i * sh, (i + 1) * sh) of an (H, W) image, as views."""
    if img.dim() != 2:
        raise ValueError(
            "sharded-frame matching takes ONE (H, W) pair; got shape "
            f"{tuple(img.shape)}")
    return _split_rows(img, n)


def _split_rows(img, n: int):
    if img.shape[-2] % n:
        raise ValueError(
            f"image height {img.shape[-2]} must divide by the group size {n} "
            "(pad the pair or pick a divisor group)")
    return list(torch.split(img, img.shape[-2] // n, dim=-2))


def split_batch(frames: torch.Tensor, n: int):
    """The n contiguous blocks of B/n pairs of a (B, H, W) stack: rank i's
    block is [i * B/n, (i + 1) * B/n), so the ranks' outputs in rank order
    are the (B, ...) layout."""
    if frames.dim() != 3:
        raise ValueError(f"batched matching takes (B, H, W) pairs; got shape "
                         f"{tuple(frames.shape)}")
    if frames.shape[0] % n:
        raise ValueError(
            f"batch {frames.shape[0]} must divide by the group size {n}")
    return list(torch.split(frames, frames.shape[0] // n))


# the gather along dim 0: all_gather_single where torch has it (it
# replaces the deprecated all_gather_tensor), else all_gather_tensor
_all_gather = (getattr(funcol, "all_gather_single", None)
               or funcol.all_gather_tensor)


def done(t):
    """A functional collective's result, waited for: eager calls return an
    ``AsyncCollectiveTensor``, traced ones (``torch.export``) a tensor
    whose wait is already in the graph."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def exchange_halos(x, group, rank: int, n: int):
    """(top, bottom) PAD-row halos of the (..., sh, W) rows ``x`` that
    rank ``rank`` of an ``n``-rank row group holds: the last rows of the
    rank above and the first of the rank below, zeros at the frame's
    edges, all leading slabs in one exchange.  The exchange is one
    functional ``all_to_all_single`` whose split sizes are nonzero only
    for ranks ``rank - 1`` and ``rank + 1``, so that ``torch.export``
    keeps it in a program."""
    top = torch.zeros_like(x[..., :PAD, :])
    bottom = torch.zeros_like(top)
    nbrs = [nb for nb in (rank - 1, rank + 1) if 0 <= nb < n]
    if not nbrs:
        return top, bottom
    size = top.numel()
    splits = [size if i in nbrs else 0 for i in range(n)]
    send = torch.cat([(x[..., :PAD, :] if nb < rank else x[..., -PAD:, :])
                      .reshape(-1) for nb in nbrs])
    recv = done(funcol.all_to_all_single(send, splits, splits, group))
    # received in source rank order: the rank above's last rows first
    parts = iter(torch.split(recv, size))
    if rank > 0:
        top = next(parts).view(top.shape)
    if rank < n - 1:
        bottom = next(parts).view(bottom.shape)
    return top, bottom


def neighbour_halos(blocks, i: int):
    """(top, bottom) halos of block i of a frame's row blocks in one
    process: cut from the neighbour blocks, zeros at the frame's edges."""
    zeros = torch.zeros_like(blocks[i][..., :PAD, :])
    return (blocks[i - 1][..., -PAD:, :] if i else zeros,
            blocks[i + 1][..., :PAD, :] if i < len(blocks) - 1 else zeros)


def any_rank(flag, group):
    """An overflow flag set on any rank of ``group``, on every rank."""
    if group is None:
        return flag
    t = done(funcol.all_reduce(flag.to(torch.int32).reshape(1), "max",
                               group))
    return t[0] > 0


def _leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _rebuild(like, leaves):
    """``leaves`` in the nesting of ``like``."""
    it = iter(leaves)

    def build(o):
        if isinstance(o, tuple):
            return tuple(build(x) for x in o)
        return next(it)

    return build(like)


def all_gather_outputs(out, group):
    """Every rank's ``out`` (a nested tuple of tensors of the same shapes
    on every rank) on every rank, in rank order: one functional
    all-gather a leaf into one flat buffer, each rank's part a
    view of it.  Bool leaves travel as uint8, which every backend
    carries."""
    if group is None:
        return [out]
    n = dist.get_world_size(group)
    gathered = []
    for leaf in _leaves(out):
        t = leaf.reshape(-1)
        t = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        flat = done(_all_gather(t, 0, group))
        gathered.append(flat.to(leaf.dtype).view((n,) + leaf.shape))
    return [_rebuild(out, [g[i] for g in gathered]) for i in range(n)]


class _Parallel(_Matcher):
    """The cell (d, r) of an (n_data, n_rows) grid of ranks that a module
    runs on, and the glue of its inputs and outputs.  Subclasses set
    ``_specs(out)``: one (data_dim, rows_dim) a leaf, the axes its blocks
    join along (None: the same on every rank of the axis)."""

    def _place(self, grid: Grid) -> None:
        self.grid = grid
        self.group, self.rows_group = grid.group, grid.rows_group

    def _cell(self):
        """((d, r), (n_data, n_rows)) of this rank."""
        g = self.grid
        return (g.data_rank, g.row_rank), (g.n_data, g.n_rows)

    def shard(self, left, right):
        """This rank's block of whole (H, W) or (B, H, W) inputs."""
        (d, r), (nd, nr) = self._cell()
        return tuple(_block(x, nd, nr, d, r) for x in (left, right))

    def gather(self, outs, n_data=None, n_rows=None):
        """The whole result from the outputs of an (n_data, n_rows) grid's
        ranks in rank order (default: this module's grid)."""
        if n_data is None:
            _, (n_data, n_rows) = self._cell()
        specs = self._specs(outs[0])
        joined = []
        for i, (dd, rd) in enumerate(specs):
            leaf = [_leaves(o)[i] for o in outs]
            per_data = [_cat(leaf[d * n_rows:(d + 1) * n_rows], rd)
                        for d in range(n_data)]
            joined.append(_cat(per_data, dd))
        return _rebuild(outs[0], joined)

    def collect(self, out):
        """The whole result on every rank from this rank's output: one
        all-gather a leaf over the grid's group."""
        return self.gather(all_gather_outputs(out, self.group))

    def run_whole(self, left, right):
        """The whole result of whole inputs: this rank's block through
        the module, the blocks gathered (the group's ranks all call it)."""
        return self.collect(self(*self.shard(left, right)))


def _cat(parts, dim):
    """Blocks joined along ``dim``; a single block, or a leaf the same on
    every rank (``dim`` None), is taken as it is."""
    if dim is None or len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim)


def _block(x, n_data, n_rows, d, r):
    if x.dim() == 3:
        x = split_batch(x, n_data)[d]
    elif n_data > 1:
        raise ValueError(f"a grid of {n_data} frame groups takes (B, H, W) "
                         f"pairs; got shape {tuple(x.shape)}")
    return _split_rows(x, n_rows)[r] if n_rows > 1 else x
