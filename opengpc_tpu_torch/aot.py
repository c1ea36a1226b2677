"""AOT export and serving through ``torch.export``: the port of
``opengpc_tpu.aot``.

``export_sparsematch`` traces the complete device pipeline of one output
contract (the key or code kernel, the matcher, the contract's outputs) for
one (H, W) frame shape with ``torch.export`` and serializes the program
(``torch.export.save``).  The forest's tests, the settings, the shape and
the contract are burned in: the kernels are the ``ogpc::`` custom ops of
``ops.library``, whose test list is a constant of the graph.  A program
exported on the card launches the hand-written kernels when it runs; one
exported on the CPU runs their plain twins.  No decomposition runs, so
the ops and ``torch.sort`` stay as the live module calls them and the
loaded program computes what the live module does.  The serving side
needs torch and ``opengpc_tpu_torch.ops`` (imported by the loaders: it
registers the ops), not the forest file, and nothing is traced again.

Artifacts are self-describing in the JAX package's layout: an 8-byte
magic, a little-endian u32 header length, a JSON header with the JAX
package's keys plus ``"package"`` and ``"device"``, then the blob.  The
port's magic (``OGPCPT01``) is not the JAX package's (``OGPCAOT1``), so
each package refuses the other's files with a clear error;
``peek_artifact_meta`` reads both headers.

The sharded exports run in a launch of N ranks (``torchrun``,
``parallel.init_distributed``).  Each rank's program bakes in its own slab
origin (the key kernel's host argument ``y0``), so every rank exports its
program, the blob holds all N, and rank r of the serving launch runs
program r.  The collectives are torch's functional collectives, which
name their process group in the graph; the loaders rewrite those names to
the serving groups'.  The loaded callable takes whole frames on every
rank and returns the whole result on every rank.

    blob = export_sparsematch(forest, settings, (436, 1024), "masked")
    save_artifact("m.ogpcx", blob, contract="masked", settings=settings,
                  shape=(436, 1024))
    call, meta = load_artifact("m.ogpcx")
    supports = decode_outputs(meta, call(left, right))
"""

from __future__ import annotations

import io
import json
import struct
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from opengpc_tpu_torch.config import InferenceSettings

CONTRACTS = ("flat", "rows", "masked", "masked-compact", "global-rows",
             "global-compact", "pyramid", "pyramid-compact")

_MAGIC = b"OGPCPT01"
_JAX_MAGIC = b"OGPCAOT1"  # opengpc_tpu.aot's container
_RANKS_MAGIC = b"OGPCPTRK"  # a sharded blob: one program a rank
PACKAGE = "opengpc_tpu_torch"


def _module_for(contract: str, mask, settings: InferenceSettings, shape,
                device, num_levels: int = 3) -> nn.Module:
    """The live module of ``contract`` on ``device``, refused as the JAX
    package's ``_impl_for`` refuses an ineligible contract for ``shape``.
    ``num_levels`` applies to the pyramid contracts only."""
    from opengpc_tpu_torch.infer import (_global_rows_ok, _rows_ok,
                                         build_sparsematch,
                                         build_sparsematch_global_compact,
                                         build_sparsematch_global_rows,
                                         build_sparsematch_masked,
                                         build_sparsematch_masked_compact,
                                         build_sparsematch_rows)

    if contract not in CONTRACTS:
        raise ValueError(f"contract must be one of {CONTRACTS}, "
                         f"got {contract!r}")
    if contract in ("pyramid", "pyramid-compact"):
        from opengpc_tpu_torch.pyramid import (
            _rows_eligible, build_pyramid_sparsematch,
            build_pyramid_sparsematch_compact)

        if contract == "pyramid":
            # the rows pyramid where eligible, the flat per-level path
            # otherwise: the same output contract either way
            return build_pyramid_sparsematch(mask, settings,
                                             num_levels=num_levels,
                                             device=device)
        el = _rows_eligible(mask, settings, shape[-2], shape[-1], num_levels)
        if el is None or settings.disp_high < 1:
            raise ValueError(
                "contract 'pyramid-compact' needs epipolar mode, a "
                "<=30-test packable forest, disp_high >= 1 and 31-bit "
                f"packable dedup keys for shape {tuple(shape)} x "
                f"{num_levels} levels; export 'pyramid' instead")
        return build_pyramid_sparsematch_compact(mask, settings,
                                                 num_levels=num_levels,
                                                 device=device)
    if contract == "flat":
        return build_sparsematch(mask, settings, device)
    hw = tuple(shape[-2:])
    if contract in ("global-rows", "global-compact"):
        if settings.epipolar_mode:
            raise ValueError(f"contract {contract!r} needs "
                             "epipolar_mode=False")
        if not _global_rows_ok(mask, hw, settings):
            raise ValueError(f"contract {contract!r} has no packable "
                             f"(y, x) key for shape {tuple(shape)}")
        if contract == "global-compact":
            return build_sparsematch_global_compact(mask, settings, device)
        return build_sparsematch_global_rows(mask, settings, device)
    if not _rows_ok(mask, hw, settings):
        raise ValueError(f"contract {contract!r} needs epipolar mode, a "
                         f"<=30-test forest and packable (x, d) keys for "
                         f"shape {tuple(shape)}")
    build = {"masked": build_sparsematch_masked,
             "rows": build_sparsematch_rows,
             "masked-compact": build_sparsematch_masked_compact}[contract]
    return build(mask, settings, device)


def _examples(shape, device):
    """Two example frames for the trace: static shapes, as JAX freezes
    one shape."""
    return tuple(torch.zeros(tuple(shape), dtype=torch.uint8,
                             device=device) for _ in range(2))


def _export(module: nn.Module, examples) -> bytes:
    program = torch.export.export(module, examples, strict=False)
    # the traced frames (zeros, 2 * H * W bytes) are not part of the
    # program: the artifact does not carry them
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_sparsematch(forest_or_mask, settings: InferenceSettings,
                       shape: Tuple[int, int], contract: str = "masked",
                       device="cuda", num_levels: int = 3) -> bytes:
    """Serialize the full matcher pipeline of ``contract`` for one (H, W)
    frame shape on ``device``: the ``torch.export.save`` bytes of the
    program (no container header; see ``save_artifact``).  On ``"cuda"``
    the program launches the hand-written kernels, on ``"cpu"`` it runs
    their plain twins.  ``num_levels`` applies to the pyramid contracts
    (burned in like everything else)."""
    from opengpc_tpu_torch.infer import _as_mask

    device = torch.device(device)
    module = _module_for(contract, _as_mask(forest_or_mask), settings, shape,
                         device, num_levels)
    return _export(module, _examples(shape, device))


def _load_program(data: bytes):
    """A ``torch.export`` program from its bytes, the ``ogpc::`` ops
    registered first.  A CUDA program on a host without CUDA raises: it
    never moves to the CPU."""
    import opengpc_tpu_torch.ops  # noqa: F401  (registers the ogpc:: ops)

    try:
        return torch.export.load(io.BytesIO(data))
    except RuntimeError as e:
        if not torch.cuda.is_available() and "CUDA" in str(e):
            raise RuntimeError(
                "this artifact was exported for a CUDA device and this "
                "host has no CUDA; a CUDA artifact never runs on the CPU "
                "(export one with device='cpu')") from e
        raise


def _program_device(program) -> torch.device:
    """The device of the program's first user input."""
    first = program.graph_signature.user_inputs[0]
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name == first:
            return node.meta["val"].device
    raise ValueError("the program has no user input")


class Served:
    """A loaded program: ``(left, right)`` whole frames -> the contract's
    outputs on the program's device, nested as the live module nests
    them.  Arrays are uploaded to the device; tensors must be on it."""

    def __init__(self, module, device: torch.device):
        self.module, self.device = module, device

    def _arg(self, x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if x.device != self.device:
            raise ValueError(f"the artifact runs on {self.device}; got a "
                             f"tensor on {x.device}")
        return x

    def __call__(self, left, right):
        return self.module(self._arg(left), self._arg(right))


def _same_device(want, have: torch.device) -> None:
    if want is None:
        return
    want = torch.device(want)
    if want.type != have.type or (want.index is not None
                                  and have.index is not None
                                  and want.index != have.index):
        raise ValueError(f"the artifact was exported for {have}; asked to "
                         f"serve it on {want}")


def load_sparsematch(data: bytes, device=None) -> Callable:
    """An ``export_sparsematch`` blob as a callable ``(left, right) ->
    device outputs`` (the contract's, nested as the live module's) on the
    device it was exported for; ``device``, when given, must be that
    device.  Needs torch and the port's ops, no forest file, no
    re-trace."""
    program = _load_program(data)
    dev = _program_device(program)
    _same_device(device, dev)
    return Served(program.module(), dev)


# -- the sharded exports: one program a rank ----------------------------------


class _Whole(nn.Module):
    """A rank's module on whole frames: its block cut out, its outputs
    gathered into the whole result (``run_whole``)."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, left, right):
        return self.module.run_whole(left, right)


def _group_names(groups: dict) -> dict:
    """{role: the process group's name}, the names a functional
    collective writes into the graph."""
    return {role: g.group_name for role, g in groups.items()
            if g is not None}


def _export_ranks(module, examples, groups: dict, group) -> bytes:
    """Every rank of ``group`` exports its program of ``module`` on whole
    ``examples``; all ranks get the blob of all programs in rank order,
    each with the names of its ``groups`` (a role -> process group
    dict)."""
    import torch.distributed as dist

    mine = (_export(_Whole(module), examples), _group_names(groups))
    if group is None:
        ranks = [mine]
    else:
        ranks = [None] * dist.get_world_size(group)
        dist.all_gather_object(ranks, mine, group=group)
    head = json.dumps([{"size": len(blob), "groups": names}
                       for blob, names in ranks]).encode()
    return b"".join([_RANKS_MAGIC, struct.pack("<I", len(head)), head]
                    + [blob for blob, _ in ranks])


def _rank_programs(data: bytes):
    """[(program bytes, {role: group name})] of a sharded blob."""
    if data[:len(_RANKS_MAGIC)] != _RANKS_MAGIC:
        raise ValueError("not a sharded export (one program a rank); load "
                         "it with load_sparsematch")
    at = len(_RANKS_MAGIC)
    (hlen,) = struct.unpack("<I", data[at:at + 4])
    at += 4
    ranks = []
    for entry in json.loads(data[at:at + hlen].decode()):
        start = at + hlen + sum(len(b) for b, _ in ranks)
        ranks.append((data[start:start + entry["size"]], entry["groups"]))
    return ranks


def _serve_rank(blob: bytes, names: dict, groups: dict) -> Served:
    """Rank r's program with its collectives retargeted: every group name
    the export recorded (``names``, role -> name) becomes the name of the
    serving group of that role (``groups``, role -> process group)."""
    program = _load_program(blob)
    dev = _program_device(program)
    module = program.module()
    rename = {}
    for role, name in names.items():
        if groups.get(role) is None:
            raise ValueError(f"the artifact's program runs collectives over "
                             f"its {role!r} group; serve it in a process "
                             "group (parallel.init_distributed)")
        rename[name] = groups[role].group_name
    for node in module.graph.nodes:
        schema = getattr(node.target, "_schema", None)
        if node.op != "call_function" or schema is None:
            continue
        args = [a.name for a in schema.arguments]
        if not schema.name.startswith("_c10d_functional::") or \
                "group_name" not in args:
            continue
        i = args.index("group_name")
        new = list(node.args)
        if i >= len(new) or new[i] not in rename:
            raise ValueError(f"{node.target} names group {new[i:i + 1]}, "
                             "which the artifact does not record")
        new[i] = rename[new[i]]
        node.args = tuple(new)
    module.recompile()
    return Served(module, dev)


def export_sharded_frame(forest_or_mask, settings: InferenceSettings,
                         shape: Tuple[int, int], group=None,
                         contract: str = "masked", device="cuda",
                         num_levels: int = 3) -> bytes:
    """Serialize the row-sharded single-frame matcher
    (``parallel.build_sharded_frame_sparsematch``: one pair's rows over
    ``group``'s N ranks, the 14-row halo exchange), one program a rank;
    ``contract="pyramid"`` the sharded pyramid
    (``parallel.build_sharded_frame_pyramid``, ``num_levels`` levels; H
    must divide by N * 2^(levels-1)).  Every rank of ``group`` calls it
    with its own ``device`` and gets the same blob.  The blob pins N: serve
    it over N ranks (``load_sharded_frame``)."""
    from opengpc_tpu_torch.parallel import (build_sharded_frame_pyramid,
                                            build_sharded_frame_sparsematch)

    device = torch.device(device)
    if contract == "pyramid":
        module = build_sharded_frame_pyramid(forest_or_mask, settings, group,
                                             num_levels=num_levels,
                                             device=device)
    else:
        module = build_sharded_frame_sparsematch(forest_or_mask, settings,
                                                 group, contract=contract,
                                                 device=device)
    return _export_ranks(module, _examples(shape, device), {"frame": group},
                         group)


def load_sharded_frame(data: bytes, group=None) -> Optional[Callable]:
    """An ``export_sharded_frame`` blob on this rank: a callable that
    takes the whole (H, W) pair and returns the whole result, on every
    rank.  With ``group=None`` the serving group is the world when it has
    N ranks, else the first N ranks of a larger world (a new group, which
    every rank of the world must make, so every rank calls this); a rank
    outside it gets None.  An explicit group must have N ranks."""
    import torch.distributed as dist

    ranks = _rank_programs(data)
    n = len(ranks)
    if group is None and dist.is_initialized():
        world = dist.get_world_size()
        if world < n:
            raise ValueError(f"artifact was exported for {n} ranks; the "
                             f"world has {world}")
        group = (dist.group.WORLD if world == n
                 else dist.new_group(list(range(n))))
        if dist.get_rank() >= n:
            return None
    have = dist.get_world_size(group) if group is not None else 1
    if have != n:
        raise ValueError(f"artifact was exported for {n} ranks; the serving "
                         f"group has {have}")
    blob, names = ranks[dist.get_rank(group) if group is not None else 0]
    return _serve_rank(blob, names, {"frame": group})


def export_batched_sharded_frame(forest_or_mask,
                                 settings: InferenceSettings, batch: int,
                                 shape: Tuple[int, int], grid=None,
                                 contract: str = "masked", device="cuda",
                                 num_levels: int = 3) -> bytes:
    """Serialize the 2-D matcher
    (``parallel.build_batched_sharded_frame_sparsematch``: a (batch, H, W)
    stack over a (n_data, n_rows) grid of ranks from
    ``parallel.make_mesh_2d``, frames over the frame groups, each frame's
    rows over a frame group's ranks), one program a rank;
    ``contract="pyramid"`` the 2-D pyramid
    (``parallel.build_batched_sharded_frame_pyramid``).  The blob pins the
    grid's shape: serve it over a grid of that shape
    (``load_batched_sharded_frame``, or ``load_artifact`` with
    ``{"mesh_shape": [D, R], "batch": B}`` metadata).  Outputs keep the
    stacked (batch, ...) layout: decode frame by frame."""
    from opengpc_tpu_torch.parallel import (
        Grid, build_batched_sharded_frame_pyramid,
        build_batched_sharded_frame_sparsematch)

    device = torch.device(device)
    grid = grid if grid is not None else Grid(1, 1)
    if contract == "pyramid":
        module = build_batched_sharded_frame_pyramid(
            forest_or_mask, settings, grid, num_levels=num_levels,
            device=device)
    else:
        module = build_batched_sharded_frame_sparsematch(
            forest_or_mask, settings, grid, contract=contract, device=device)
    return _export_ranks(module, _examples((batch,) + tuple(shape), device),
                         {"grid": grid.group, "rows": grid.rows_group},
                         grid.group)


def load_batched_sharded_frame(data: bytes, mesh_shape: Tuple[int, int],
                               grid=None) -> Callable:
    """An ``export_batched_sharded_frame`` blob on this rank over a grid of
    the exported (n_data, n_rows) shape (default: ``make_mesh_2d`` over
    the world, which must have D * R ranks)."""
    from opengpc_tpu_torch.parallel import make_mesh_2d

    ranks = _rank_programs(data)
    d, r = mesh_shape
    if len(ranks) != d * r:
        raise ValueError(f"the artifact holds {len(ranks)} programs, not "
                         f"the {d * r} of a {d}x{r} grid")
    if grid is None:
        grid = make_mesh_2d(d, r)
    if (grid.n_data, grid.n_rows) != (d, r):
        raise ValueError(f"artifact was exported for a {d}x{r} (data, rows) "
                         f"mesh; the serving grid is {grid.n_data}x"
                         f"{grid.n_rows}")
    rank = grid.data_rank * grid.n_rows + grid.row_rank
    blob, names = ranks[rank]
    return _serve_rank(blob, names, {"grid": grid.group,
                                     "rows": grid.rows_group})


# -- the container ------------------------------------------------------------


def save_artifact(path: str, blob: bytes, *, contract: str,
                  settings: InferenceSettings, shape: Tuple[int, int],
                  device="cuda", use_pallas: Optional[bool] = None,
                  extra: Optional[dict] = None) -> None:
    """Write a self-describing artifact: the port's magic, the JSON
    metadata (the decode parameters a generic server needs; JAX's keys,
    ``"package"`` and the ``"device"`` type the blob was exported on),
    then the blob.  ``use_pallas`` defaults to whether the program
    launches the hand-written kernels (a CUDA export).  ``extra`` merges
    more keys (``{"n_devices": N}`` for sharded-frame artifacts)."""
    kind = torch.device(device).type
    meta = {
        "contract": contract,
        "shape": list(shape),
        "disp_high": settings.disp_high,
        "capacity": settings.capacity,
        "epipolar_mode": settings.epipolar_mode,
        "gradient_threshold": settings.gradient_threshold,
        "vertical_tolerance": settings.vertical_tolerance,
        "platforms": [kind],
        "use_pallas": kind == "cuda" if use_pallas is None else use_pallas,
        "package": PACKAGE,
        "device": kind,
    }
    if extra:
        meta.update(extra)
    head = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(blob)


def _read_artifact(path: str, want_blob: bool,
                   jax_ok: bool = False) -> Tuple[dict, bytes]:
    """One open and parse of an artifact: (metadata, blob).
    ``want_blob=False`` stops after the JSON header; ``jax_ok`` reads the
    JAX package's header too (the peek path)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC and not jax_ok:
            raise ValueError(
                f"{path}: written by the JAX package (magic {magic!r}); load "
                "it with opengpc_tpu.aot.load_artifact, or export it again "
                "with opengpc_tpu_torch.aot")
        if magic not in (_MAGIC, _JAX_MAGIC):
            raise ValueError(f"{path}: not an opengpc AOT artifact "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode())
        if magic == _JAX_MAGIC:
            meta.setdefault("package", "opengpc_tpu")
        return meta, (f.read() if want_blob else b"")


def peek_artifact_meta(path: str) -> dict:
    """The JSON metadata of an artifact of either package (the port's
    ``"package"`` is ``opengpc_tpu_torch``, the JAX package's
    ``opengpc_tpu``), without loading the program: lets a caller route or
    refuse it (a stacked ``mesh_shape`` artifact on a single-device
    server, a CUDA artifact on a host without CUDA) first."""
    return _read_artifact(path, want_blob=False, jax_ok=True)[0]


def load_artifact(path: str, group=None) -> Tuple[Callable, dict]:
    """Load a ``save_artifact`` file: (callable, metadata).

    A sharded-frame artifact (one program a rank) routes through
    ``load_sharded_frame`` (``group``: a process group, default the world
    or its first N ranks), a stacked one (``mesh_shape`` metadata)
    through ``load_batched_sharded_frame`` (``group``: a ``Grid``, default
    ``make_mesh_2d``); everything else loads on its device through
    ``load_sparsematch``.  A CUDA artifact on a host without CUDA raises
    before the program is read."""
    meta, blob = _read_artifact(path, want_blob=True)
    if meta.get("device") == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for a CUDA device and this "
                           "host has no CUDA; a CUDA artifact never runs on "
                           "the CPU (export one with --device cpu)")
    if meta.get("mesh_shape"):
        return load_batched_sharded_frame(blob, tuple(meta["mesh_shape"]),
                                          group), meta
    if blob[:len(_RANKS_MAGIC)] == _RANKS_MAGIC:
        return load_sharded_frame(blob, group), meta
    return load_sparsematch(blob), meta


def _flag(t) -> bool:
    return bool(torch.as_tensor(t).cpu().any())


def decode_outputs(meta: dict, out) -> np.ndarray:
    """Route an artifact's device outputs to the matching host decoder:
    (n, 3) [x, y, d] supports, or (n, 4) [x, y, d, level] for the pyramid
    contracts (level-0 units; ``[:, :3]`` is the plain list).  The compact
    contracts' overflow flag raises ``OverflowError`` here: an artifact is
    one frozen program, so the caller serves a full-width artifact for
    dense frames."""
    from opengpc_tpu_torch.infer import (global_row_supports_to_numpy,
                                         masked_supports_to_numpy,
                                         row_supports_to_numpy,
                                         supports_to_numpy)

    contract = meta["contract"]
    if contract in ("pyramid", "pyramid-compact"):
        from opengpc_tpu_torch.pyramid import pyramid_supports_to_numpy

        if contract == "pyramid-compact":
            *out, ovf = out
            if _flag(ovf):
                raise OverflowError(
                    "pyramid-compact chunk overflow: frame too dense for "
                    "this artifact — serve a full 'pyramid' artifact for "
                    "it")
        return pyramid_supports_to_numpy(*out)
    if contract == "flat":
        return supports_to_numpy(*out)
    if contract == "rows":
        (xs, ds), counts = out
        return row_supports_to_numpy(xs, ds, counts)
    if contract == "masked":
        buf, counts = out
        return masked_supports_to_numpy(buf, counts, meta["disp_high"])
    if contract == "masked-compact":
        buf, counts, ovf = out
        if _flag(ovf):
            raise OverflowError(
                "masked-compact chunk overflow: frame too dense for this "
                "artifact — serve a full-width 'masked' artifact for it")
        return masked_supports_to_numpy(buf, counts, meta["disp_high"])
    if contract == "global-rows":
        (xs, ys, ds), counts = out
        return global_row_supports_to_numpy(xs, ys, ds, counts)
    if contract == "global-compact":
        (xs, ys, ds), counts, ovf = out
        if _flag(ovf):
            raise OverflowError(
                "global-compact chunk overflow: frame too dense for this "
                "artifact — serve a full-width 'global-rows' artifact for "
                "it")
        return global_row_supports_to_numpy(xs, ys, ds, counts)
    raise ValueError(f"unknown contract {contract!r} in artifact metadata")
