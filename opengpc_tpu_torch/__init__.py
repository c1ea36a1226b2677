"""PyTorch/CUDA port of opengpc_tpu: GPC sparse stereo matching on an
NVIDIA H100.

The one-call ``sparsematch`` runs every route of the JAX package: at one
level the masked epipolar contract, the global-rows contract (the library
defaults: global mode, gradient threshold 10) and the flat contract (any
forest of <= 32 tests, either mode), and with ``levels > 1`` the
coarse-to-fine pyramid (``opengpc_tpu_torch.pyramid``), on arrays,
tensors or PNG paths, with the hand-written CUDA kernels of ``csrc/``
(fused keys, fused codes, bitonic row sort, fused match) and the native
host decode of ``cpp/decode.cc``.  The row-form and chunk-compacted
contracts have their builders, ``build_stereomatch`` gives the unfiltered
correspondences, and ``opengpc_tpu_torch.parallel`` shards one frame's
rows over a ``torch.distributed`` group (the key kernel's slab mode).
``ops.fused.fused_census`` is the census kernel.

The offline workflow runs through the port too: ``mine`` mines
ground-truth triplets from Sintel-layout trees into the binary triplet
format (``io.triplets``), ``train_forest`` trains a fern forest on the
card (plain PyTorch gathers, compares and integer sums; the split is
chosen on the host), and ``python -m opengpc_tpu_torch.cli.extract`` /
``python -m opengpc_tpu_torch.cli.train`` are the two CLIs.  For the same
seed and inputs the triplet files and forest text are byte-identical to
the JAX package's.  The package imports torch and numpy and never JAX;
importing it builds and loads no kernel and no host library.

The front door is the ``sparsematch`` CLI, as in the JAX package: ``python
-m opengpc_tpu_torch.cli.sparsematch FOREST L.png R.png`` matches a pair on
the card (every contract, ``--pyramid``, ``--densify``, ``--viz-compat``,
the host matchers ``--matcher quirk|hashmatch``), or every pair of two
frame directories in sequence mode.  ``densify_supports`` and
``densify_from_masked`` (``densify``) turn supports or the masked buffer
into a dense disparity map on the card, bit for bit JAX's; ``viz``,
``types`` and ``io.supports`` are numpy copies.

The kernels are ``torch.library`` custom ops (``ops.library``, namespace
``ogpc``), so ``torch.export`` traces every matcher: ``aot`` exports a
contract's program for one frame shape (the forest burned in), saves it in
a self-describing artifact and serves it again, and ``python -m
opengpc_tpu_torch.cli.aot export|run`` is its CLI; the sharded exports
hold one program a rank of a ``torchrun`` launch.

>>> from opengpc_tpu_torch import InferenceSettings, sparsematch
>>> supports = sparsematch(left, right, "forests/defaultZeroForest.txt")
>>> from_files = sparsematch("left.png", "right.png",
...                          "forests/defaultZeroForest.txt", levels=3)
>>> cli = sparsematch(left, right, "forests/defaultZeroForest.txt",
...                   InferenceSettings(gradient_threshold=5,
...                                     epipolar_mode=True))
>>> forest = train_forest(load_triplets("triplets.bin"),
...                       fern_factory(2, 2, 2, 5), zero_optimizer(), seed=0)
>>> save_forest(forest, "fresh.txt")
"""

from opengpc_tpu_torch.config import (ForestSettings, InferenceSettings,
                                      OptimizerSettings, fern_factory,
                                      tau_optimizer, zero_optimizer)
from opengpc_tpu_torch.forest import (Fern, FilterMask, Forest, Test,
                                      filter_mask_from_numpy, load_forest,
                                      make_filter_mask, parse_forest,
                                      save_forest, serialize_forest,
                                      truncate_forest)
from opengpc_tpu_torch.infer import (build_sparsematch,
                                     build_sparsematch_global_compact,
                                     build_sparsematch_global_rows,
                                     build_sparsematch_masked,
                                     build_sparsematch_masked_compact,
                                     build_sparsematch_rows,
                                     build_stereomatch, extract_descriptors,
                                     global_row_supports_to_numpy,
                                     masked_supports_to_numpy,
                                     row_supports_to_numpy, sparsematch,
                                     supports_to_numpy)
from opengpc_tpu_torch.aot import (export_batched_sharded_frame,
                                   export_sharded_frame, export_sparsematch,
                                   load_artifact, load_batched_sharded_frame,
                                   load_sharded_frame, load_sparsematch,
                                   peek_artifact_meta, save_artifact)
from opengpc_tpu_torch.densify import densify_from_masked, densify_supports
from opengpc_tpu_torch.io.triplets import load_triplets, save_triplets
from opengpc_tpu_torch.train import train_fern, train_forest
from opengpc_tpu_torch.types import Correspondence, Descriptor, Point, Support

__version__ = "0.5.0"

__all__ = [
    "Correspondence",
    "Descriptor",
    "Fern",
    "FilterMask",
    "Forest",
    "ForestSettings",
    "InferenceSettings",
    "OptimizerSettings",
    "Point",
    "Support",
    "Test",
    "__version__",
    "build_sparsematch",
    "build_sparsematch_global_compact",
    "build_sparsematch_global_rows",
    "build_sparsematch_masked",
    "build_sparsematch_masked_compact",
    "build_sparsematch_rows",
    "build_stereomatch",
    "densify_from_masked",
    "densify_supports",
    "export_batched_sharded_frame",
    "export_sharded_frame",
    "export_sparsematch",
    "extract_descriptors",
    "fern_factory",
    "filter_mask_from_numpy",
    "global_row_supports_to_numpy",
    "load_artifact",
    "load_batched_sharded_frame",
    "load_forest",
    "load_sharded_frame",
    "load_sparsematch",
    "load_triplets",
    "make_filter_mask",
    "masked_supports_to_numpy",
    "parse_forest",
    "peek_artifact_meta",
    "row_supports_to_numpy",
    "save_artifact",
    "save_forest",
    "save_triplets",
    "serialize_forest",
    "sparsematch",
    "supports_to_numpy",
    "tau_optimizer",
    "train_fern",
    "train_forest",
    "truncate_forest",
    "zero_optimizer",
]
