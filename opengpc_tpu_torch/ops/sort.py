"""Per-row bitonic sort with a payload: the port of
``opengpc_tpu.ops.sort.bitonic_sort_rows``.

``bitonic_sort_rows`` calls the custom op ``ogpc::bitonic_sort_rows``
(``ops.library``), which launches the kernel of ``csrc/bitonic_sort.cu``
on a CUDA tensor and raises on any failure, and runs
``bitonic_sort_rows_plain`` on a CPU tensor.  Both run the Pallas
kernel's network stage for stage (``bitonic_network``): lane i meets lane
i ^ j, the pair sorts ascending when ``(i & size) == 0``, keys alone
decide and equal keys never swap.  The network is fixed, so the kernel,
the plain version and the JAX package's kernel give bit-identical keys
AND payloads.
``bitonic_sort_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

MIN_N, MAX_N = 256, 16384  # the kernel holds one row in shared memory


def padded_row_length(w: int) -> int:
    """N2 = max(256, pow2 >= 2W): the row length a (2W)-key matcher row is
    padded to for the bitonic network.  A loop of compares, so that a
    symbolic W (the fused match op's fake under ``torch.export``)
    traces."""
    n = MIN_N
    while n < 2 * w:
        n *= 2
    return n


def _check(key: torch.Tensor, payload: torch.Tensor) -> None:
    if key.dim() != 2 or key.shape != payload.shape:
        raise ValueError(f"expected (R, N) key and payload, got "
                         f"{tuple(key.shape)} and {tuple(payload.shape)}")
    if key.dtype != torch.int32 or payload.dtype != torch.int32:
        raise ValueError(f"expected int32 key and payload, got {key.dtype} "
                         f"and {payload.dtype}")
    if key.device != payload.device:
        raise ValueError(f"key on {key.device}, payload on {payload.device}")
    n = key.shape[1]
    if n & (n - 1) or n < MIN_N:
        raise ValueError(f"row length {n} must be a power of two >= {MIN_N}")
    if n > MAX_N:
        raise ValueError(f"row length {n} exceeds the kernel's {MAX_N}: one "
                         "row of keys and payloads must fit a block's shared "
                         "memory")


def _vector_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel's vector loads
    need: a view that starts off 16 bytes is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bitonic_sort_rows_plain(key: torch.Tensor, payload: torch.Tensor):
    """Plain-PyTorch twin: the same network as whole-row tensor ops."""
    _check(key, payload)
    n = key.shape[1]
    lane = torch.arange(n, device=key.device)
    size = 2
    while size <= n:
        asc = (lane & size) == 0
        j = size >> 1
        while j > 0:
            partner = lane ^ j
            keep_min = ((lane & j) == 0) == asc
            ok, op = key[:, partner], payload[:, partner]
            take = torch.where(keep_min, ok < key, ok > key)
            key = torch.where(take, ok, key)
            payload = torch.where(take, op, payload)
            j >>= 1
        size <<= 1
    return key, payload


def _launch(key: torch.Tensor, payload: torch.Tensor):
    """One launch of the sort kernel on (R, N) int32 CUDA rows: the CUDA
    implementation of ``ogpc::bitonic_sort_rows`` (``ops.library``)."""
    from opengpc_tpu_torch.ops._build import check_launch, load_library

    key, payload = _vector_ready(key), _vector_ready(payload)
    key_s, pay_s = torch.empty_like(key), torch.empty_like(payload)
    lib = load_library()
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ogpc_bitonic_sort_rows(
            key.data_ptr(), payload.data_ptr(), key_s.data_ptr(),
            pay_s.data_ptr(), key.shape[0], key.shape[1], stream)
    check_launch("bitonic_sort_rows", rc)
    bitonic_sort_rows.launches += 1
    return key_s, pay_s


def bitonic_sort_rows(key: torch.Tensor, payload: torch.Tensor):
    """Sort each row of the (R, N) int32 ``key`` ascending by key alone
    (equal keys in the network's fixed order), permuting ``payload``
    alongside.  N is a power of two in [256, 16384].  The op
    ``ogpc::bitonic_sort_rows``: the kernel on CUDA tensors, the plain
    version on CPU ones."""
    from opengpc_tpu_torch.ops import library

    _check(key, payload)
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bitonic_sort_rows: no kernel for {key.device} "
                         "tensors")
    return library.bitonic_sort_rows(key, payload)


bitonic_sort_rows.launches = 0
