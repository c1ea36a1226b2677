"""The bitonic row sort's plain twin against the JAX package's Pallas kernel
(interpret mode): keys AND payloads bit-identical, since the network is
fixed."""

import numpy as np
import pytest
import torch

from opengpc_tpu.ops import sort as jsort

from opengpc_tpu_torch.ops import sort as tsort


def rows(shape, dup_every, seed):
    """Signed int32 keys drawn from a pool of N / dup_every values (many
    duplicates) and a distinct payload per element."""
    r, n = shape
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(1 << 31), 1 << 31, n // dup_every,
                        dtype=np.int64).astype(np.int32)
    key = pool[rng.integers(0, len(pool), (r, n))]
    pay = rng.permutation(r * n).reshape(r, n).astype(np.int32)
    return key, pay


@pytest.mark.parametrize("shape", [(5, 256), (17, 1024)])
@pytest.mark.parametrize("dup_every", [2, 7])
def test_bitonic_plain_equals_pallas_bit_for_bit(shape, dup_every):
    key, pay = rows(shape, dup_every, sum(shape) + dup_every)
    jk, jp = jsort.bitonic_sort_rows(key, pay, interpret=True)
    before = tsort.bitonic_sort_rows.launches
    tk, tp = tsort.bitonic_sort_rows(torch.from_numpy(key),
                                     torch.from_numpy(pay))
    assert tsort.bitonic_sort_rows.launches == before == 0
    assert tk.dtype == tp.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), np.sort(key, axis=1))


def test_bitonic_keeps_equal_keys_in_network_order():
    """All-equal keys never swap: the payload comes back unchanged."""
    key = torch.zeros((3, 512), dtype=torch.int32)
    pay = torch.arange(3 * 512, dtype=torch.int32).reshape(3, 512)
    tk, tp = tsort.bitonic_sort_rows(key, pay)
    assert torch.equal(tp, pay) and torch.equal(tk, key)


@pytest.mark.parametrize("n, match", [(300, "power of two"),
                                      (128, "power of two"),
                                      (32768, "16384")])
def test_bitonic_rejects_bad_rows(n, match):
    key = torch.zeros((2, n), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        tsort.bitonic_sort_rows(key, key)
    if n == 300:
        with pytest.raises(ValueError):
            jsort.bitonic_sort_rows(key.numpy(), key.numpy(), interpret=True)


def test_bitonic_rejects_bad_types_and_devices():
    key = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tsort.bitonic_sort_rows(key.long(), key)
    with pytest.raises(ValueError, match="payload"):
        tsort.bitonic_sort_rows(key, key[:1])
    with pytest.raises(ValueError, match="no kernel"):
        tsort.bitonic_sort_rows(key.to("meta"), key.to("meta"))


@pytest.mark.parametrize("w", [1, 100, 128, 129, 1024, 1920])
def test_padded_row_length_matches_jax(w):
    n2 = tsort.padded_row_length(w)
    assert n2 == max(256, 1 << (2 * w - 1).bit_length())
    assert n2 >= 2 * w and n2 & (n2 - 1) == 0
