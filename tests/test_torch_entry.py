"""``entry_torch.py``, the port's counterpart of ``__graft_entry__.py``:
its module on the CPU gives ``__graft_entry__.entry()``'s outputs, jitted
on CPU JAX, bit for bit on the same example pair, and its multi-device dry
run passes on one process."""

import inspect
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__  # noqa: E402
import entry_torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_module_equals_jax_entry_on_the_cpu():
    fn, (left, right) = __graft_entry__.entry()
    module, (l, r) = entry_torch.entry(device="cpu")
    np.testing.assert_array_equal(l.numpy(), left)
    np.testing.assert_array_equal(r.numpy(), right)
    want = [np.asarray(o) for o in jax.jit(fn)(left, right)]
    got = [o.numpy() for o in module(l, r)]
    assert len(got) == len(want) == 4
    # the true count; the capacity-8192 buffers hold its first 8192
    assert int(want[3]) > 8192
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_entry_defaults_to_the_card():
    for fn in (entry_torch.entry, entry_torch.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_dryrun_multichip_one_process_on_the_cpu():
    entry_torch.dryrun_multichip(1, device="cpu")


def test_dryrun_multichip_refuses_a_missing_group():
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        entry_torch.dryrun_multichip(2, device="cpu")
