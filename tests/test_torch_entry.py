"""The port's entry point (``seeksv_tpu_torch/entry.py``) against
``__graft_entry__.py:entry``'s TPU branch: the same inputs from the same
draws, and on the CPU the same results as the Pallas kernel in interpret
mode, exactly."""
import importlib.util
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seeksv_tpu.ops.pallas_sw import pallas_extend_batch_resident
from seeksv_tpu_torch import entry as port_entry
from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, LQ, LT = 1 << 16, 64, 128


@pytest.fixture
def tpu_branch_args(monkeypatch):
    """The JAX entry's TPU-branch arguments, built on the CPU by letting
    the entry see a device whose platform is not ``cpu`` (and keeping its
    import from pointing jax's compilation cache into HOME)."""
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [SimpleNamespace(platform="tpu")])
    _fn, args = mod.entry()
    return [np.asarray(a) for a in args]


def test_entry_inputs_are_the_tpu_branch_draws(tpu_branch_args):
    _fn, args = port_entry.entry("cpu")
    assert len(args) == len(tpu_branch_args) == 6
    for got, want in zip(args, tpu_branch_args):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    q4, qlen, tstart, tlen, h0, refp = args
    assert q4.shape == (128, LQ // 2) and q4.dtype == torch.uint8
    assert refp.shape == (G // 2,)


def test_entry_matches_pallas_interpret():
    """fn(*args) on the CPU is the kernel's plain version (counted as
    such) and equals pallas_extend_batch_resident(..., interpret=True)."""
    fn, args = port_entry.entry("cpu")
    before = dict(ext.PLAIN_CALLS)
    got = fn(*args)
    assert ext.PLAIN_CALLS["extend_right"] == before["extend_right"] + 1
    want = pallas_extend_batch_resident(
        *(jnp.asarray(a.numpy()) for a in args[:5]),
        jnp.asarray(args[5].numpy()), G, LQ, LT, False, interpret=True)
    for k in ext.KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["max_score"].max()) > 19


def test_entry_reexports_the_dry_run():
    assert port_entry.dryrun_multichip is dryrun.dryrun_multichip


def test_entry_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
