"""voxelrs_tpu_torch's gather probe P0 (``probes/gather_probe.py``, its
plain version on the CPU) against the JAX package's Pallas probe kernel,
scripts/probes/pallas_probe.py's own ``make_kernel`` run through
``pl.pallas_call(..., interpret=True)`` with no TPU memory spaces, and the
probe's configurations.

Tolerance: equal bit for bit (u32 words; the same modulo and LCG wrap).
Tables: the probe's ``arange`` table and a random one from a seed, at 512
steps and 37. At 512 steps the LCG's low bits run whole periods, so every
lane XORs in each word of its walk an even number of times or XORs a
whole column: ``axis1`` gives all zeros on any table (each column four
times) and ``axis0`` on the ``arange`` table (the 512 rows of a column
XOR to 0). The probe's own configuration alone would hide wrong
addressing there; the random table and 37 steps do not.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from voxelrs_tpu_torch.probes import gather_probe

PROBE = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                     "probes", "pallas_probe.py")


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("pallas_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("table", ["arange", "random"])
@pytest.mark.parametrize("steps", [512, 37])
@pytest.mark.parametrize("kind", ["flat", "axis0", "axis1", "two_step"])
def test_plain_matches_the_jax_probe_kernel(probe, monkeypatch, kind, steps,
                                            table):
    rows, sub = 512, 8
    tbl = (gather_probe.arange_table(rows) if table == "arange"
           else gather_probe.random_words((rows, 128), seed=11))
    seeds = gather_probe.random_words((sub, 128), seed=3, high=1 << 30)
    monkeypatch.setattr(probe, "N_STEPS", steps)
    fn = pl.pallas_call(probe.make_kernel(kind, rows, sub),
                        out_shape=jax.ShapeDtypeStruct((sub, 128),
                                                       jnp.uint32),
                        interpret=True)
    want = np.asarray(fn(jnp.asarray(_u32(tbl)), jnp.asarray(_u32(seeds))))
    got = _u32(gather_probe.gather_probe(tbl, seeds, kind, steps))
    np.testing.assert_array_equal(got, want)
    zeros = steps == 512 and (kind == "axis1" or (kind == "axis0"
                                                  and table == "arange"))
    assert bool(got.any()) != zeros  # why 37 steps and the random table


def test_two_step_is_not_flat():
    """``two_step`` reads the row index of the lane at column c, so it
    differs from the general gather on the same seeds."""
    tbl = gather_probe.random_words((512, 128), seed=11)
    seeds = gather_probe.random_words((8, 128), seed=3, high=1 << 30)
    two = gather_probe.gather_probe_plain(tbl, seeds, "two_step", 37)
    flat = gather_probe.gather_probe_plain(tbl, seeds, "flat", 37)
    assert (two != flat).any()


def test_probe_configs_and_refusals():
    """The JAX probe's configurations (its ``__main__``) and what the
    wrapper refuses."""
    assert gather_probe.probe_configs() == [
        ("axis1", 512, 8), ("axis0", 512, 8), ("axis0", 4096, 8),
        ("axis0", 16384, 8), ("two_step", 512, 8), ("two_step", 4096, 8),
        ("two_step", 16384, 8), ("flat", 512, 8), ("flat", 4096, 8),
        ("flat", 16384, 8)]
    tbl = gather_probe.arange_table(8)
    with pytest.raises(ValueError, match="unknown kind"):
        gather_probe.gather_probe(tbl, tbl, "diagonal")
    assert gather_probe.main(["diagonal"]) == 2
