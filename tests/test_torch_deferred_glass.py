"""test_deferred_matches_jax of tests/test_torch_deferred.py on its slowest
cases (``GLASS_FILE_CASES``: the glass terrain seen down and from the
ground, the CSVO glass terrain at the horizon): the port's deferred frame
against the JAX ``Svo.render(mode="deferred")`` at 128x96, with and
without the heightfield, on that file's scenes, cameras, tolerances and
checks. A file of its own so that the tier-1 run's workers share the
cases (``--dist loadfile`` gives a file to one worker)."""

import pytest

import test_torch_deferred as td
from test_torch_deferred import _drop_scenes  # noqa: F401

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("scene,cam", td.GLASS_FILE_CASES)
def test_deferred_matches_jax(scene, cam):
    """The port's frame with and without the heightfield against the JAX
    deferred frame (the JAX package's own tests hold its floored frame
    equal to its unfloored one, test_beams.py:282-336 and :488)."""
    td.check_deferred_matches_jax(scene, cam)
