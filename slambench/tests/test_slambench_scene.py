"""The frozen room and orbit are the program's draws (at a small size)."""

import numpy as np
import pytest

from slambench import scene


@pytest.mark.parametrize("n, seed", [(3000, 0), (2500, 7), (4000, 3000000001)])
def test_room_scene_matches_program(n, seed):
    from monogs_torch.data import synthetic

    ours = scene.room_scene(n, scene.numpy_seed(seed))
    theirs = synthetic._room_scene(n, scene.numpy_seed(seed))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_orbit_matches_program():
    from monogs_torch.data import synthetic

    for a, b in zip(scene.orbit_trajectory(40, 0.016), synthetic._orbit_trajectory(40, 0.016, 5)):
        np.testing.assert_array_equal(a, b)


def test_large_seed_is_a_valid_numpy_seed():
    assert 0 <= scene.numpy_seed(2 ** 31 + 12345) < 2 ** 32
    assert scene.numpy_seed(17) == 17
