"""Planar roll path against the general gather path, whole steps.

The uniform planar mesh runs every stencil as lattice rolls
(ops/structured.py); the same mesh with its structure tag cleared runs
the general gather path. Both must give the same trajectory to float64
roundoff for every stepper and physics set.
"""

import dataclasses

import pytest

from conftest import STEP_CASES, assert_paths_agree

from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.ops import structured


@pytest.fixture(scope="module")
def meshes():
    roll = planar_hex_mesh(12, 16, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    gather = dataclasses.replace(roll, structured_nx=0)
    assert structured.enabled(roll) and not structured.enabled(gather)
    return roll, gather


@pytest.mark.parametrize("case", STEP_CASES)
def test_roll_matches_gather(meshes, case):
    assert_paths_agree(*meshes, case, dt=30.0, nsteps=4)
