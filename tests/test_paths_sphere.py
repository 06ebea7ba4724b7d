"""Sphere patch-slice path against the general gather path, whole steps.

A PatchLayout icosahedral mesh runs every stencil as static slices of
halo-padded rhombus frames plus an exact gather fix-up
(ops/patch_stencil.py); the same mesh with its patch tag cleared runs the
general gather path on identical numbering. Both must give the same
trajectory to float64 roundoff for every stepper and physics set.
"""

import dataclasses

import pytest

from conftest import STEP_CASES, assert_paths_agree

from omega_tpu.mesh.icos_patches import patch_icos_mesh
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.ops import patch_stencil


@pytest.fixture(scope="module")
def meshes():
    patch = patch_icos_mesh(spherical_icos_mesh(6, bottom_depth=1000.0), 6)
    gather = dataclasses.replace(patch, patch_key=0)
    assert patch_stencil.enabled(patch) and not patch_stencil.enabled(gather)
    return patch, gather


@pytest.mark.parametrize("case", STEP_CASES)
def test_patch_matches_gather(meshes, case):
    assert_paths_agree(*meshes, case, dt=120.0, nsteps=3)
