"""Order-invariant global reductions (test/base/ReductionsTest.cpp).

The reference's ddSum MPI_Op contract is bit-for-bit identical R8 sums for
any partition count (base/Reductions.h:23-88). The f64 path here
(parallel/reductions.reprod_sum) is strictly order independent — binned
error-free extraction makes every partial sum exact — so these tests
assert EXACT float equality across shard counts, summation orders, and
element permutations, on raw arrays and on the full sharded energetics
pipeline (the VERDICT round-4 gate).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from omega_tpu.analysis import energetics, mean_ssh
from omega_tpu.core.config import ModelConfig, TendencyConfig
from omega_tpu.core.state import ModelState
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.parallel import reductions


def _ill_conditioned(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 12, n)
    # exact cancellation pairs plus a tiny residual tail
    x[: n // 2] = -x[n // 2: 2 * (n // 2)][::-1] * (1 + 1e-9)
    return np.float64(x)


def test_reprod_sum_accuracy_vs_fsum():
    x = _ill_conditioned(20_001)
    got = float(reductions.global_sum(jnp.asarray(x)))
    exact = math.fsum(x)
    assert abs(got - exact) <= 4 * abs(exact) * 2.0 ** -52 + 1e-300


def test_reprod_sum_permutation_invariant():
    """Stronger than the reference: ANY summation order, same bits."""
    x = _ill_conditioned(8192, seed=2)
    base = float(reductions.global_sum(jnp.asarray(x)))
    for seed in range(4):
        p = np.random.default_rng(seed).permutation(len(x))
        assert float(reductions.global_sum(jnp.asarray(x[p]))) == base


@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
def test_reprod_sum_shard_count_invariant(nshards):
    x = _ill_conditioned(4096, seed=3)
    whole = float(reductions.global_sum(jnp.asarray(x)))
    mesh = Mesh(np.array(jax.devices()[:nshards]), ("x",))

    def local(xs):
        return reductions.global_sum(xs, axis_name="x")

    sharded = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("x"),
                                    out_specs=P(), check_vma=False))
    assert float(sharded(jnp.asarray(x))) == whole  # bit-for-bit


def test_reprod_sum_padding_invariant():
    """Masked padding (what shard-local dummy rows add) changes nothing."""
    x = _ill_conditioned(1000, seed=4)
    base = float(reductions.global_sum(jnp.asarray(x)))
    for pad in (24, 1000, 5000):
        xp = np.concatenate([x, np.full(pad, 7.25)])
        mask = np.concatenate([np.ones(1000, bool), np.zeros(pad, bool)])
        got = float(reductions.global_sum(jnp.asarray(xp),
                                          mask=jnp.asarray(mask)))
        assert got == base


def _random_state(mesh, K, L, seed):
    rng = np.random.default_rng(seed)
    kx = 2 * np.pi / mesh.x_period if mesh.x_period else 1e-6
    x = np.asarray(mesh.x_cell)
    ssh = np.sin(kx * x) if not mesh.on_sphere else np.sin(
        np.asarray(mesh.lat_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / K) * jnp.ones((1, K))
    return ModelState(
        h=h, u=jnp.asarray(0.05 * rng.standard_normal((mesh.nedges, K))),
        tracers=jnp.asarray(
            10.0 + rng.standard_normal((L, mesh.ncells, K))))


@pytest.mark.parametrize("which", ["planar", "sphere"])
def test_energetics_bitwise_invariant_across_shard_counts(which):
    """The round-4 correctness gate: every energetics/global-sum value is
    EXACTLY equal at S in {1, 2, 4, 8} (and to the gathered-global
    computation) on both planar and sphere meshes."""
    from omega_tpu.parallel import decompose, shard_state
    from omega_tpu.parallel.sharded import (default_device_mesh,
                                            make_sharded_energetics)

    if which == "planar":
        mesh = planar_hex_mesh(16, 16, dc=50.0e3, f0=1.0e-4,
                               bottom_depth=1000.0)
    else:
        from omega_tpu.mesh.spherical import spherical_icos_mesh
        mesh = spherical_icos_mesh(8)
    K, L = 3, 2
    cfg = ModelConfig(nvertlayers=K, ntracers=L,
                      tendencies=TendencyConfig(visc_del2=1.0))
    st = _random_state(mesh, K, L, seed=5)

    ref_ssh = mean_ssh(mesh, cfg, st)
    ref = energetics(mesh, cfg, st, ref_ssh)

    rows = {}
    for S in (1, 2, 4, 8):
        sm = decompose(mesh, S)
        sample = make_sharded_energetics(sm, cfg, default_device_mesh(S))
        row, ssh_s = sample(shard_state(sm, st))
        rows[S] = (row, ssh_s)

    # exact equality across shard counts (the strengthened ddSum contract)
    r1, ssh1 = rows[1]
    for S in (2, 4, 8):
        rS, sshS = rows[S]
        assert sshS == ssh1, (which, S)
        for k in r1:
            assert rS[k] == r1[k], (which, S, k, rS[k], r1[k])
    # and matches the gathered-global computation exactly: the local-mesh
    # elementwise terms are bitwise identical on owned rows
    assert ssh1 == ref_ssh
    for k in ref:
        assert r1[k] == ref[k], (which, k, r1[k], ref[k])


def test_reprod32_invariance_and_accuracy():
    """The f32 path: int64-bin extraction is bit-identical across
    element permutations and shard counts, and accurate to ~1 ulp of
    the true sum (72 bins bits before the final f32 rounding)."""
    rng = np.random.default_rng(9)
    x = np.float32(rng.standard_normal(8192)
                   * 10.0 ** rng.integers(-6, 6, 8192))
    xj = jnp.asarray(x, jnp.float32)
    assert xj.dtype == jnp.float32
    base = float(reductions.global_sum(xj))
    exact = math.fsum(np.float64(x))
    assert abs(base - exact) <= 4 * abs(exact) * 2.0 ** -23 + 1e-30

    for seed in range(3):
        p = np.random.default_rng(seed).permutation(len(x))
        assert float(reductions.global_sum(jnp.asarray(x[p]))) == base

    for S in (2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:S]), ("x",))
        sharded = jax.jit(jax.shard_map(
            lambda xs: reductions.global_sum(xs, axis_name="x"),
            mesh=mesh, in_specs=P("x"), out_specs=P(), check_vma=False))
        assert float(sharded(xj)) == base, S

    # masked padding (dummy rows) changes nothing
    xp = np.concatenate([x, np.full(100, 3.25, np.float32)])
    mask = np.concatenate([np.ones(8192, bool), np.zeros(100, bool)])
    assert float(reductions.global_sum(
        jnp.asarray(xp), mask=jnp.asarray(mask))) == base
