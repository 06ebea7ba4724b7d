"""Flagship single-GPU benchmark.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

Protocol mirrors the reference's perf spec (doc/design/OmegaV0ShallowWater.md:
681-692): inertia-gravity wave, full nonlinear terms, 100 identical layers,
planar hex mesh, forward-backward stepping. Metric = grid-points * steps / s
on one GPU (grid-points = cells * layers). The reference publishes no
absolute numbers (BASELINE.json published: {}), so vs_baseline is measured
against an HBM-bandwidth speed-of-light model of the FB step
(see _roofline_estimate) at the card's published peak: 1.0 means running at
the memory roofline.

Steps run through `run_steps` in jitted segments of OMEGA_BENCH_NSTEPS;
each timed window ends in block_until_ready, and the step time is the
median (with quartiles) over OMEGA_BENCH_REPS windows. Exits non-zero
without a GPU.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks by JAX device_kind. A card missing here is an error, not
# a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (80 GB HBM3, 700 W)",
    },
}


def device_peaks(device_kind: str) -> dict:
    """Published peak rates of a card, by JAX device_kind."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to bench.PEAKS with its "
                       f"source")
    return PEAKS[device_kind]


def _roofline_estimate(ncells, nedges, nvertices, nlayers, ntracers,
                       hbm_bytes_per_s, bytes_per_el=4):
    """Crude speed-of-light step time from unavoidable HBM traffic.

    Counts each (element, layer) field the composed FB step must read or
    write at least once (~32 logical fields/step, the reference's own
    memory pattern), with gather amplification ignored (perfect cache of
    the K-contiguous rows)."""
    cell_fields = 6 + 3 * ntracers          # h, ssh, ke, div, del2div, tend...
    edge_fields = 12 + 2 * ntracers         # u, fluxes, aux, tend
    vert_fields = 5
    elems = (cell_fields * ncells + edge_fields * nedges
             + vert_fields * nvertices)
    traffic = elems * nlayers * bytes_per_el * 2.0   # read + write-ish
    return traffic / hbm_bytes_per_s


def card_line() -> str:
    """Card name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    import jax
    import jax.numpy as jnp

    from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
    from omega_tpu.infra.compile_cache import enable_compile_cache
    from omega_tpu.mesh import planar_hex_mesh
    from omega_tpu.stepping import forward_backward_step, run_steps

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    peaks = device_peaks(dev.device_kind)
    card = card_line()
    enable_compile_cache()

    dtype = jnp.float32
    nx = int(os.environ.get("OMEGA_BENCH_NX", 256))
    nlayers = int(os.environ.get("OMEGA_BENCH_NLAYERS", 100))
    ntracers = int(os.environ.get("OMEGA_BENCH_NTRACERS", 2))
    nsteps = int(os.environ.get("OMEGA_BENCH_NSTEPS", 20))
    mesh_kind = os.environ.get("OMEGA_BENCH_MESH", "planar")

    if mesh_kind == "qu240":
        # the mesh scale BASELINE actually names (QU240, ~7k cells;
        # doc/design/OmegaV0ShallowWater.md:681-692): icos24 is the
        # in-repo analogue (5,762 cells). Same sphere path below.
        os.environ.setdefault("OMEGA_BENCH_SUBDIV", "24")
        mesh_kind = "sphere"
    if mesh_kind == "icos96":
        os.environ.setdefault("OMEGA_BENCH_SUBDIV", "96")
        mesh_kind = "sphere"
    if mesh_kind == "sphere":
        # global icos mesh — the QU240-style configuration. Default:
        # patch-structured layout (streaming per-rhombus stencils,
        # mesh/icos_patches.py); OMEGA_PATCHES=0 falls back to the
        # SFC-renumbered gather path
        from omega_tpu.mesh.reorder import reorder_mesh
        from omega_tpu.mesh.spherical import spherical_icos_mesh
        n = int(os.environ.get("OMEGA_BENCH_SUBDIV", 48))
        if os.environ.get("OMEGA_PATCHES", "1") not in ("0", "false", "no"):
            from omega_tpu.mesh.icos_patches import patch_icos_mesh
            mesh = patch_icos_mesh(spherical_icos_mesh(n), n).astype(dtype)
        else:
            mesh = reorder_mesh(spherical_icos_mesh(n)).astype(dtype)
    else:
        mesh = planar_hex_mesh(nx, nx, dc=5000.0, f0=1e-4,
                               bottom_depth=1000.0).astype(dtype)
    mesh = mesh.device_put()
    # hyperviscosity scaled for the 5 km mesh: the reference default
    # ViscDel4=1.2e11 targets QU240-scale cells and is explicitly unstable
    # here (dt*nu4*lambda_max^2 > 2); nu4 ~ dx^3 scaling gives ~1e9
    tflags = {}
    for name in os.environ.get("OMEGA_BENCH_DISABLE", "").split(","):
        if name.strip():
            tflags[name.strip()] = False   # e.g. pv_advection,tracer_horz_adv
    cfg = ModelConfig(nvertlayers=nlayers, ntracers=ntracers,
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9, **tflags))

    if mesh_kind == "sphere":
        ssh = np.sin(2 * np.asarray(mesh.lat_cell)) * \
            np.cos(np.asarray(mesh.lon_cell))
        depth0 = float(np.asarray(mesh.bottom_depth)[0])
    else:
        kx = 2 * np.pi / mesh.x_period
        ky = 2 * np.pi / mesh.y_period
        ssh = np.sin(kx * np.asarray(mesh.x_cell)) * \
            np.sin(ky * np.asarray(mesh.y_cell))
        depth0 = 1000.0
    h = jnp.asarray((depth0 + ssh[:, None]) / nlayers,
                    dtype) * jnp.ones((1, nlayers), dtype)
    state = ModelState(
        h=h, u=jnp.zeros((mesh.nedges, nlayers), dtype),
        tracers=10.0 + jnp.zeros((ntracers, mesh.ncells, nlayers), dtype))

    dt = 30.0
    stepn = jax.jit(lambda s: run_steps(mesh, cfg, s, 0.0, dt, nsteps,
                                        stepper=forward_backward_step))

    # warmup / compile (timed separately, like the reference's first-step
    # timer isolation, ocn/OceanRun.cpp:48-53)
    t0 = time.perf_counter()
    out = jax.block_until_ready(stepn(state))
    compile_s = time.perf_counter() - t0

    reps = int(os.environ.get("OMEGA_BENCH_REPS", 10))
    windows = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(stepn(out))
        windows.append(time.perf_counter() - t0)
    q1, elapsed, q3 = statistics.quantiles(windows, n=4)

    if not bool(jnp.isfinite(out.h).all()):
        raise RuntimeError("benchmark produced non-finite h")

    step_time = elapsed / nsteps
    gridpoints = mesh.ncells * nlayers
    value = gridpoints * nsteps / elapsed

    sol = _roofline_estimate(mesh.ncells, mesh.nedges, mesh.nvertices,
                             nlayers, ntracers, peaks["hbm_bytes_per_s"])
    vs_baseline = sol / step_time   # 1.0 == HBM speed-of-light model

    ca = stepn.lower(state).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    xla_bytes = float(ca.get("bytes accessed", float("nan"))) / nsteps
    peak_mem = (dev.memory_stats() or {}).get("peak_bytes_in_use")

    print(f"# card={card} ncells={mesh.ncells} nlayers={nlayers} "
          f"ntracers={ntracers} step_ms median={step_time*1e3:.4f} "
          f"q1={q1 / nsteps * 1e3:.4f} q3={q3 / nsteps * 1e3:.4f} "
          f"compile={compile_s:.1f} s roofline_est={sol*1e3:.4f} ms "
          f"({peaks['source']}) xla_bytes_per_step={xla_bytes} "
          f"peak_bytes_in_use={peak_mem}", file=sys.stderr)

    # the 1000-step conservation gate at the bench scale
    # (OmegaV0ShallowWater.md:65-67): volume and tracer content to
    # machine precision over a long run
    ngate = int(os.environ.get("OMEGA_BENCH_CONSERVE", "0"))
    if ngate:
        area = np.asarray(mesh.area_cell, np.float64)[:, None]
        h0 = np.asarray(state.h, np.float64)
        tr0 = np.asarray(state.tracers, np.float64)
        vol0 = np.sum(area * h0)
        tm0 = np.sum(area[None] * tr0 * h0[None])
        st = state
        done = 0
        while done < ngate:
            st = jax.block_until_ready(stepn(st))
            done += nsteps
        h1 = np.asarray(st.h, np.float64)
        tr1 = np.asarray(st.tracers, np.float64)
        vol1 = np.sum(area * h1)
        tm1 = np.sum(area[None] * tr1 * h1[None])
        print(f"# conserve[{done} steps]: vol_drift="
              f"{(vol1 - vol0) / vol0:.3e} tracer_drift="
              f"{(tm1 - tm0) / tm0:.3e} "
              f"finite={bool(np.isfinite(h1).all())}", file=sys.stderr)

    print(json.dumps({
        "metric": "gridpoint_steps_per_sec_per_gpu",
        "value": value,
        "unit": "cells*layers*steps/s",
        "vs_baseline": vs_baseline,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
