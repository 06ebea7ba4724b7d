"""Smoke run of the ocean model on one NVIDIA GPU.

Drives the model through its normal entry points (ocn_init, ocn_run,
ocn_finalize) at full width, in float32 on the GPU, and compares every
phase with the same configuration run in float64 on the host CPU device
of the same process (the plain reference: the composed path, same steps).

Phases, in order:
  1. environment: JAX version and device, card name and power limit,
     whether PyYAML and h5py import; exits non-zero without a GPU
  2. planar flagship: the reference's performance protocol (inertia-
     gravity wave, 256 x 256 hex cells, dc 5 km, 100 layers, 2 tracers,
     forward-backward), three 20-step segments with one history write;
     reference error, conservation, then a timed steady window
  3. icos48 sphere (23,042 cells, 60 layers) on the patch-slice path
     (PatchLayout) and on the general gather path
  4. coverage on the planar flagship: RK4, split-explicit, physics (wind,
     quadratic drag, PP81 mixing) and FCT
With --four only the multi-device phase runs (after phase 1): Decomp
NShards 4 on the planar flagship (structured decomposition) and on icos48
(SFC decomposition), each against a one-card run of the same configuration.

Usage: python chip_smoke.py [--four]

Each comparison prints its error and tolerance. Any failure exits non-zero
before the last line, which is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "smoke_out"
START = "0001-01-01_00:00:00"

# f32-on-GPU against f64-on-CPU after the run, relative max error of SSH
# and tracer anomaly. Layer thickness carries the SSH signal as a small
# difference of large numbers, so f32 roundoff alone reaches about 1e-2
# of the SSH signal over tens of steps (7e-3 at 32^2 to 128^2 x 100
# layers on the CPU).
TOL_F32 = 5.0e-2
# velocity is driven by the gradient of SSH, which the stacked
# formulation forms as h_k - depth (about -990 m per layer, f32 ulp 6e-5 m)
# before differencing neighbours whose SSH differs by ~2.5e-4 m at 5 km:
# f32 quantizes the pressure gradient by tens of percent, so velocity
# error is large relative to its small amplitude early in a run (0.21 after
# 6 RK4 steps, 0.06 after 60 FB steps, NVIDIA H100 80GB HBM3 at 400 W).
# This gate catches gross failures only; the SSH, tracer and transport-
# tendency gates above and below carry the precision checks.
TOL_U = 5.0e-1
# one tendency evaluation at the final f32 state, f32 on the GPU against
# f64 on the CPU: relative max error of the transport tendencies dh and
# dtracer (divergences of fluxes, the contractions of the gather path).
# f32 stays near 1e-6; TF32 contraction operands (10-bit mantissa) land
# near 4e-3 (tests/test_precision.py). du is printed only: it carries the
# SSH cancellation above, and its terms nearly balance.
TOL_TENDENCY = 1.0e-4
# one-card f32 run against the same f32 run on four cards: summation
# order differs, so roundoff-level differences grow over the run (tens of
# ulps on 4 virtual CPU devices); a stale halo would show at O(1e-2)
TOL_SHARDED = 1.0e-3
# conservation gates of tests/test_f32.py: relative drift over the run
GATE_DRIFT = 5.0e-6


def interval(seconds: float) -> str:
    """Seconds as a 'DDDD_hh:mm:ss' time interval string."""
    s = int(round(seconds))
    return f"{s // 86400:04d}_{s % 86400 // 3600:02d}:{s % 3600 // 60:02d}:" \
           f"{s % 60:02d}"


def planar_doc(nx=256, nlayers=100, dt=30.0, nsteps=60, segment=20,
               stepper="Forward-Backward"):
    """Config document of the planar flagship: segments end on a history
    alarm every `segment` steps, and the stream writes once, at the end."""
    stop = interval(nsteps * dt)
    return {
        "TimeIntegration": {"CalendarType": "No Leap",
                            "TimeStepper": stepper,
                            "TimeStep": interval(dt), "StartTime": START,
                            "RunDuration": stop},
        "Mesh": {"Generate": {"Kind": "planar", "Nx": nx, "Ny": nx,
                              "Dc": 5000.0, "F0": 1.0e-4,
                              "BottomDepth": 1000.0}},
        "VertCoord": {"NVertLayers": nlayers},
        "Tracers": {"Base": ["Temperature", "Salinity"]},
        # nu4 ~ dx^3 for the 5 km mesh: the reference default (1.2e11)
        # targets 240 km cells and breaks the biharmonic CFL here
        "Tendencies": {"ViscDel2": 1.0e3, "ViscDel4": 1.0e9,
                       "EddyDiff2": 10.0},
        "IOStreams": {"History": {
            "UsePointerFile": False, "Filename": "hist.$SimTime",
            "Mode": "write", "IfExists": "replace", "Precision": "single",
            "Freq": int(segment * dt), "FreqUnits": "seconds",
            "UseStartEnd": True,
            "StartTime": "0001-01-01_" + interval(nsteps * dt)[5:],
            "Contents": ["SshCell"]}},
    }


def sphere_doc(subdiv=48, nlayers=60, dt=300.0, nsteps=40, segment=20,
               patch=True):
    doc = planar_doc(nlayers=nlayers, dt=dt, nsteps=nsteps, segment=segment)
    doc["Mesh"] = {"Generate": {"Kind": "sphere", "Subdivisions": subdiv,
                                "BottomDepth": 4000.0, "PatchLayout": patch}}
    doc["Tendencies"] = {"ViscDel2": 1.0e3, "ViscDel4": 1.0e12,
                         "EddyDiff2": 10.0}
    return doc


def coverage_docs(nx=256, nlayers=100, nsteps=6):
    """(name, doc): the planar flagship under each stepper and physics set
    a removed fused kernel used to serve."""
    base = lambda **kw: planar_doc(nx=nx, nlayers=nlayers, nsteps=nsteps,
                                   segment=nsteps, **kw)
    rk4 = base(stepper="RungeKutta4")
    split = base(stepper="SplitExplicit")
    split["SshFormulation"] = "Column"
    phys = base()
    phys["Tendencies"].update(WindForcingTendencyEnable=True,
                              BottomDragTendencyEnable=True,
                              BottomDragCoeff=1.0e-3)
    phys["WindStress"] = {"ConstantZonal": 0.1, "ConstantMeridional": 0.05}
    phys["VertMix"] = {"Enabled": True, "Scheme": "PP81"}
    fct = base()
    fct["Advection"] = {"FluxThicknessType": "Center",
                        "FluxTracerType": "FCT"}
    return [("rk4", rk4), ("split-explicit", split),
            ("physics wind+drag+pp81", phys), ("fct", fct)]


def initial_state(mesh, nlayers):
    """Wave in SSH, smooth temperature, uniform salinity — float64 numpy,
    rounded through float32 so both precisions start from the same
    values."""
    if mesh.on_sphere:
        # 10 m on 4 km: the same SSH-to-layer-thickness ratio as the
        # planar 1 m on 1 km
        lat, lon = np.asarray(mesh.lat_cell), np.asarray(mesh.lon_cell)
        ssh = 10.0 * np.sin(2 * lat) * np.cos(lon)
        temp = 10.0 + 5.0 * np.cos(lat)
    else:
        kx, ky = 2 * np.pi / mesh.x_period, 2 * np.pi / mesh.y_period
        x, y = np.asarray(mesh.x_cell), np.asarray(mesh.y_cell)
        ssh = np.sin(kx * x) * np.sin(ky * y)
        temp = 10.0 + np.cos(kx * x)
    depth = np.asarray(mesh.bottom_depth)
    h = np.repeat(((depth + ssh) / nlayers)[:, None], nlayers, axis=1)
    tr = np.stack([np.repeat(temp[:, None], nlayers, axis=1),
                   np.full_like(h, 35.0)])
    u = np.zeros((mesh.nedges, nlayers))
    f32 = lambda a: a.astype(np.float32).astype(np.float64)
    return f32(h), f32(u), f32(tr)


def run_model(doc, directory, keep_sharded=False):
    """ocn_init -> ocn_run -> ocn_finalize on the default device and
    precision; returns (model, initial (h, u, tr), final numpy state)."""
    import jax.numpy as jnp

    from omega_tpu.core.state import ModelState
    from omega_tpu.driver import ocn_finalize, ocn_init, ocn_run
    from omega_tpu.infra.config import Config

    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    model = ocn_init(Config("Omega", copy.deepcopy(doc)),
                     directory=str(directory))
    init = initial_state(model.mesh, model.model_cfg.nvertlayers)
    model.state = ModelState(*(jnp.asarray(a) for a in init))
    model._keep_sharded = keep_sharded
    ocn_run(model)
    placement = None
    if keep_sharded:
        placement = [sorted(d.id for d in s.data.devices())
                     for s in model.state.h.addressable_shards]
    final = ocn_finalize(model)
    out = tuple(np.asarray(a, np.float64) for a in final)
    return model, init, out, placement


def rel_error(test, ref, mesh_depth):
    """Max relative error of SSH, velocity and tracer anomaly: returns
    (max of the SSH and tracer errors, {"ssh", "u", "tracer"})."""
    (h, u, tr), (h0, u0, tr0) = test, ref
    ssh, ssh0 = h.sum(-1) - mesh_depth, h0.sum(-1) - mesh_depth
    anom0 = tr0 - tr0.mean(axis=(1, 2), keepdims=True)
    parts = {
        "ssh": np.abs(ssh - ssh0).max() / np.abs(ssh0).max(),
        "u": np.abs(u - u0).max() / np.abs(u0).max(),
        "tracer": np.abs(tr - tr0).max() / np.abs(anom0).max(),
    }
    return max(parts["ssh"], parts["tracer"]), parts


def tendency_error(model, ref_model, state):
    """Relative max error of dh, du and dtracer from one tendency
    evaluation at `state` (numpy), on `model`'s device and precision
    against `ref_model` on the CPU in f64."""
    import jax
    import jax.numpy as jnp

    from omega_tpu.core.tendencies import compute_all_tendencies

    def tend(m):
        # the FCT limiter switches on roundoff-level comparisons, so its
        # output is not continuous in precision: compare the centered
        # transport it limits
        cfg = m.model_cfg
        if cfg.flux_tracer_type == "fct":
            cfg = dataclasses.replace(cfg, flux_tracer_type="center")
        k = jax.jit(lambda h, u, tr: compute_all_tendencies(
            m.mesh, cfg, h, u, tr, 0.0, m.wind_stress))(
                *(jnp.asarray(a) for a in state))
        return [np.asarray(x, np.float64) for x in (k.dh, k.du, k.dtr)]

    test = tend(model)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        ref = tend(ref_model)
    return {k: np.abs(a - b).max() / np.abs(b).max()
            for k, a, b in zip(("dh", "du", "dtr"), test, ref)}


def conservation(mesh, init, final):
    """Relative drift of volume and of temperature mass over the run."""
    area = np.asarray(mesh.area_cell, np.float64)[:, None]
    (h0, _, tr0), (h1, _, tr1) = init, final
    vol0, vol1 = np.sum(area * h0), np.sum(area * h1)
    m0, m1 = np.sum(area * h0 * tr0[0]), np.sum(area * h1 * tr1[0])
    return abs(vol1 - vol0) / vol0, abs(m1 - m0) / m0


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def compare_phase(name, doc, tol=TOL_F32, clock=None):
    """One configuration on the GPU in f32 and on the CPU in f64."""
    import jax

    c0 = clock.seconds if clock else 0.0
    model, init, out, _ = run_model(doc, OUT / name.replace(" ", "_"))
    if clock:
        print(f"[{name}] compile_s={clock.seconds - c0:.2f} (trace, "
              f"lowering and backend compile of the GPU run)", flush=True)
    check(all(np.isfinite(a).all() for a in out),
          f"{name}: non-finite fields")
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        ref_model, _, ref, _ = run_model(
            doc, OUT / (name.replace(" ", "_") + "_ref"))
    depth = np.asarray(model.mesh.bottom_depth, np.float64)
    err, parts = rel_error(out, ref, depth)
    terr = tendency_error(model, ref_model, out)
    transport = max(terr["dh"], terr["dtr"])
    dv, dm = conservation(model.mesh, init, out)
    print(f"[{name}] steps={model.step_count} ssh/tracer err={err:.3e} "
          f"tol={tol:.1e} (ssh {parts['ssh']:.3e}, tracer "
          f"{parts['tracer']:.3e}) u err={parts['u']:.3e} tol={TOL_U:.1e} "
          f"tendency_err dh/dtr="
          f"{transport:.3e} tol={TOL_TENDENCY:.1e} (du {terr['du']:.3e}) "
          f"vol_drift={dv:.3e} "
          f"tracer_drift={dm:.3e} gate={GATE_DRIFT:.0e}", flush=True)
    check(err < tol, f"{name}: error {err:.3e} >= tolerance {tol:.1e}")
    check(parts["u"] < TOL_U, f"{name}: velocity error {parts['u']:.3e} >= "
          f"tolerance {TOL_U:.1e}")
    check(transport < TOL_TENDENCY, f"{name}: transport tendency error "
          f"{transport:.3e} >= tolerance {TOL_TENDENCY:.1e}")
    check(dv < GATE_DRIFT and dm < GATE_DRIFT,
          f"{name}: conservation drift {dv:.3e}/{dm:.3e} over the gate")
    return model


def time_steady(model, card, windows=7):
    """Median ms/step of the driver's compiled segment on a warm window."""
    import jax

    seg = model._run_ctx["segment"]
    n = 20
    st, t = model.state, 0.0
    times = []
    for _ in range(windows + 1):
        t0 = time.perf_counter()
        st = jax.block_until_ready(seg(st, t, n))
        times.append((time.perf_counter() - t0) / n * 1e3)
        t += n * model.dt
    steady = sorted(times[1:])
    q1, med, q3 = statistics.quantiles(steady, n=4)
    compiled = seg.lower(model.state, 0.0, n).compile()
    ma = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[planar timing] card={card} ms/step median={med:.4f} "
          f"q1={q1:.4f} q3={q3:.4f} windows={windows}x{n} steps; "
          f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}; "
          f"memory_analysis: argument={ma.argument_size_in_bytes} "
          f"output={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
          f"code={ma.generated_code_size_in_bytes}", flush=True)


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""
    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def sharded_phase(name, doc, method):
    """NShards=4 against one card, same configuration, both f32."""
    sharded = copy.deepcopy(doc)
    sharded["Decomp"] = {"NShards": 4, "Method": method}
    model, _, out4, placement = run_model(sharded, OUT / (name + "_4"),
                                          keep_sharded=True)
    _, _, out1, _ = run_model(doc, OUT / (name + "_1"))
    print(f"[{name} x4 {method}] shard devices={placement}", flush=True)
    check(sorted(d for p in placement for d in p) == [0, 1, 2, 3],
          f"{name}: shards do not sit one per device: {placement}")
    check(all(np.isfinite(a).all() for a in out4),
          f"{name}: non-finite fields")
    depth = np.asarray(model.mesh.bottom_depth, np.float64)
    err, parts = rel_error(out4, out1, depth)
    print(f"[{name} x4 {method}] ssh/tracer err vs one card={err:.3e} "
          f"tol={TOL_SHARDED:.1e} (ssh {parts['ssh']:.3e}, tracer "
          f"{parts['tracer']:.3e}) u err={parts['u']:.3e} tol={TOL_U:.1e}",
          flush=True)
    check(err < TOL_SHARDED and parts["u"] < TOL_U,
          f"{name}: sharded error {err:.3e} / u {parts['u']:.3e}")


def environment():
    """Phase 1. Returns (device, card line); raises without a GPU."""
    import jax

    dev = jax.devices()[0]
    print(f"jax {jax.__version__} platform={dev.platform} "
          f"kind={dev.device_kind} count={len(jax.devices())}", flush=True)
    for mod in ("yaml", "h5py"):
        try:
            __import__(mod)
            print(f"{mod}: importable")
        except ImportError:
            print(f"{mod}: missing")
    check(dev.platform == "gpu",
          f"no GPU: JAX platform is {dev.platform!r}")
    from bench import card_line, device_peaks
    card = card_line()
    print(f"nvidia-smi: {card}", flush=True)
    peaks = device_peaks(dev.device_kind)
    print(f"published peaks ({peaks['source']}): HBM "
          f"{peaks['hbm_bytes_per_s'] / 1e12:.2f} TB/s", flush=True)
    return dev, card


def ok_line(dev, count) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card decomposition phase")
    args = p.parse_args(argv)

    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # the float64 reference runs on the host CPU device
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    sys.path.insert(0, str(ROOT))
    try:
        dev, card = environment()
    except Failure as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    import jax

    from omega_tpu.infra.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)

    if args.four:
        check(len(jax.devices()) >= 4,
              f"--four needs 4 GPUs, JAX has {len(jax.devices())}")
        sharded_phase("planar", planar_doc(), "structured")
        sharded_phase("icos48", sphere_doc(patch=False), "sfc")
        print(ok_line(dev, len(jax.devices())))
        return 0

    planar = compare_phase("planar flagship fb", planar_doc(),
                           clock=CompileClock())
    time_steady(planar, card)
    del planar
    compare_phase("icos48 patch", sphere_doc(patch=True))
    compare_phase("icos48 gather", sphere_doc(patch=False))
    for name, doc in coverage_docs():
        compare_phase(name, doc)
    print(ok_line(dev, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
