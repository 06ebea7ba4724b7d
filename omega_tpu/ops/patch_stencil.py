"""Streaming stencil execution on patch-structured icosahedral meshes.

Counterpart of ops/structured.py for the sphere: meshes renumbered by
mesh/icos_patches.py expose every TRiSK stencil as static SLICES of a
halo-padded per-patch frame (T, 10, n+2W, n+2W, K) with per-position
weight planes, plus a tiny exact gather fix-up (pentagons, seams,
poles).  A row gather of an (N, K) field reads through an index array;
this path replaces the general sphere gather path with:

  1. one reshape paste of the class-major grid ids (free),
  2. ONE small gather+scatter filling halos / seam holes (O(n) rows
     instead of O(n^2) full-field gather rows),
  3. a sum of statically-sliced, weight-plane-multiplied terms that XLA
     fuses into one streaming sweep,
  4. a fix-up scatter reproducing the exact gather-path value on the
     few destinations the lattice cannot serve.

Numerics match the gather path on every row (the fix-up recipe IS the
gather recipe), up to float summation order on the lattice rows.

Reference parity: operators unchanged (ocn/HorzOperators.h:9-187); the
layout work replaces the locality the reference buys with METIS + CPU
blocking (base/Decomp.cpp:968).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from omega_tpu.mesh import icos_patches as ip
from omega_tpu.mesh.icos_patches import HALO, NPER


def enabled(mesh) -> bool:
    if os.environ.get("OMEGA_PATCHES", "1") in ("0", "false", "no"):
        return False
    return getattr(mesh, "patch_key", 0) != 0 and ip.get_info(mesh) is not None


def table(mesh, name: str):
    info = ip.get_info(mesh)
    return info.tables.get(name) if info is not None else None


def to_frame(info: ip.PatchInfo, src_class: str, field):
    """(N_src, K) -> (T, 10, S, S, K) halo-padded patch frame."""
    T = NPER[src_class]
    n, NG = info.n, info.ngrid
    S = n + 2 * HALO
    K = field.shape[-1]
    grid = field[:T * NG].reshape(T, 10, n, n, K)
    padded = jnp.pad(grid, ((0, 0), (0, 0), (HALO, HALO), (HALO, HALO),
                            (0, 0)))
    pos, src = info.fills[src_class]
    if pos.size:
        flat = padded.reshape(T * 10 * S * S, K)
        flat = flat.at[pos].set(field[src])
        padded = flat.reshape(T, 10, S, S, K)
    return padded


def _apply2d(info: ip.PatchInfo, tab: ip.PatchTable, field):
    n, NG = info.n, info.ngrid
    S = n + 2 * HALO
    K = field.shape[-1]
    Td = NPER[tab.dst_class]
    F = to_frame(info, tab.src_class, field)
    outs = [None] * Td
    for (td, ts, da, db, wpl) in tab.entries:
        sl = F[ts, :, HALO + db:HALO + db + n, HALO + da:HALO + da + n, :]
        term = jnp.asarray(wpl, field.dtype)[..., None] * sl
        outs[td] = term if outs[td] is None else outs[td] + term
    zero = jnp.zeros((10, n, n, K), field.dtype)
    flat = jnp.stack([o if o is not None else zero
                      for o in outs]).reshape(Td * NG, K)
    tail = tab.n_dst - Td * NG
    if tail:
        flat = jnp.concatenate([flat, jnp.zeros((tail, K), field.dtype)])
    if tab.fix_ids.size:
        # full precision: a f32 dot at default precision may run in
        # TF32 on GPU tensor cores
        g = jnp.take(field, tab.fix_idx, axis=0)          # (F, S, K)
        vals = jnp.einsum("fs,fsk->fk",
                          jnp.asarray(tab.fix_w, field.dtype), g,
                          precision=jax.lax.Precision.HIGHEST)
        flat = flat.at[tab.fix_ids].set(vals)
    return flat


def apply_patch_stencil(mesh, tab: ip.PatchTable, field):
    """out[d] = sum_s w[d, s] * field[idx[d, s]] via patch slices.

    field: (..., N_src, K) -> (..., N_dst, K)."""
    info = ip.get_info(mesh)
    if field.ndim == 2:
        return _apply2d(info, tab, field)
    lead = field.shape[:-2]
    flat = field.reshape((-1,) + field.shape[-2:])
    out = jax.vmap(lambda f: _apply2d(info, tab, f))(flat)
    return out.reshape(lead + out.shape[-2:])
