"""Reproducible global reductions.

Rewrite of base/Reductions.h: the reference guarantees reproducible R8
global sums across partition counts by accumulating locally in
double-double arithmetic and reducing with a custom ``ddSum`` MPI_Op
(base/Reductions.h:23-88). Here the contract is made STRICTLY order
independent: f64 sums use binned error-free extraction (Rump/Ogita/Oishi
ExtractVector as organized by Demmel & Nguyen's reproducible summation) —
each element's mantissa bits are split on a fixed absolute grid derived
only from the global max |x| and constant parameters, so every per-level
partial sum is EXACT in f64 (no rounding ever happens until the final
K-term combine). Exact sums are associative, so any shard count, any
reduction-tree shape, and any summation order produce bit-identical
doubles — the same contract the reference's fixed ddSum MPI_Op provides,
without depending on the reduction order at all.

Three entry points per reduction, mirroring the reference's scalar/array/
with-multiplier overloads (Reductions.h:51,199-238,637,757):

  local:     ``dd_sum(x)``                  — compensated sum of one array
  sharded:   ``global_sum(x, axis_name)``   — inside shard_map
  host:      plain numpy fallback for init-time checks

All functions accept an optional elementwise multiplier (the product
variants) and an optional mask selecting owned elements so halo entries are
not double counted. Non-f64 inputs (the f32 path) fall back to the
double-double pairwise tree, which is reproducible per decomposition but
only ~2^-106-invariant across decompositions.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _two_sum(a, b):
    """Knuth error-free transformation: a + b = s + err exactly."""
    s = a + b
    v = s - a
    err = (a - (s - v)) + (b - v)
    return s, err


def _dd_add(x, y):
    """Add two double-double numbers (hi, lo) — associative combine used as
    the psum payload (the ddSum MPI_Op, base/Reductions.h:71-88)."""
    (xh, xl), (yh, yl) = x, y
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = _two_sum(s, e)
    return hi, lo


def dd_sum(x, multiplier=None, mask=None):
    """Compensated (double-double) sum of all elements of `x`.

    Returns the (hi, lo) pair. Accumulation is a deterministic pairwise
    tree over the flattened array, so repeated runs on the same
    decomposition are bit-for-bit. Across different shard counts the tree
    shape changes with the local length, so invariance holds only to the
    ~2^-106 double-double cancellation level (for well-conditioned sums
    that still rounds to the same double; the reference's fixed-order
    ddSum MPI_Op, base/Reductions.h:71-88, gives the strictly stronger
    order-independent guarantee). tests/test_infra.py checks the
    decomposition-invariance this provides in practice.
    """
    v = x if multiplier is None else x * multiplier
    if mask is not None:
        v = jnp.where(mask, v, jnp.zeros((), v.dtype))
    flat = v.reshape(-1)
    n = flat.shape[0]
    # pad to a power of two and pairwise tree-reduce: O(n) work, log2(n)
    # fused sweeps, deterministic association order
    p = 1 if n <= 1 else 1 << (n - 1).bit_length()
    hi = jnp.concatenate([flat, jnp.zeros(p - n, flat.dtype)])
    lo = jnp.zeros_like(hi)
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        hi, lo = _dd_add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
    return hi[0], lo[0]


# --- reproducible (order-invariant) f64 summation -----------------------
#
# Parameters: NBITS bounds the global element count (2^NBITS−1 summands),
# W is the per-level bin width. Exactness of the per-level sums needs
#   sigma_k >= 2 n max|residual_k|   and   W <= 52 − NBITS
# (partial sums are multiples of ulp(sigma)/2 bounded by sigma, hence
# representable). NBITS=32 covers 4e9 summands (1e7 cells × 100 layers ×
# ~4 fields); W=18 and K=6 give 108 bits beyond the leading one — well
# past double-double. All parameters are compile-time constants so the
# extraction grid depends ONLY on the global max, never on the sharding.
_REPROD_NBITS = 32
_REPROD_W = 18
_REPROD_K = 6


def reprod_partials(v, sigma0, levels: int = _REPROD_K):
    """Per-level exact bin sums of `v` on the grid anchored at sigma0.

    Every returned S_k is an exact multiple of ulp(sigma_k)/2 whose
    accumulation never rounded; adding partials from different shards
    (psum, any order) is also exact as long as the GLOBAL summand count
    stays under 2^NBITS. Returns a (levels,) array, high bins first.
    """
    flat = v.reshape(-1)
    parts = []
    sigma = sigma0
    for _ in range(levels):
        q = (sigma + flat) - sigma          # error-free extraction (Rump)
        parts.append(jnp.sum(q))            # exact: no rounding possible
        flat = flat - q                     # exact (Sterbenz)
        sigma = sigma * (2.0 ** -_REPROD_W)
    return jnp.stack(parts)


def _reprod_sigma0(gmax):
    """Power of two >= 2^(NBITS+1) * max|x| (a global constant; the +1
    keeps every partial sum strictly under sigma, i.e. under 2^53 ulps,
    so it stays exactly representable)."""
    _, e = jnp.frexp(gmax)                  # gmax = m * 2^e, m in [0.5, 1)
    sigma = jnp.ldexp(jnp.ones((), gmax.dtype), e + _REPROD_NBITS + 1)
    return jnp.where(gmax > 0, sigma, jnp.ones((), gmax.dtype))


def _reprod_combine(parts):
    """Final rounding: add the K exact bin sums high to low (fixed order)."""
    total = parts[0]
    for k in range(1, parts.shape[0]):
        total = total + parts[k]
    return total


def reprod_sum(x, axis_name: Optional[str] = None, multiplier=None,
               mask=None):
    """Order-invariant f64 sum (the strengthened ddSum contract)."""
    v = x if multiplier is None else x * multiplier
    if mask is not None:
        v = jnp.where(mask, v, jnp.zeros((), v.dtype))
    gmax = jnp.max(jnp.abs(v)) if v.size else jnp.zeros((), v.dtype)
    if axis_name is not None:
        gmax = jax.lax.pmax(gmax, axis_name)
    parts = reprod_partials(v, _reprod_sigma0(gmax))
    if axis_name is not None:
        parts = jax.lax.psum(parts, axis_name)   # exact => order-free
    return _reprod_combine(parts)


# f32 variant: integer-bin extraction into int32 DIGITS. The f64
# scheme's per-level float capacity (W <= 52 - log2 n) collapses at
# 24-bit mantissas, and int64 is unavailable without jax_enable_x64, so
# each error-free extract becomes exact int32 arithmetic: with
# sigma_k = 2^(e_k) >= 2^12 * 2 max|residual|, q = fl(sigma + x) - sigma
# is a multiple of the grid g = 2^(e_k - 24) with |q/g| <= 2^12, so
# q * 2^(24 - e_k) is an exactly representable 12-bit integer. Chunked
# int32 sums (chunk 2^18: partials <= 2^30, no overflow to n <= 2^34)
# are exact, hence associative; each level total travels as three
# base-2^15 int32 digits that psum exactly and are CANONICALIZED
# (carries propagated) before the final f32 combine, so any sharding's
# digit decomposition of the same value reconstructs to the same bits.
# Six 12-bit levels recover 72 bits below the leading one.
_REPROD32_LEVELS = 6
_R32_W = 12


def _digits_of(part):
    """(sum d0, sum d1, sum d2) base-2^15 digit sums of int32 values
    (arithmetic >> gives floored quotients, & gives nonneg remainders,
    so value = d0 + d1*2^15 + d2*2^30 exactly, sign carried by d2)."""
    d0 = part & 0x7fff
    r = part >> 15
    d1 = r & 0x7fff
    d2 = r >> 15
    return jnp.stack([jnp.sum(d0), jnp.sum(d1), jnp.sum(d2)])


def _reprod32_partials(v, e1, levels: int = _REPROD32_LEVELS):
    """(levels, 3) exact digit sums of f32 `v`; e1 = exponent of
    sigma0 (sigma0 = 2^e1 >= 2^12 * 2 max|x|)."""
    flat = v.reshape(-1)
    n = flat.shape[0]
    c = 1 << 18
    parts = []
    for k in range(levels):
        ek = e1 - _R32_W * k
        sigma = jnp.ldexp(jnp.ones((), v.dtype), ek)
        q = (sigma + flat) - sigma
        inv = jnp.ldexp(jnp.ones((), v.dtype), 24 - ek)
        qi = (q * inv).astype(jnp.int32)        # |qi| <= 2^12, exact
        if n > c:
            pad = (-n) % c
            qp = jnp.concatenate([qi, jnp.zeros(pad, jnp.int32)])
            part = jnp.sum(qp.reshape(-1, c), axis=1)   # <= 2^30 each
        else:
            part = jnp.sum(qi)[None]
        parts.append(_digits_of(part))
        flat = flat - q
    return jnp.stack(parts)


def _reprod32_combine(parts, e1, dtype):
    """Canonicalize digits (value-determined form) and combine in f32
    high level to low — deterministic given the level values alone."""
    total = jnp.zeros((), dtype)
    for k in range(parts.shape[0]):
        d0, d1, d2 = parts[k, 0], parts[k, 1], parts[k, 2]
        c0 = d0 & 0x7fff
        t1 = d1 + (d0 >> 15)
        c1 = t1 & 0x7fff
        c2 = d2 + (t1 >> 15)
        lvl = ((c2.astype(dtype) * 32768.0 + c1.astype(dtype)) * 32768.0
               + c0.astype(dtype))
        g = jnp.ldexp(jnp.ones((), dtype), e1 - _R32_W * k - 24)
        total = total + lvl * g
    return total


def reprod_sum_f32(x, axis_name: Optional[str] = None, multiplier=None,
                   mask=None):
    """Order-invariant f32 sum (int32 digit bins; see above)."""
    v = x if multiplier is None else x * multiplier
    if mask is not None:
        v = jnp.where(mask, v, jnp.zeros((), v.dtype))
    gmax = jnp.max(jnp.abs(v)) if v.size else jnp.zeros((), v.dtype)
    if axis_name is not None:
        gmax = jax.lax.pmax(gmax, axis_name)
    _, e = jnp.frexp(gmax)                  # gmax = m * 2^e, m in [.5,1)
    # sigma0 = 2^(e + 13) >= 2^12 * 2 * gmax (12-bit extraction window)
    e1 = jnp.where(gmax > 0, e + 13, 13)
    parts = _reprod32_partials(v, e1)
    if axis_name is not None:
        parts = jax.lax.psum(parts, axis_name)   # exact ints => free
    return _reprod32_combine(parts, e1, v.dtype)


def global_sum(x, axis_name: Optional[str] = None, multiplier=None,
               mask=None):
    """Reproducible global sum.

    f64 inputs use the order-invariant binned extraction, f32 the
    order-invariant int64-bin extraction: results are bit-for-bit
    identical across shard counts, reduction orders, and element
    permutations, matching (exceeding) the reference ddSum contract
    (base/Reductions.h:23-88). Other dtypes use the double-double
    pairwise tree + ddSum-combine of per-shard partials. Inside
    shard_map pass `axis_name`; on a single device leave it None.
    """
    dt = jnp.result_type(x)
    if dt == jnp.float64:
        return reprod_sum(x, axis_name, multiplier, mask)
    if dt == jnp.float32:
        return reprod_sum_f32(x, axis_name, multiplier, mask)
    hi, lo = dd_sum(x, multiplier, mask)
    if axis_name is not None:
        # psum the pair; ddSum over <=8 well-separated partials keeps the
        # compensated bits — combine hi and lo separately then renormalize
        hi_all = jax.lax.all_gather(hi, axis_name)
        lo_all = jax.lax.all_gather(lo, axis_name)
        acc = (jnp.zeros((), hi.dtype), jnp.zeros((), hi.dtype))
        for i in range(hi_all.shape[0]):
            acc = _dd_add(acc, (hi_all[i], lo_all[i]))
        hi, lo = acc
    return hi + lo


def global_min(x, axis_name: Optional[str] = None, mask=None):
    """globalMinVal (base/Reductions.h:637)."""
    v = jnp.where(mask, x, jnp.inf) if mask is not None else x
    m = jnp.min(v)
    if axis_name is not None:
        m = jax.lax.pmin(m, axis_name)
    return m


def global_max(x, axis_name: Optional[str] = None, mask=None):
    """globalMaxVal (base/Reductions.h:757)."""
    v = jnp.where(mask, x, -jnp.inf) if mask is not None else x
    m = jnp.max(v)
    if axis_name is not None:
        m = jax.lax.pmax(m, axis_name)
    return m
