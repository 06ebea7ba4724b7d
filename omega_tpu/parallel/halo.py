"""Halo exchange as a shard_map collective.

The reference packs per-neighbor device buffers, posts MPI_Irecv/Isend
(device buffers under GPU-aware MPI), and unpacks in an MPI_Test polling
loop (base/Halo.h:769-915). Here the equivalent is: pack owned boundary
values with a static gather, move them between devices with XLA
collectives, and scatter into halo slots — XLA schedules the overlap, no polling loop.

Two variants:
  * `exchange`           — all_gather of the packed boundary buffers
                           (simple; O(S * boundary) traffic)
  * `exchange_permute`   — one `ppermute` per distinct neighbor rank
                           distance, sending each pair exactly its
                           boundary (the MPI_Isend/Irecv analogue; traffic
                           O(boundary)); index lists precomputed on host
                           by sharded.build_permute_lists, exactly like
                           Halo::generateExchangeLists (base/Halo.cpp:455)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exchange_permute(x, plists, axis_name: str = "x"):
    """Neighbor-pair halo refresh via ppermute rings.

    plists: sequence of (d, send_idx (Nd,), recv_dst (Nd,)) — this shard's
    rows of the per-distance exchange lists. For distance d the shard
    sends to rank (r+d) % S and receives from (r-d) % S; padded slots
    target the dummy trailing row.
    """
    for (d, nshards, send_idx, recv_dst) in plists:
        buf = jnp.take(x, send_idx, axis=-2)
        perm = [(s, (s + d) % nshards) for s in range(nshards)]
        got = jax.lax.ppermute(buf, axis_name, perm)
        x = _scatter(x, recv_dst, got)
    return x


def exchange(x, send_idx, recv_src_shard, recv_src_slot, recv_dst,
             axis_name: str = "x"):
    """Refresh halo slots of a local element array.

    x: (..., N_local, K) local array (element axis is -2)
    send_idx: (NS,) local indices of owned elements to publish
    recv_*:   (NH,) where to fetch each halo value and where to store it
    """
    buf = jnp.take(x, send_idx, axis=-2)                    # (..., NS, K)
    # gather all shards' buffers; leading axis is the shard id
    gathered = jax.lax.all_gather(buf, axis_name, axis=0)   # (S, ..., NS, K)
    # select (src_shard, src_slot) pairs for our halo elements
    vals = gathered[recv_src_shard]                         # (NH, ..., NS, K)
    vals = jnp.take_along_axis(
        vals, recv_src_slot.reshape((-1,) + (1,) * (vals.ndim - 1)), axis=-2)
    # (NH, ..., 1, K) -> (..., NH, K)
    vals = jnp.moveaxis(vals.squeeze(-2), 0, -2)
    return _scatter(x, recv_dst, vals)


def _scatter(x, dst, vals):
    """x[..., dst, :] = vals keeping leading batch dims. Any rank >= 2
    (the reference exchanges 1-5-D arrays, base/Halo.h:45; leading axes
    here are batch dims like tracer/time-level)."""
    if x.ndim == 2:
        return x.at[dst].set(vals)
    if x.ndim == 3:
        return x.at[:, dst].set(vals)
    moved = jnp.moveaxis(x, -2, 0)
    out = moved.at[dst].set(jnp.moveaxis(vals, -2, 0))
    return jnp.moveaxis(out, 0, -2)
