"""omega_tpu — an ocean dynamical core in JAX.

A from-scratch JAX implementation of the capabilities of E3SM-Project
Omega (the Ocean Model for E3SM Global Applications): the layered nonlinear
shallow-water equations plus tracer advection-diffusion, discretized with the
TRiSK finite-volume scheme (Thuburn 2009 / Ringler 2010) on MPAS-format
unstructured Voronoi meshes.

Design (written for accelerators, not a port):
  * fields are (elements, layers) arrays with the layer axis contiguous
  * all stencils are weighted gathers over static padded connectivity
  * SPMD via jax.sharding.Mesh + shard_map with precomputed halo index lists
  * host-side exact-rational time manager; device-side pure step functions

Reference parity map (file:line cites refer to the reference repo
/root/reference/components/omega unless noted):
  base/     -> omega_tpu.parallel (decomp/halo/reductions)
  infra/    -> omega_tpu.infra (config/time/fields/logging/timers)
  ocn/      -> omega_tpu.mesh, omega_tpu.ops, omega_tpu.core
  timeStepping/ -> omega_tpu.stepping
  drivers/  -> omega_tpu.driver
"""

__version__ = "0.1.0"

from omega_tpu import constants  # noqa: F401
