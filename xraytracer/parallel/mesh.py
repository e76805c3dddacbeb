"""Device-mesh parallelism: the multi-chip ``ParallelRenderer``.

JAX counterpart of the reference's single parallelism story — a
shared-memory thread pool over a pixel-index list
(``std::for_each(std::execution::par_unseq)``, reference:
Src/renderer.cpp:83-99; SURVEY.md §2.5). Here the same disjoint-pixel
argument becomes sharding:

  * **pixel axis** (primary): pixels sharded over the mesh, scene
    replicated, zero collectives — each device owns its image tile
    (``shard_map_render``).
  * **spp axis** (secondary): every device renders the full image at
    different sample indices and the framebuffers are ``psum``-merged over
    ICI (``spp_parallel_render``) — useful when the image is small but spp
    is huge (the reference's volume workloads run 10240 spp,
    Src/examples/volume.cpp:25).

Multi-host: ``multihost_init`` wires ``jax.distributed``; because the RNG
is a pure function of the global pixel id and sample index (sampling/rng.py),
1-host and N-host renders are bitwise comparable (SURVEY.md §7).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def multihost_init(coordinator=None, num_processes=None, process_id=None):
    """Initialize jax.distributed when running multi-host (no-op args ->
    env-based autodetection). Safe to call once per process."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def make_mesh(n_devices=None, axis="d"):
    """1-D mesh over the first ``n_devices`` (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def replicated(mesh):
    return NamedSharding(mesh, P())


def sharded_pixels(mesh, axis="d"):
    return NamedSharding(mesh, P(axis))


def shard_map_render(
    scene, sample_once, pixel_ids, pixel_xy, spp, mesh, axis="d"
):
    """Explicit shard_map pixel-parallel render: each device runs the spp
    loop over its pixel shard; the result is the sharded framebuffer sum.
    ``sample_once`` is the kernel from ``renderer.make_sample_fn``.

    The pixel count must be pre-padded to a multiple of the mesh size
    (``renderer.render`` handles that for the NamedSharding path; this
    explicit path is the collective-free shard_map formulation).
    """
    def local(pix_ids, pix_xy):
        def body(i, carry):
            acc, rej = carry
            rad, bad, _stats = sample_once(pix_ids, pix_xy, i)
            return acc + rad, rej + bad

        n = pix_ids.shape[0]
        acc0 = jnp.zeros((n, 3))
        return jax.lax.fori_loop(0, spp, body, (acc0, jnp.int32(0)))

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    return jax.jit(fn)(pixel_ids, pixel_xy)


def spp_parallel_render(
    scene, sample_once, pixel_ids, pixel_xy, spp, mesh, axis="d"
):
    """spp-axis data parallelism: device k renders sample indices
    k, k+D, k+2D, ...; partial framebuffers are merged with a ``psum`` over
    the mesh (the ICI collective ride; SURVEY.md §2.5 "communication
    backend"). Returns the replicated (acc, n_rejected); caller divides by
    spp."""
    n_dev = mesh.shape[axis]

    def local(pix_ids, pix_xy):
        k = jax.lax.axis_index(axis)

        def body(i, carry):
            acc, rej = carry
            s = k + i * n_dev
            rad, bad, _stats = sample_once(pix_ids, pix_xy, s)
            return acc + rad, rej + bad

        n_local = spp // n_dev + jnp.int32(k < (spp % n_dev))
        acc0 = jnp.zeros((pix_ids.shape[0], 3))
        acc, rej = jax.lax.fori_loop(
            0, n_local, body, (acc0, jnp.int32(0))
        )
        return (
            jax.lax.psum(acc, axis),
            jax.lax.psum(rej, axis),
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(pixel_ids, pixel_xy)
