"""Flat device-resident scene tables.

JAX counterpart of the reference's pointer-linked scene graph
(``Scene`` holding ``unordered_map<string, Object>`` with raw Material /
AreaLight / Medium pointers, reference: Src/scene.h:43-46,
Src/primitive.h:40-95). Polymorphism-by-vtable becomes integer type ids +
index tables: every primitive row carries an object id, and per-object rows
carry indices into the material / area-light / medium tables (-1 = none,
mirroring the reference's null-pointer checks ``hasSurface/hasAreaLight/
hasMedium``, Src/primitive.h:52-62).

All tables are padded (triangles to a multiple of the intersection chunk,
everything else to >= 1 row) with sentinel rows whose object/owner id is -1,
so every kernel is shape-static.
"""

from typing import NamedTuple

import jax.numpy as jnp

# material type ids (reference enum: Src/geometry.h:703)
MAT_LAMBERT = 0
MAT_MIRROR = 1   # reference declares Metals but ships no class; live here
MAT_GLASS = 2    # reference declares Glass but ships no class; live here

# area light type ids (reference: Src/light.h:79-210)
AL_TRIANGLE = 0
AL_QUAD = 1
AL_SPHERE = 2

# delta light type ids (reference: Src/light.h:28-49)
DL_POINT = 0
DL_DISTANT = 1

# medium type ids (reference: Src/medium.h:122-387)
MED_HOMOG_MIS = 0
MED_HOMOG_ACHROMATIC = 1
MED_HOMOG_NOMIS = 2
MED_HETEROGENEOUS = 3


class SceneTables(NamedTuple):
    """The whole scene as a pytree of arrays (replicated across devices)."""

    # triangles: v0 + edge vectors (Möller-Trumbore form), per-vertex
    # normals/uvs, owning object id
    tri_v0: jnp.ndarray   # (T, 3)
    tri_e1: jnp.ndarray   # (T, 3)
    tri_e2: jnp.ndarray   # (T, 3)
    tri_n0: jnp.ndarray   # (T, 3)
    tri_n1: jnp.ndarray   # (T, 3)
    tri_n2: jnp.ndarray   # (T, 3)
    tri_uv0: jnp.ndarray  # (T, 2)
    tri_uv1: jnp.ndarray  # (T, 2)
    tri_uv2: jnp.ndarray  # (T, 2)
    tri_obj: jnp.ndarray  # (T,) int32
    # packed per-triangle record so the hot surface-record path does ONE
    # gather instead of many:
    # cols 0-8   n0 n1 n2        (vertex normals)
    # cols 9-14  uv0 uv1 uv2
    # cols 15-23 v0 e1 e2
    # cols 24-27 obj, light, medium, mat_type   (ints as float32, exact)
    # col  28    ior
    # cols 29-31 albedo
    # The relational obj -> material/light/medium indirection is PRE-JOINED
    # here (denormalized) so shading needs no further table gathers.
    tri_rec: jnp.ndarray  # (T, 32)

    # analytic spheres
    sph_center: jnp.ndarray  # (S, 3)
    sph_radius: jnp.ndarray  # (S,)
    sph_obj: jnp.ndarray     # (S,) int32

    # medium bounding boxes
    box_min: jnp.ndarray  # (B, 3)
    box_max: jnp.ndarray  # (B, 3)
    box_obj: jnp.ndarray  # (B,) int32

    # objects: indices into the tables below, -1 = none
    obj_mat: jnp.ndarray     # (O,) int32
    obj_light: jnp.ndarray   # (O,) int32
    obj_medium: jnp.ndarray  # (O,) int32

    # materials
    mat_type: jnp.ndarray    # (M,) int32
    mat_albedo: jnp.ndarray  # (M, 3)
    mat_ior: jnp.ndarray     # (M,)

    # area lights
    al_type: jnp.ndarray    # (L,) int32
    al_le: jnp.ndarray      # (L, 3)
    al_v0: jnp.ndarray      # (L, 3) triangle/quad corner
    al_e1: jnp.ndarray      # (L, 3)
    al_e2: jnp.ndarray      # (L, 3)
    al_ng: jnp.ndarray      # (L, 3) unnormalized cross(e1, e2)
    al_center: jnp.ndarray  # (L, 3) sphere lights
    al_radius: jnp.ndarray  # (L,)

    # delta lights
    dl_type: jnp.ndarray       # (D,) int32
    dl_pos: jnp.ndarray        # (D, 3)
    dl_dir: jnp.ndarray        # (D, 3) unit, for distant lights
    dl_color: jnp.ndarray      # (D, 3)
    dl_intensity: jnp.ndarray  # (D,)

    # participating media
    med_type: jnp.ndarray          # (Md,) int32
    med_g: jnp.ndarray             # (Md,)
    med_sigma_a: jnp.ndarray       # (Md, 3) homog sigma_a / hetero absorption color
    med_sigma_s: jnp.ndarray       # (Md, 3) homog sigma_s / hetero scattering color
    med_majorant: jnp.ndarray      # (Md,) heterogeneous majorant
    med_density_mult: jnp.ndarray  # (Md,)

    # dense density grid (single per scene; heterogeneous media reference it)
    grid_density: jnp.ndarray  # (Nx, Ny, Nz)
    grid_min: jnp.ndarray      # (3,)
    grid_max: jnp.ndarray      # (3,)
    # corner-packed grid for the tracking hot loop: row c of (Nx*Ny*Nz, 8)
    # holds the 8 cell corners (edge-clamped), so a trilinear lookup is ONE
    # row gather instead of eight scalar gathers
    grid_packed: jnp.ndarray   # (Nx*Ny*Nz, 8)
    # block-max supergrid for piecewise-majorant tracking (media.py): block
    # (bx,by,bz) holds the max DENSITY over every trilinear lookup whose
    # continuous index falls in [b*B, (b+1)*B] (one-ring corner overlap, so
    # it is a true upper bound). Flat x-major; up to 8 blocks per axis so
    # the flat table stays one-hot-matmul sized (<= 512 rows). Derived
    # buffer (like grid_packed): stale after grid_density edits.
    grid_super: jnp.ndarray       # (nbx*nby*nbz,) block max density
    grid_super_nb: jnp.ndarray    # (3,) int32 block counts per axis
    grid_super_bsize: jnp.ndarray # (3,) block edge length in index units

    @property
    def n_area_lights(self):
        """Count of real (non-sentinel) area lights — static at trace time."""
        return int((self.al_type >= 0).sum())  # only valid outside jit

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]


def rejoin_appearance(tables: "SceneTables") -> "SceneTables":
    """Recompute tri_rec's denormalized appearance columns (24-31) from the
    relational tables, differentiably.

    The builder pre-joins obj -> material/light/medium data into ``tri_rec``
    for gather-free shading; when a differentiable pipeline overrides
    relational leaves (``tables._replace(mat_albedo=...)``) the join must be
    redone with jnp ops so gradients flow into the real parameters."""
    import jax.numpy as jnp

    oix = jnp.maximum(tables.tri_obj, 0)
    has_obj = tables.tri_obj >= 0
    mat = jnp.where(has_obj, tables.obj_mat[oix], -1)
    mix = jnp.maximum(mat, 0)
    has_mat = mat >= 0
    mtype = jnp.where(has_mat, tables.mat_type[mix], -1)
    ior = jnp.where(has_mat, tables.mat_ior[mix], 1.0)
    albedo = jnp.where(has_mat[:, None], tables.mat_albedo[mix], 0.0)
    light = jnp.where(has_obj, tables.obj_light[oix], -1)
    medium = jnp.where(has_obj, tables.obj_medium[oix], -1)
    f32 = jnp.float32
    rec = jnp.concatenate(
        [
            tables.tri_rec[:, :24],
            tables.tri_obj.astype(f32)[:, None],
            light.astype(f32)[:, None],
            medium.astype(f32)[:, None],
            mtype.astype(f32)[:, None],
            ior[:, None],
            albedo,
        ],
        axis=1,
    )
    return tables._replace(tri_rec=rec)
