"""Imperative scene builder -> frozen flat tables.

JAX counterpart of the reference's scene-assembly API (``loadObj`` /
``addObj`` / ``addDeltaLight`` / ``addAreaLight``, reference:
Src/scene.cpp:46-188). Host-side numpy only; ``build()`` freezes everything
into jnp `SceneTables`.

The reference's "lights manufacture their own geometry" pattern
(``AreaLight::makeObject`` injecting emissive meshes/spheres into the object
map, Src/light.cpp:32-41,70-97, Src/scene.cpp:166-170) becomes: adding an
area light appends BOTH a light-table row and emissive rows in the
triangle/sphere tables. Media likewise inject their bounding box
(``Medium::makeObject`` -> BoxMesh, Src/medium.h:129-131).
"""

import numpy as np
import jax.numpy as jnp

from ..constants import PI
from .tables import (
    AL_QUAD,
    AL_SPHERE,
    AL_TRIANGLE,
    DL_DISTANT,
    DL_POINT,
    MAT_GLASS,
    MAT_LAMBERT,
    MAT_MIRROR,
    MED_HETEROGENEOUS,
    MED_HOMOG_ACHROMATIC,
    MED_HOMOG_MIS,
    MED_HOMOG_NOMIS,
    SceneTables,
)

def supergrid_max(gd, super_nb, super_bs):
    """Block-max supergrid over a dense grid: block (bx,by,bz) is the max
    over the inclusive corner range [floor(b*B), min(ceil((b+1)*B), n-1)]
    (one-ring overlap bounds every trilinear value in the block). Shared by
    the SceneBuilder and tools/majorant_stats.py."""
    gd = np.asarray(gd, np.float32)
    sg = np.zeros(tuple(int(v) for v in super_nb), np.float32)
    for bx in range(int(super_nb[0])):
        x0 = int(np.floor(bx * super_bs[0]))
        x1 = min(int(np.ceil((bx + 1) * super_bs[0])), gd.shape[0] - 1)
        for by in range(int(super_nb[1])):
            y0 = int(np.floor(by * super_bs[1]))
            y1 = min(int(np.ceil((by + 1) * super_bs[1])), gd.shape[1] - 1)
            for bz in range(int(super_nb[2])):
                z0 = int(np.floor(bz * super_bs[2]))
                z1 = min(
                    int(np.ceil((bz + 1) * super_bs[2])), gd.shape[2] - 1
                )
                sg[bx, by, bz] = gd[
                    x0:x1 + 1, y0:y1 + 1, z0:z1 + 1
                ].max(initial=0.0)
    return sg


def _morton_order(points):
    """Argsort of 3-D points along a 30-bit Morton (Z-order) curve over
    their bounding box — groups spatially-near triangles into the same
    sweep chunks. Pure host-side numpy."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    ext = np.maximum(p.max(axis=0) - lo, 1e-30)
    q = np.minimum(((p - lo) / ext * 1023.0).astype(np.uint32), 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _tri_pad(n):
    """Triangle table padding: multiples of 8 up to 128 (a single sweep
    chunk), then multiples of 128 (``intersect_triangles`` scans 128-row
    chunks). Small scenes pay only for their rounded-up rows (Cornell: 36
    real triangles -> 40 rows, not 64)."""
    if n <= 128:
        return max(8, ((n + 7) // 8) * 8)
    return ((n + 127) // 128) * 128


class SceneBuilder:
    def __init__(self):
        self._tris = []      # (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, obj)
        self._spheres = []   # (center, radius, obj)
        self._boxes = []     # (bmin, bmax, obj)
        self._objects = []   # (mat, light, medium)
        self._materials = []  # (type, albedo, ior)
        self._alights = []   # dict rows
        self._dlights = []   # dict rows
        self._media = []     # dict rows
        self._grid = None    # (density, gmin, gmax)

    # -- materials -------------------------------------------------------
    def add_lambert(self, albedo):
        """Lambert BRDF albedo/pi (reference: Src/material.h:28-77)."""
        self._materials.append((MAT_LAMBERT, np.asarray(albedo, np.float32), 1.0))
        return len(self._materials) - 1

    def add_mirror(self, tint=(0.8, 0.8, 0.8)):
        """Perfect mirror. The reference declares MaterialType::Metals but has
        no class; the Whitted integrator multiplies throughput by 0.8
        (Src/integrator.h:344-353) — that factor is this material's tint."""
        self._materials.append((MAT_MIRROR, np.asarray(tint, np.float32), 1.0))
        return len(self._materials) - 1

    def add_glass(self, ior=1.3, tint=(0.9, 0.9, 0.9)):
        """Fresnel glass. ior 1.3 and the 0.9 throughput factor match the
        reference's hard-coded Whitted Glass branch (Src/integrator.h:355-381)."""
        self._materials.append((MAT_GLASS, np.asarray(tint, np.float32), float(ior)))
        return len(self._materials) - 1

    # -- objects / geometry ----------------------------------------------
    def _new_object(self, mat=-1, light=-1, medium=-1):
        self._objects.append([mat, light, medium])
        return len(self._objects) - 1

    def add_mesh(self, vertices, normals=None, uvs=None, material=-1, light=-1):
        """Add a triangle soup: vertices (T,3,3); optional per-vertex normals
        (T,3,3) and uvs (T,3,2). Missing normals -> flat geometric normals,
        missing uvs -> barycentric corners (reference: Src/scene.cpp:123-137)."""
        vertices = np.asarray(vertices, np.float32)
        t = vertices.shape[0]
        if normals is None:
            e1 = vertices[:, 1] - vertices[:, 0]
            e2 = vertices[:, 2] - vertices[:, 0]
            n = np.cross(e1, e2)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            normals = np.repeat(n[:, None, :], 3, axis=1)
        else:
            normals = np.asarray(normals, np.float32)
        if uvs is None:
            uvs = np.tile(
                np.asarray([[0, 0], [1, 0], [0, 1]], np.float32), (t, 1, 1)
            )
        else:
            uvs = np.asarray(uvs, np.float32)
        if t > 512:
            # Morton-order large meshes so 128-triangle sweep chunks are
            # spatially compact. Small meshes keep insertion order
            # (golden-image tie-break safety).
            order = _morton_order(vertices.mean(axis=1))
            vertices = vertices[order]
            normals = normals[order]
            uvs = uvs[order]
        obj = self._new_object(mat=material, light=light)
        for i in range(t):
            self._tris.append(
                (
                    vertices[i, 0], vertices[i, 1], vertices[i, 2],
                    normals[i, 0], normals[i, 1], normals[i, 2],
                    uvs[i, 0], uvs[i, 1], uvs[i, 2],
                    obj,
                )
            )
        return obj

    def add_sphere(self, center, radius, material=-1, light=-1):
        obj = self._new_object(mat=material, light=light)
        self._spheres.append(
            (np.asarray(center, np.float32), float(radius), obj)
        )
        return obj

    def add_sphere_mesh(self, center, radius, n_theta, n_phi, material=-1, light=-1):
        """Lat-long triangulated sphere (reference: Src/primitive.cpp:170-205
        ``SphereMesh::Triangulate``)."""
        center = np.asarray(center, np.float32)
        verts, norms = [], []
        for i in range(n_theta + 1):
            theta = PI * i / n_theta
            for j in range(n_phi + 1):
                phi = 2 * PI * j / n_phi
                v = np.array(
                    [
                        np.sin(theta) * np.sin(phi),
                        np.cos(theta),
                        np.sin(theta) * np.cos(phi),
                    ],
                    np.float32,
                )
                verts.append(center + radius * v)
                norms.append(v)
        tris, tnorms = [], []
        for i in range(n_theta):
            for j in range(n_phi):
                first = i * (n_phi + 1) + j
                second = first + n_phi + 1
                tris.append([verts[first], verts[second], verts[first + 1]])
                tnorms.append([norms[first], norms[second], norms[first + 1]])
                tris.append([verts[second], verts[second + 1], verts[first + 1]])
                tnorms.append([norms[second], norms[second + 1], norms[first + 1]])
        return self.add_mesh(
            np.asarray(tris), np.asarray(tnorms), material=material, light=light
        )

    # -- delta lights ------------------------------------------------------
    def add_point_light(self, position, color=(1.0, 1.0, 1.0), intensity=100.0):
        """(reference: Src/light.cpp:115-128)"""
        self._dlights.append(
            dict(
                type=DL_POINT,
                pos=np.asarray(position, np.float32),
                dir=np.zeros(3, np.float32),
                color=np.asarray(color, np.float32),
                intensity=float(intensity),
            )
        )

    def add_distant_light(self, direction, color=(1.0, 1.0, 1.0), intensity=1.0):
        """(reference: Src/light.cpp:130-142); direction = travel direction of
        the light (default (0,0,-1) transformed by l2w in the reference)."""
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        self._dlights.append(
            dict(
                type=DL_DISTANT,
                pos=np.zeros(3, np.float32),
                dir=d,
                color=np.asarray(color, np.float32),
                intensity=float(intensity),
            )
        )

    # -- area lights (light row + emissive geometry) ----------------------
    def _push_alight(self, row):
        self._alights.append(row)
        return len(self._alights) - 1

    def add_triangle_light(self, v0, v1, v2, le):
        """(reference: Src/light.cpp:6-47 + makeObject :32-41)"""
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        e1, e2 = v1 - v0, v2 - v0
        ng = np.cross(e1, e2)
        lid = self._push_alight(
            dict(
                type=AL_TRIANGLE,
                le=np.asarray(le, np.float32),
                v0=v0, e1=e1, e2=e2, ng=ng,
                center=np.zeros(3, np.float32), radius=0.0,
            )
        )
        n = ng / np.linalg.norm(ng)
        self.add_mesh(
            np.asarray([[v0, v1, v2]]),
            np.asarray([[n, n, n]]),
            light=lid,
        )
        return lid

    def add_quad_light(self, v0, v1, v2, le):
        """Quad spanned by v0 + e1*u + e2*v (reference: Src/light.cpp:49-82).
        Emissive geometry: two triangles (v0,v1,v2) and (v1,v3,v2)."""
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        e1, e2 = v1 - v0, v2 - v0
        ng = np.cross(e1, e2)
        lid = self._push_alight(
            dict(
                type=AL_QUAD,
                le=np.asarray(le, np.float32),
                v0=v0, e1=e1, e2=e2, ng=ng,
                center=np.zeros(3, np.float32), radius=0.0,
            )
        )
        v3 = v0 + e1 + e2
        n = ng / np.linalg.norm(ng)
        self.add_mesh(
            np.asarray([[v0, v1, v2], [v1, v3, v2]]),
            np.asarray([[n, n, n], [n, n, n]]),
            light=lid,
        )
        return lid

    def add_sphere_light(self, center, radius, le):
        """(reference: Src/light.h:129-198 + makeObject Src/light.cpp:93-97)"""
        lid = self._push_alight(
            dict(
                type=AL_SPHERE,
                le=np.asarray(le, np.float32),
                v0=np.zeros(3, np.float32),
                e1=np.zeros(3, np.float32),
                e2=np.zeros(3, np.float32),
                ng=np.zeros(3, np.float32),
                center=np.asarray(center, np.float32),
                radius=float(radius),
            )
        )
        self.add_sphere(center, radius, light=lid)
        return lid

    # -- media (medium row + bounding box object) --------------------------
    def _push_medium(self, row, bmin, bmax):
        mid = len(self._media)
        self._media.append(row)
        obj = self._new_object(medium=mid)
        self._boxes.append(
            (np.asarray(bmin, np.float32), np.asarray(bmax, np.float32), obj)
        )
        return mid

    def add_homogeneous_medium(self, g, sigma_a, sigma_s, bmin, bmax,
                               variant="mis"):
        """Homogeneous medium in an AABB (reference: Src/medium.h:122-277;
        variant selects MIS / achromatic / no-MIS sampling)."""
        t = {
            "mis": MED_HOMOG_MIS,
            "achromatic": MED_HOMOG_ACHROMATIC,
            "nomis": MED_HOMOG_NOMIS,
        }[variant]
        return self._push_medium(
            dict(
                type=t, g=float(g),
                sigma_a=np.asarray(sigma_a, np.float32) * np.ones(3, np.float32),
                sigma_s=np.asarray(sigma_s, np.float32) * np.ones(3, np.float32),
                majorant=0.0, density_mult=1.0,
            ),
            bmin, bmax,
        )

    def set_density_grid(self, density, bmin, bmax):
        """Dense density grid shared by heterogeneous media (replaces the
        reference's OpenVDB grid, Src/grid.h:22-84)."""
        self._grid = (
            np.asarray(density, np.float32),
            np.asarray(bmin, np.float32),
            np.asarray(bmax, np.float32),
        )

    def add_heterogeneous_medium(self, g, absorption, scattering,
                                 density_mult=1.0):
        """Null-collision heterogeneous medium over the scene density grid
        (reference: Src/medium.cpp:5-17 constructor computes the majorant from
        the max density; the box is the grid's bounds, Src/medium.cpp:20-23)."""
        if self._grid is None:
            raise ValueError("set_density_grid() before adding a heterogeneous medium")
        density, bmin, bmax = self._grid
        max_density = float(density.max()) * float(density_mult)
        absorption = np.asarray(absorption, np.float32) * np.ones(3, np.float32)
        scattering = np.asarray(scattering, np.float32) * np.ones(3, np.float32)
        majorant = float(((absorption + scattering) * max_density).max())
        return self._push_medium(
            dict(
                type=MED_HETEROGENEOUS, g=float(g),
                sigma_a=absorption, sigma_s=scattering,
                majorant=majorant, density_mult=float(density_mult),
            ),
            bmin, bmax,
        )

    # -- freeze ------------------------------------------------------------
    def build(self) -> SceneTables:
        f32 = np.float32

        def pad_rows(rows, blank, n_min=1, multiple=1):
            n = max(len(rows), n_min)
            if multiple > 1:
                n = ((n + multiple - 1) // multiple) * multiple
            out = list(rows) + [blank] * (n - len(rows))
            return out

        blank_tri = (
            np.zeros(3, f32),) * 3 + (np.zeros(3, f32),) * 3 + (
            np.zeros(2, f32),) * 3 + (-1,)
        n_tri_padded = _tri_pad(max(len(self._tris), 1))
        tris = pad_rows(self._tris, blank_tri, n_min=n_tri_padded)

        def col(rows, i):
            return np.stack([np.asarray(r[i], f32) for r in rows])

        tri_v0 = col(tris, 0)
        tri_e1 = col(tris, 1) - tri_v0
        tri_e2 = col(tris, 2) - tri_v0

        sphs = pad_rows(self._spheres, (np.zeros(3, f32), 0.0, -1))
        boxes = pad_rows(
            self._boxes, (np.full(3, 1.0, f32), np.full(3, -1.0, f32), -1)
        )
        objs = self._objects or [[-1, -1, -1]]
        mats = self._materials or [(MAT_LAMBERT, np.zeros(3, f32), 1.0)]
        blank_al = dict(
            type=-1, le=np.zeros(3, f32), v0=np.zeros(3, f32),
            e1=np.zeros(3, f32), e2=np.zeros(3, f32), ng=np.zeros(3, f32),
            center=np.zeros(3, f32), radius=0.0,
        )
        als = self._alights or [blank_al]
        blank_dl = dict(
            type=-1, pos=np.zeros(3, f32), dir=np.zeros(3, f32),
            color=np.zeros(3, f32), intensity=0.0,
        )
        dls = self._dlights or [blank_dl]
        blank_med = dict(
            type=-1, g=0.0, sigma_a=np.zeros(3, f32), sigma_s=np.zeros(3, f32),
            majorant=1.0, density_mult=0.0,
        )
        meds = self._media or [blank_med]
        grid = self._grid or (
            np.zeros((1, 1, 1), f32), np.zeros(3, f32), np.ones(3, f32)
        )
        # corner-packed grid: row (i,j,k) = 8 corners [i+dx, j+dy, k+dz] with
        # edge clamping; bit layout d = dx*4 + dy*2 + dz. Gated by size:
        # the packed table is 8x the grid in device memory (~131 MB at
        # 160^3, ~537 MB at 256^3). Larger grids ship an all-zero 1-row
        # table and media.density_lookup gathers the 8 corners from the
        # dense grid instead (use_packed=False semantics)
        gd = grid[0]
        if gd.size <= (160 ** 3):
            packed = np.empty(gd.shape + (8,), f32)
            for d in range(8):
                dx, dy, dz = (d >> 2) & 1, (d >> 1) & 1, d & 1
                sl = gd[
                    np.minimum(np.arange(gd.shape[0]) + dx, gd.shape[0] - 1)
                ][:, np.minimum(np.arange(gd.shape[1]) + dy,
                                gd.shape[1] - 1)
                ][:, :, np.minimum(np.arange(gd.shape[2]) + dz,
                                   gd.shape[2] - 1)]
                packed[..., d] = sl
            packed = packed.reshape(-1, 8)
        else:
            packed = None
        # block-max supergrid for piecewise-majorant tracking (media.py):
        # <= 8 blocks per axis; block (bx,by,bz) bounds every trilinear
        # value with continuous index in [b*B, (b+1)*B] -> max over the
        # corner range [b*B, min((b+1)*B, n-1)] inclusive (one-ring overlap)
        super_nb = np.minimum(
            np.maximum(np.asarray(gd.shape, np.int64) - 1, 1), 8
        ).astype(np.int32)
        super_bs = (
            np.maximum(np.asarray(gd.shape, f32) - 1.0, 1.0) / super_nb
        ).astype(f32)
        super_flat = supergrid_max(gd, super_nb, super_bs).reshape(-1)

        def arr(x, dtype=f32):
            return jnp.asarray(np.asarray(x, dtype))

        tri_n0 = col(tris, 3)
        tri_n1 = col(tris, 4)
        tri_n2 = col(tris, 5)
        tri_uv0 = col(tris, 6)
        tri_uv1 = col(tris, 7)
        tri_uv2 = col(tris, 8)
        # pre-join the object -> material/light/medium indirection per
        # triangle (see tables.SceneTables.tri_rec layout)
        tri_obj_col = np.asarray([r[9] for r in tris], np.int32)
        n_t = len(tris)
        j_light = np.full(n_t, -1, np.float32)
        j_medium = np.full(n_t, -1, np.float32)
        j_mtype = np.full(n_t, -1, np.float32)
        j_ior = np.ones(n_t, np.float32)
        j_albedo = np.zeros((n_t, 3), np.float32)
        for i, oid in enumerate(tri_obj_col):
            if oid < 0:
                continue
            mat, light, medium = objs[oid]
            j_light[i] = light
            j_medium[i] = medium
            if mat >= 0:
                mtype, alb, ior = mats[mat]
                j_mtype[i] = mtype
                j_ior[i] = ior
                j_albedo[i] = np.asarray(alb, f32) * np.ones(3, f32)
        tri_rec = np.concatenate(
            [tri_n0, tri_n1, tri_n2, tri_uv0, tri_uv1, tri_uv2,
             tri_v0, tri_e1, tri_e2,
             tri_obj_col[:, None].astype(f32), j_light[:, None],
             j_medium[:, None], j_mtype[:, None], j_ior[:, None], j_albedo],
            axis=1,
        )

        return SceneTables(
            tri_v0=arr(tri_v0), tri_e1=arr(tri_e1), tri_e2=arr(tri_e2),
            tri_n0=arr(tri_n0), tri_n1=arr(tri_n1),
            tri_n2=arr(tri_n2),
            tri_uv0=arr(tri_uv0), tri_uv1=arr(tri_uv1),
            tri_uv2=arr(tri_uv2),
            tri_obj=arr([r[9] for r in tris], np.int32),
            tri_rec=arr(tri_rec),
            sph_center=arr([r[0] for r in sphs]),
            sph_radius=arr([r[1] for r in sphs]),
            sph_obj=arr([r[2] for r in sphs], np.int32),
            box_min=arr([r[0] for r in boxes]),
            box_max=arr([r[1] for r in boxes]),
            box_obj=arr([r[2] for r in boxes], np.int32),
            obj_mat=arr([o[0] for o in objs], np.int32),
            obj_light=arr([o[1] for o in objs], np.int32),
            obj_medium=arr([o[2] for o in objs], np.int32),
            mat_type=arr([m[0] for m in mats], np.int32),
            mat_albedo=arr([m[1] for m in mats]),
            mat_ior=arr([m[2] for m in mats]),
            al_type=arr([a["type"] for a in als], np.int32),
            al_le=arr([a["le"] for a in als]),
            al_v0=arr([a["v0"] for a in als]),
            al_e1=arr([a["e1"] for a in als]),
            al_e2=arr([a["e2"] for a in als]),
            al_ng=arr([a["ng"] for a in als]),
            al_center=arr([a["center"] for a in als]),
            al_radius=arr([a["radius"] for a in als]),
            dl_type=arr([d["type"] for d in dls], np.int32),
            dl_pos=arr([d["pos"] for d in dls]),
            dl_dir=arr([d["dir"] for d in dls]),
            dl_color=arr([d["color"] for d in dls]),
            dl_intensity=arr([d["intensity"] for d in dls]),
            med_type=arr([m["type"] for m in meds], np.int32),
            med_g=arr([m["g"] for m in meds]),
            med_sigma_a=arr([m["sigma_a"] for m in meds]),
            med_sigma_s=arr([m["sigma_s"] for m in meds]),
            med_majorant=arr([m["majorant"] for m in meds]),
            med_density_mult=arr([m["density_mult"] for m in meds]),
            grid_density=arr(grid[0]),
            grid_min=arr(grid[1]),
            grid_max=arr(grid[2]),
            grid_packed=arr(
                packed if packed is not None
                else np.zeros((1, 8), f32)      # sentinel: size mismatch
            ),
            grid_super=arr(super_flat),
            grid_super_nb=arr(super_nb, np.int32),
            grid_super_bsize=arr(super_bs),
        )


def scene_statics(tables: SceneTables) -> dict:
    """Static (Python-int) facts about a scene, derived eagerly OUTSIDE jit.
    Integrator factories close over these to shape their loops."""
    import numpy as np

    return dict(
        n_area_lights=int(np.sum(np.asarray(tables.al_type) >= 0)),
        n_delta_lights=int(np.sum(np.asarray(tables.dl_type) >= 0)),
        has_heterogeneous=bool(
            np.any(np.asarray(tables.med_type) == MED_HETEROGENEOUS)
        ),
        has_media=bool(np.any(np.asarray(tables.med_type) >= 0)),
    )
