"""Triangle-mesh optics (``xicsrt_tpu/optics/mesh_shapes.py``).

The eager engine intersects meshes exactly, triangle by triangle, in plain
PyTorch on the run's device (a per-ray face gather is a load there):

- **Refine path** (the default where a coarse mesh exists and the data is
  local-frame; the reference's refinement, ``_ShapeMesh.py:350-475``): the
  rays, in the mesh's local frame, meet the coarse mesh densely; the hit's
  local x-y picks a cell of a uniform grid over the mesh footprint (rays
  that miss the coarse mesh fall back to the mid-plane), and the exact
  Möller-Trumbore test runs on that cell's candidate faces only. The grid
  is built on the host once per element.
- **Dense path** (``mesh_refine=False``, or no coarse mesh): every ray
  against every face, over fixed-size face chunks.

Both run in blocks of ``mesh_ray_block`` rays, so memory stays bounded.
``mesh_interpolate`` interpolates the vertex normals barycentrically on the
hit face. ``mesh_points`` and ``mesh_normals`` are tensors in ``params``.
With ``trace_local=True`` (generated meshes) points and normals are in the
optic's local frame.

The fused kernels trace a smooth mesh by its Chebyshev surrogate instead
(``ops/fused_trace._fit_cheb_surface``).
"""

from __future__ import annotations

import numpy as np
import torch

from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.optics.base import TraceElement

_MT_EPS = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the others."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _moller_trumbore(O, D, v0, v1, v2):
    """Möller-Trumbore ray/triangle test (JAX ``mesh_shapes.py:50-80``).

    ``O``/``D``: [N, 3] ray origins/directions. ``v0/v1/v2``: triangle
    vertices, [C, 3] (one face set) or [N, C, 3] (per-ray candidates).
    Returns ``(t, u, v, hit)``, each [N, C]."""
    if v0.dim() == 2:
        v0, v1, v2 = v0[None], v1[None], v2[None]
    e1 = v1 - v0
    e2 = v2 - v0
    Ob = O[:, None, :]
    Db = D[:, None, :]
    h = _cross(Db, e2)
    a = torch.sum(e1 * h, dim=-1)
    big = torch.abs(a) > _MT_EPS
    inv_a = 1.0 / torch.where(big, a, _MT_EPS)
    s = Ob - v0
    u = torch.sum(s * h, dim=-1) * inv_a
    q = _cross(s, e1)
    v = torch.sum(Db * q, dim=-1) * inv_a
    t = torch.sum(e2 * q, dim=-1) * inv_a
    hit = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-7)
    return t, u, v, hit


def _best(t, u, v, hit, rows):
    """The nearest hit of each ray over its candidates: (t or inf, column,
    u, v)."""
    t_masked = torch.where(hit, t, torch.full_like(t, float("inf")))
    j = torch.argmin(t_masked, dim=-1)
    return t_masked[rows, j], j, u[rows, j], v[rows, j]


class ShapeMesh(TraceElement):
    """Arbitrary triangle-mesh surface."""

    def default_config(self) -> dict:
        """
        mesh_points: [P,3] vertex positions.
        mesh_normals: [P,3] vertex normals (enables smooth interpolation).
        mesh_faces: [F,3] vertex indices.
        mesh_coarse_points/normals/faces: coarse proxy mesh used by the
            refine path to localize hits (``_ShapeMesh.py:350-426``).
        mesh_interpolate: barycentric smooth normal interpolation.
        mesh_refine: grid-pruned candidate intersection (default: on when a
            coarse mesh is available and the data is local-frame).
        mesh_chunk: faces per chunk on the dense path (memory knob).
        mesh_ray_block: rays per processed block (memory knob).
        mesh_grid_size: (ncx, ncy) pruning-grid resolution (default: auto,
            ~2 faces per cell before margin expansion).
        mesh_grid_margin: cell halo each face is registered into (covers the
            x-y error of the coarse hit estimate).
        """
        config = super().default_config()
        config["mesh_points"] = None
        config["mesh_normals"] = None
        config["mesh_faces"] = None
        config["mesh_coarse_points"] = None
        config["mesh_coarse_normals"] = None
        config["mesh_coarse_faces"] = None
        config["mesh_interpolate"] = None
        config["mesh_refine"] = None
        config["mesh_chunk"] = 512
        config["mesh_ray_block"] = 131072
        config["mesh_grid_size"] = None
        config["mesh_grid_margin"] = 1.0
        return config

    def check_param(self):
        super().check_param()
        if self.param["mesh_points"] is None or self.param["mesh_faces"] is None:
            raise ValueError(
                f'Optic "{self.name}": mesh_points and mesh_faces are required.')
        if self.param["mesh_interpolate"] is None:
            self.param["mesh_interpolate"] = self.param["mesh_normals"] is not None
        elif self.param["mesh_interpolate"] and self.param["mesh_normals"] is None:
            raise ValueError("mesh_normals must be provided to use mesh interpolation.")
        local_data = bool(self.param.get("trace_local", False))
        has_coarse = (self.param["mesh_coarse_points"] is not None
                      and self.param["mesh_coarse_faces"] is not None)
        refine = self.param["mesh_refine"]
        if refine is None:
            refine = has_coarse and local_data
        refine = bool(refine)
        if refine and not has_coarse:
            raise ValueError(
                f'Optic "{self.name}": mesh_refine requires mesh_coarse_points '
                "and mesh_coarse_faces.")
        if refine and not local_data:
            raise ValueError(
                f'Optic "{self.name}": mesh_refine requires local-frame mesh '
                "data (trace_local=True); the pruning grid lives in the "
                "mesh local x-y plane.")
        self.param["mesh_refine"] = refine

    def initialize(self):
        super().initialize()
        pts = np.asarray(self.param["mesh_points"], dtype=np.float64)
        spread = pts.max(axis=0) - pts.min(axis=0)
        if self.param.get("trace_local", False) and (
                spread[2] > spread[0] or spread[2] > spread[1]):
            self.log.warning("Mesh is not oriented with surface normals near local z; "
                             "results may be unexpected.")
        self._grid = self._build_grid() if self.param["mesh_refine"] else None

    def build_params(self) -> dict:
        params = super().build_params()
        params["mesh_points"] = self.as_tensor(self.param["mesh_points"])
        if self.param["mesh_normals"] is not None:
            params["mesh_normals"] = self.as_tensor(self.param["mesh_normals"])
        return params

    def _generate_coarse(self):
        """The coarse proxy mesh of a generator (``_ShapeMeshSphere.py:60-98``)."""
        size = self.param.get("mesh_coarse_size")
        if size is None or self.param["mesh_coarse_points"] is not None:
            return
        points, normals, faces = self.generate_mesh(size)
        self.param["mesh_coarse_points"] = points
        self.param["mesh_coarse_normals"] = normals
        self.param["mesh_coarse_faces"] = faces

    def intersect(self, params, rays):
        if self.param["mesh_refine"]:
            return self._intersect_refine(params, rays)
        return self._intersect_dense(params, rays)

    # -- shared pieces -----------------------------------------------------

    def _normal_at(self, pts, normals, fverts, u, v):
        """[N, 3] hit normals, in the frame of ``pts``: the vertex normals
        interpolated barycentrically, or the face's own."""
        if self.param["mesh_interpolate"] and normals is not None:
            w0 = (1.0 - u - v)[:, None]
            return vec.safe_normalize(w0 * normals[fverts[:, 0]]
                                      + u[:, None] * normals[fverts[:, 1]]
                                      + v[:, None] * normals[fverts[:, 2]])
        p0 = pts[fverts[:, 0]]
        return vec.safe_normalize(_cross(pts[fverts[:, 1]] - p0, pts[fverts[:, 2]] - p0))

    def _blocks(self, n: int):
        """Ray slices of at most ``mesh_ray_block`` rays."""
        b = max(1, int(self.param["mesh_ray_block"]))
        return [slice(i, min(i + b, n)) for i in range(0, n, b)]

    # -- dense path ----------------------------------------------------------

    def _intersect_dense(self, params, rays):
        local_data = bool(self.param.get("trace_local", False))
        faces = np.asarray(self.param["mesh_faces"], dtype=np.int64)
        chunk = int(self.param["mesh_chunk"])
        n_chunks = max(1, -(-faces.shape[0] // chunk))
        # Degenerate faces (vertex 0 three times) pad to whole chunks.
        pad = np.zeros((n_chunks * chunk - faces.shape[0], 3), dtype=np.int64)
        all_faces = torch.as_tensor(np.concatenate([faces, pad]), device=rays.origin.device)
        frame = params["frame"]
        pts = params["mesh_points"]
        normals = params.get("mesh_normals")
        if local_data:
            pts = frame.point_to_external(pts)
            if normals is not None:
                normals = frame.vector_to_external(normals)
        n = rays.origin.shape[0]
        best_t = torch.full((n,), float("inf"), dtype=rays.origin.dtype,
                            device=rays.origin.device)
        best_face = torch.zeros(n, dtype=torch.int64, device=rays.origin.device)
        best_u, best_v = torch.zeros_like(best_t), torch.zeros_like(best_t)
        for blk in self._blocks(n):
            O, D = rays.origin[blk], rays.direction[blk]
            rows = torch.arange(O.shape[0], device=O.device)
            bt, bf, bu, bv = best_t[blk], best_face[blk], best_u[blk], best_v[blk]
            for ci in range(n_chunks):
                tri = pts[all_faces[ci * chunk:(ci + 1) * chunk]]
                t_new, j, u, v = _best(*_moller_trumbore(O, D, tri[:, 0], tri[:, 1],
                                                         tri[:, 2]), rows)
                better = t_new < bt
                bt = torch.where(better, t_new, bt)
                bf = torch.where(better, ci * chunk + j, bf)
                bu = torch.where(better, u, bu)
                bv = torch.where(better, v, bv)
            best_t[blk], best_face[blk], best_u[blk], best_v[blk] = bt, bf, bu, bv
        m = rays.mask & torch.isfinite(best_t)
        dist = torch.where(m, best_t, torch.zeros_like(best_t))
        norm = self._normal_at(pts, normals, all_faces[best_face], best_u, best_v)
        return dist, norm, m

    # -- refine (grid-pruned) path -------------------------------------------

    def _build_grid(self) -> dict:
        """Host-side uniform grid over the local x-y mesh footprint (JAX
        ``mesh_shapes.py:311-369``): each cell lists every face whose x-y
        bounding box overlaps the cell grown by ``mesh_grid_margin`` cells,
        padded to the longest list with a sentinel degenerate face."""
        pts = np.asarray(self.param["mesh_points"], dtype=np.float64)
        faces = np.asarray(self.param["mesh_faces"], dtype=np.int32)
        n_faces = faces.shape[0]
        xy = pts[:, :2]
        fxy = xy[faces]  # [F, 3, 2]
        fmin = fxy.min(axis=1)
        fmax = fxy.max(axis=1)
        lo = xy.min(axis=0)
        hi = xy.max(axis=0)
        span = np.maximum(hi - lo, 1e-300)
        grid_size = self.param["mesh_grid_size"]
        if grid_size is None:
            ncx = ncy = int(np.clip(np.ceil(np.sqrt(n_faces / 2.0)), 1, 512))
        else:
            ncx, ncy = (int(v) for v in grid_size)
        cell = span / np.array([ncx, ncy])
        margin = float(self.param["mesh_grid_margin"]) * cell
        i0 = np.clip(np.floor((fmin - margin - lo) / cell).astype(np.int64), 0,
                     [ncx - 1, ncy - 1])
        i1 = np.clip(np.floor((fmax + margin - lo) / cell).astype(np.int64), 0,
                     [ncx - 1, ncy - 1])
        cell_lists = [[] for _ in range(ncx * ncy)]
        for f in range(n_faces):
            for ix in range(i0[f, 0], i1[f, 0] + 1):
                for iy in range(i0[f, 1], i1[f, 1] + 1):
                    cell_lists[ix * ncy + iy].append(f)
        k_max = max(1, max(len(c) for c in cell_lists))
        # Sentinel: face index n_faces -> degenerate triangle (vertex 0 x3).
        cell_faces = np.full((ncx * ncy, k_max), n_faces, dtype=np.int64)
        for ci, lst in enumerate(cell_lists):
            cell_faces[ci, :len(lst)] = lst
        faces_sentinel = np.concatenate([faces, np.zeros((1, 3), dtype=np.int32)], axis=0)
        coarse = np.asarray(self.param["mesh_coarse_points"], dtype=np.float64)[
            np.asarray(self.param["mesh_coarse_faces"], dtype=np.int64)]
        dev = self.device
        return {
            "cell_faces": torch.as_tensor(cell_faces, device=dev),
            "faces_sentinel": torch.as_tensor(faces_sentinel.astype(np.int64), device=dev),
            "coarse": torch.as_tensor(coarse, dtype=self.dtype, device=dev),  # [Fc, 3, 3]
            "lo": (float(lo[0]), float(lo[1])),
            "cell": (float(cell[0]), float(cell[1])),
            "ncx": ncx, "ncy": ncy, "k_max": k_max,
            "zmid": float(pts[:, 2].min() + pts[:, 2].max()) / 2.0,
        }

    def _intersect_refine(self, params, rays):
        g = self._grid
        frame = params["frame"]
        pts = params["mesh_points"]  # local frame
        normals = params.get("mesh_normals")
        O_l = frame.point_to_local(rays.origin)
        D_l = frame.vector_to_local(rays.direction)
        tri_c = g["coarse"].to(O_l.dtype)
        n = O_l.shape[0]
        best_t = torch.empty(n, dtype=O_l.dtype, device=O_l.device)
        best_face = torch.empty(n, dtype=torch.int64, device=O_l.device)
        best_u, best_v = torch.empty_like(best_t), torch.empty_like(best_t)
        for blk in self._blocks(n):
            O, D = O_l[blk], D_l[blk]
            rows = torch.arange(O.shape[0], device=O.device)
            # 1. The coarse hit estimate: every ray against the coarse mesh.
            tc, _, _, hitc = _moller_trumbore(O, D, tri_c[:, 0], tri_c[:, 1], tri_c[:, 2])
            t_c = torch.where(hitc, tc, torch.full_like(tc, float("inf"))).min(dim=-1).values
            # Coarse misses go to the mid-z plane (the reference loses them).
            dz = D[:, 2]
            safe_dz = torch.where(torch.abs(dz) > 1e-12, dz, torch.full_like(dz, 1e-12))
            t_plane = (g["zmid"] - O[:, 2]) / safe_dz
            p = O + torch.where(torch.isfinite(t_c), t_c, t_plane)[:, None] * D
            # 2. The grid cell's K candidate faces.
            ix = torch.nan_to_num((p[:, 0] - g["lo"][0]) / g["cell"][0]).clamp(
                0, g["ncx"] - 1).floor().long()
            iy = torch.nan_to_num((p[:, 1] - g["lo"][1]) / g["cell"][1]).clamp(
                0, g["ncy"] - 1).floor().long()
            cand = g["cell_faces"][ix * g["ncy"] + iy]  # [nb, K]
            fidx = g["faces_sentinel"][cand]  # [nb, K, 3]
            # 3. The exact test on the candidates only.
            t, j, u, v = _best(*_moller_trumbore(O, D, pts[fidx[..., 0]], pts[fidx[..., 1]],
                                                 pts[fidx[..., 2]]), rows)
            best_t[blk], best_face[blk], best_u[blk], best_v[blk] = t, cand[rows, j], u, v
        m = rays.mask & torch.isfinite(best_t)
        dist = torch.where(m, best_t, torch.zeros_like(best_t))
        norm_local = self._normal_at(pts, normals, g["faces_sentinel"][best_face],
                                     best_u, best_v)
        return dist, frame.vector_to_external(norm_local), m


def grid_faces(nx: int, ny: int) -> np.ndarray:
    """Triangulate a regular (nx, ny) point grid: 2 triangles per cell.

    Points are indexed row-major as i * ny + j.
    """
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = (i + 1) * ny + (j + 1)
            d = i * ny + (j + 1)
            faces.append((a, b, c))
            faces.append((a, c, d))
    return np.asarray(faces, dtype=np.int32)


class _MeshGenerator(ShapeMesh):
    """A mesh made on a regular grid by ``generate_mesh`` at setup, plus its
    coarse proxy (``mesh_size``, ``mesh_coarse_size``), in the local frame."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["mesh_size"] = (11, 11)
        config["mesh_coarse_size"] = (5, 5)
        config["trace_local"] = True
        return config

    def setup(self):
        super().setup()
        points, normals, faces = self.generate_mesh(self.param["mesh_size"])
        self.param["mesh_points"] = points
        self.param["mesh_normals"] = self.vertex_normals(points, normals)
        self.param["mesh_faces"] = faces
        self._generate_coarse()

    def vertex_normals(self, points, normals):
        return normals


class ShapeMeshSphere(_MeshGenerator):
    """Spherical surface patch as a mesh grid (``_ShapeMeshSphere.py:60-98``)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = 1.0
        return config

    def generate_mesh(self, mesh_size):
        radius = float(self.param["radius"])
        x = np.linspace(-float(self.param["xsize"]) / 2, float(self.param["xsize"]) / 2,
                        int(mesh_size[0]))
        y = np.linspace(-float(self.param["ysize"]) / 2, float(self.param["ysize"]) / 2,
                        int(mesh_size[1]))
        xx, yy = np.meshgrid(x, y, indexing="ij")
        zz = radius - np.sqrt(radius**2 - xx**2 - yy**2)
        points = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)
        normals = np.array([0.0, 0.0, radius])[None, :] - points
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        return points, normals, grid_faces(len(x), len(y))


class ShapeMeshCylinder(_MeshGenerator):
    """Cylindrical surface patch as a mesh grid; axis along local x."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = 1.0
        return config

    def generate_mesh(self, mesh_size):
        radius = float(self.param["radius"])
        xsize = float(self.param["xsize"])
        x = np.linspace(-xsize / 2, xsize / 2, int(mesh_size[0]))
        half_angle = np.arcsin(float(self.param["ysize"]) / 2 / radius)
        psi = np.linspace(-half_angle, half_angle, int(mesh_size[1]))
        xx, pp = np.meshgrid(x, psi, indexing="ij")
        points = np.stack([xx.ravel(), radius * np.sin(pp).ravel(),
                           (radius - radius * np.cos(pp)).ravel()], axis=-1)
        # The normal points from the surface towards the axis line.
        normals = np.stack([np.zeros_like(pp.ravel()), -np.sin(pp.ravel()),
                            np.cos(pp.ravel())], axis=-1)
        return points, normals, grid_faces(len(x), len(psi))


class ShapeMeshTorus(_MeshGenerator):
    """Toroidal surface patch as a mesh grid (``_ShapeMeshTorus.py``);
    ``normal_method='fd'`` takes finite-difference vertex normals."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius_major"] = 1.0
        config["radius_minor"] = 0.2
        config["convex"] = [False, False]
        config["normal_method"] = "analytic"
        config["mesh_xsize"] = None
        config["mesh_ysize"] = None
        return config

    def setup(self):
        from xicsrt_tpu_torch.optics.shapes import _TORUS_CONVEX

        convex = [bool(v) for v in np.atleast_1d(self.param["convex"])]
        if len(convex) == 1:
            convex = convex * 2
        # The analytic ShapeTorus's (major_adjust, center_sign).
        self._major_adjust, self._center_sign = _TORUS_CONVEX[tuple(convex)]
        super().setup()

    def vertex_normals(self, points, normals):
        if str(self.param["normal_method"]).lower() == "fd":
            return self._normals_fd(points)
        return normals

    def _surface(self, phi, psi):
        R = float(self.param["radius_major"])
        r = float(self.param["radius_minor"])
        adj = self._major_adjust
        s_m = self._center_sign
        T = R + adj * r
        # u(phi): unit vector in the local xz-plane from the torus center
        # towards the surface; the centre is s_m R zhat.
        ux = np.sin(phi)
        uz = -s_m * np.cos(phi)
        qx = T * ux
        qz = s_m * R + T * uz
        px = qx - adj * r * np.cos(psi) * ux
        py = r * np.sin(psi)
        pz = qz - adj * r * np.cos(psi) * uz
        normals = np.stack([-adj * np.cos(psi) * ux, np.sin(psi), -adj * np.cos(psi) * uz],
                           axis=-1)
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        return np.stack([px, py, pz], axis=-1), normals

    def generate_mesh(self, mesh_size):
        R = float(self.param["radius_major"])
        r = float(self.param["radius_minor"])
        xsize = self.param["mesh_xsize"] or self.param["xsize"]
        ysize = self.param["mesh_ysize"] or self.param["ysize"]
        half_major = np.arcsin(float(xsize) / 2 / R)
        half_minor = np.arcsin(float(ysize) / 2 / r)
        phi = np.linspace(-half_major, half_major, int(mesh_size[0]))
        psi = np.linspace(-half_minor, half_minor, int(mesh_size[1]))
        pp, ss = np.meshgrid(phi, psi, indexing="ij")
        points, normals = self._surface(pp.ravel(), ss.ravel())
        return points, normals, grid_faces(len(phi), len(psi))

    def _normals_fd(self, points):
        """Finite-difference normals: cross products of the grid's
        neighbouring-point gradients."""
        nx, ny = (int(v) for v in self.param["mesh_size"])
        pts = points.reshape(nx, ny, 3)
        n = np.cross(np.gradient(pts, axis=0), np.gradient(pts, axis=1))
        n = (-1.0 if self._major_adjust > 0 else 1.0) * n
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        return n.reshape(-1, 3)
