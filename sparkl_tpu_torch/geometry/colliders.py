"""Rigid colliders as analytic point projections (port of the cuboid and
heightfield parts of sparkl_tpu/geometry/colliders.py).

`project_point(points) -> (proj, is_inside)`: `proj` is the closest point
on the boundary (parry's solid=false convention), vectorized over any
leading axes. Ref: sparkl `src_kernels/gpu_collider.rs:43-95`. Halfspace,
ball, capsule, polyline and trimesh shapes and runtime poses are not
ported yet.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sparkl_tpu_torch.math import linalg

CUBOID = 0
HALFSPACE = 1
BALL = 2
HEIGHTFIELD = 3
POLYLINE = 4
CAPSULE = 5
TRIMESH = 6


@dataclass(frozen=True)
class Collider:
    shape_type: int
    data: tuple  # shape geometry, numpy
    translation: np.ndarray
    rotation: np.ndarray  # [d, d]
    friction: float = 0.0
    penalty_stiffness: float = 0.0
    boundary_handling: Optional[int] = None  # overrides SolverParameters
    flip_interior: bool = False

    def project_point(self, points):
        """(closest boundary point [..., d], is_inside [...])."""
        projections = {CUBOID: _project_cuboid, HEIGHTFIELD: _project_heightfield}
        if self.shape_type not in projections:
            raise NotImplementedError(
                f"collider shape {self.shape_type}: only the cuboid and the heightfield are ported"
            )
        dev = points.device
        t = torch.as_tensor(self.translation, dtype=torch.float32, device=dev)
        r = torch.as_tensor(self.rotation, dtype=torch.float32, device=dev)
        # f32 products (TF32 is off unless the caller turns it on). A
        # rotation formed in float64 and cast has off-axis terms such as
        # sin(pi) = 1.2e-16 rather than 0: these are true 3-term sums.
        proj, inside = projections[self.shape_type]((points - t) @ r, *self.data)
        if self.flip_interior:
            inside = ~inside
        return proj @ r.T + t, inside


def cuboid(half_extents, translation=None, rotation=None, friction=0.0, **kw):
    """Box with these half extents in its local frame, 2D or 3D (ref: the
    reference scenes' rapier cuboid colliders)."""
    he = np.asarray(half_extents, np.float32)
    dim = len(he)
    t = np.zeros(dim, np.float32) if translation is None else np.asarray(translation, np.float32)
    r = np.eye(dim, dtype=np.float32) if rotation is None else np.asarray(rotation, np.float32)
    return Collider(CUBOID, (he,), t, r, friction, **kw)


def heightfield(heights, scale, translation=None, rotation=None, friction=0.0, **kw):
    """Heightfield over the horizontal axes: in 2D heights[nx] over x in
    [-sx/2, sx/2], in 3D heights[nx, nz] over (x, z) in [-sx/2, sx/2] x
    [-sz/2, sz/2]; y = h * sy (parry's parameterization, as the reference
    scenes use it, e.g. examples3d/sand3.rs:30-38, examples2d/basic2.rs)."""
    h = np.asarray(heights, np.float32)
    s = np.asarray(scale, np.float32)
    dim = len(s)
    t = np.zeros(dim, np.float32) if translation is None else np.asarray(translation, np.float32)
    r = np.eye(dim, dtype=np.float32) if rotation is None else np.asarray(rotation, np.float32)
    return Collider(HEIGHTFIELD, (h, s), t, r, friction, **kw)


def _project_cuboid(p, half_extents):
    """Outside: the clamp into the box. Inside: the point with its axis of
    smallest gap to a face (the first on ties) snapped onto that face."""
    he = torch.as_tensor(half_extents, dtype=p.dtype, device=p.device)
    clamped = torch.clamp(p, min=-he, max=he)
    outside = torch.any(torch.abs(p) > he, dim=-1)
    axis = torch.argmin(he - torch.abs(p), dim=-1)
    onehot = (axis[..., None] == torch.arange(p.shape[-1], device=p.device)).to(p.dtype)
    inner = p * (1.0 - onehot) + torch.sign(p) * he * onehot
    return torch.where(outside[..., None], clamped, inner), ~outside


def _point_triangle_closest(pf, a, b, c):
    """Ericson's point-triangle closest point, broadcast over [..., 3]."""
    ab = b - a
    ac = c - a
    ap = pf - a
    d1 = torch.sum(ab * ap, dim=-1)
    d2 = torch.sum(ac * ap, dim=-1)
    bp = pf - b
    d3 = torch.sum(ab * bp, dim=-1)
    d4 = torch.sum(ac * bp, dim=-1)
    cp = pf - c
    d5 = torch.sum(ab * cp, dim=-1)
    d6 = torch.sum(ac * cp, dim=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_face = torch.clamp(va + vb + vc, min=1e-30)
    v_f = vb / denom_face
    w_f = vc / denom_face
    pt_face = a + v_f[..., None] * ab + w_f[..., None] * ac

    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0.0, 1.0)
    pt_ab = a + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0.0, 1.0)
    pt_ac = a + t_ac[..., None] * ac
    t_bc = torch.clamp(
        (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=1e-30), 0.0, 1.0
    )
    pt_bc = b + t_bc[..., None] * (c - b)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (~in_a) & (~in_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (~in_a) & (~in_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (~in_b) & (~in_c) & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    pt = pt_face
    pt = torch.where(on_bc[..., None], pt_bc, pt)
    pt = torch.where(on_ac[..., None], pt_ac, pt)
    pt = torch.where(on_ab[..., None], pt_ab, pt)
    pt = torch.where(in_c[..., None], c.expand_as(pt), pt)
    pt = torch.where(in_b[..., None], b.expand_as(pt), pt)
    pt = torch.where(in_a[..., None], a.expand_as(pt), pt)
    return pt


def _field_coord(x, s, n):
    """(x / s + 0.5) · (n - 1): a local coordinate in sample units. Rounded
    as jitted XLA rounds the JAX package's expression (the collider's
    scale is a constant there): x · f32(1/s) + 0.5 as one FMA."""
    return linalg.fma(x, float(np.float32(1.0) / np.float32(s)), 0.5) * (n - 1)


def _vertex_coord(i, n, s):
    """(i / (n - 1) - 0.5) · s: the local coordinate of sample i, rounded
    as jitted XLA rounds it, i · f32(1/(n - 1)) - 0.5 as one FMA (a true
    division differs at 7 of 41 samples when n = 41)."""
    c = float(np.float32(1.0) / np.float32(n - 1))
    return linalg.fma(i.to(torch.float32), c, -0.5) * s


def _project_heightfield(p, heights, scale):
    """Exact closest-point projection onto the piecewise-linear heightfield:
    in 2D the segments between consecutive samples, the query projected
    onto the 3 segments around its horizontal position; in 3D each cell
    split along its (i,k)->(i+1,k+1) diagonal, the query projected onto the
    18 triangles of the 3x3 cells around it (exact wherever the closest
    point lies within one cell horizontally)."""
    if p.shape[-1] == 2:
        return _project_heightfield2(p, heights, scale)
    dev = p.device
    h = torch.as_tensor(heights, dtype=torch.float32, device=dev)
    s = [float(x) for x in np.asarray(scale, np.float32)]
    nx, nz = h.shape
    lead = p.shape[:-1]
    pf = p.reshape(-1, 3)
    u = _field_coord(pf[:, 0], s[0], nx)
    w = _field_coord(pf[:, 2], s[2], nz)
    uc = torch.clamp(u, 0.0, nx - 1.000001)
    wc = torch.clamp(w, 0.0, nz - 1.000001)
    i0 = torch.floor(uc).to(torch.int32)
    k0 = torch.floor(wc).to(torch.int32)
    fu = uc - i0
    fw = wc - k0

    def vert(di, dk):
        idx = torch.clamp(i0 + di, 0, nx - 1)
        kdx = torch.clamp(k0 + dk, 0, nz - 1)
        hy = h[idx.long(), kdx.long()] * s[1]
        x = _vertex_coord(idx, nx, s[0])
        z = _vertex_coord(kdx, nz, s[2])
        return torch.stack([x, hy, z], dim=-1)  # [M, 3]

    verts = {(di, dk): vert(di, dk) for di in range(-1, 3) for dk in range(-1, 3)}
    tris_a, tris_b, tris_c = [], [], []
    for di in range(-1, 2):
        for dk in range(-1, 2):
            v00 = verts[(di, dk)]
            v10 = verts[(di + 1, dk)]
            v01 = verts[(di, dk + 1)]
            v11 = verts[(di + 1, dk + 1)]
            tris_a += [v00, v00]
            tris_b += [v10, v11]
            tris_c += [v11, v01]
    a = torch.stack(tris_a, dim=1)  # [M, 18, 3]
    b = torch.stack(tris_b, dim=1)
    c = torch.stack(tris_c, dim=1)

    pt = _point_triangle_closest(pf[:, None, :], a, b, c)  # [M, 18, 3]
    d2 = torch.sum((pf[:, None, :] - pt) ** 2, dim=-1)
    # First minimum wins ties, as the JAX package's sequential select does.
    best_d2 = d2[:, 0]
    proj = pt[:, 0, :]
    for t in range(1, 18):
        pick = d2[:, t] < best_d2
        best_d2 = torch.where(pick, d2[:, t], best_d2)
        proj = torch.where(pick[:, None], pt[:, t, :], proj)

    # Containment: below the triangulated surface of the own cell.
    h00 = verts[(0, 0)][:, 1]
    h10 = verts[(1, 0)][:, 1]
    h01 = verts[(0, 1)][:, 1]
    h11 = verts[(1, 1)][:, 1]
    in_a = fu >= fw
    h_a = h00 + fu * (h10 - h00) + fw * (h11 - h10)
    h_b = h00 + fw * (h01 - h00) + fu * (h11 - h01)
    inside = pf[:, 1] < torch.where(in_a, h_a, h_b)
    return proj.reshape(lead + (3,)), inside.reshape(lead)


def _project_heightfield2(p, heights, scale):
    """The 2D heightfield: the segments between the 4 samples around the
    query's x (clamped at the field's ends), the first closest on ties;
    inside below the segment over x (the end segment beyond either end)."""
    h = torch.as_tensor(heights, dtype=torch.float32, device=p.device)
    s = [float(x) for x in np.asarray(scale, np.float32)]
    nx = h.shape[0]
    u = _field_coord(p[..., 0], s[0], nx)
    uc = torch.clamp(u, 0.0, nx - 1.000001)
    i0 = torch.floor(uc).to(torch.int32)

    def corner(di):
        idx = torch.clamp(i0 + di, 0, nx - 1)
        x = _vertex_coord(idx, nx, s[0])
        return torch.stack([x, h[idx.long()] * s[1]], dim=-1)

    v = [corner(di) for di in range(-1, 3)]
    best_d2 = best_proj = None
    for k in range(3):
        a, b = v[k], v[k + 1]
        ab = b - a
        t = torch.sum((p - a) * ab, dim=-1) / torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-20)
        cand = a + torch.clamp(t, 0.0, 1.0)[..., None] * ab
        d2 = torch.sum((p - cand) ** 2, dim=-1)
        if best_d2 is None:
            best_d2, best_proj = d2, cand
        else:
            pick = d2 < best_d2
            best_d2 = torch.where(pick, d2, best_d2)
            best_proj = torch.where(pick[..., None], cand, best_proj)
    fu = uc - i0
    height = v[1][..., 1] * (1 - fu) + v[2][..., 1] * fu
    return best_proj, p[..., 1] < height
