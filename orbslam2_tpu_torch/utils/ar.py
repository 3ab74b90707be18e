"""Augmented-reality overlay: the AR demo's capability.

Port of ``orbslam2_tpu/utils/ar.py`` (ORB-SLAM2's ros_mono_ar and
ViewerAR.{cc,h}): fit the dominant plane to the map points and draw a
virtual cube anchored to it from the live camera pose.

* ``fit_plane_ransac``: ViewerAR::DetectPlane as one batched RANSAC (all
  hypotheses scored at once, no loop), then a refine on the inlier set;
* ``cube_vertices`` / ``project_points``: the overlay's geometry (host);
* ``draw_ar_overlay``: a PNG of the image and the cube's wireframe.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from PIL import ImageDraw

from ..ops.pnp import draw_samples
from ..ops.twoview import SWEEPS_3, jacobi_eigh
from . import viewer


class Plane(NamedTuple):
    normal: torch.Tensor     # (3,) unit normal
    point: torch.Tensor      # (3,) a point on the plane (the inliers' centroid)
    n_inliers: torch.Tensor  # () int
    ok: torch.Tensor         # () bool


def fit_plane_ransac(
    points: torch.Tensor,     # (P, 3) world points
    valid: torch.Tensor,      # (P,) mask
    samples: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    n_hyp: int = 256,
    inlier_th: float = 0.02,  # distance threshold (map units)
) -> Plane:
    """Dominant-plane RANSAC (ViewerAR::DetectPlane): 3 points a hypothesis,
    inliers by point-plane distance, the best hypothesis (the first on a
    tie), then the normal and centroid refined on its inliers (the
    smallest principal axis of their scatter).

    ``samples``: the (n_hyp, 3) point indices of the hypotheses; without
    them they are drawn with replacement among the valid points from
    ``generator``, on the points' device (``ops/pnp.draw_samples``: no host
    read).  The refine is the port's Jacobi on the 3x3 scatter in float64,
    so nothing here calls a solver library or reads the device; the normal's
    sign is arbitrary, as an eigenvector's."""
    if samples is None:
        samples = draw_samples(valid, n_hyp, 3, generator)
    idx = samples.to(device=points.device, dtype=torch.int64)
    a = points[idx[:, 0]]
    b = points[idx[:, 1]]
    c = points[idx[:, 2]]
    n = torch.linalg.cross(b - a, c - a)
    n_norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(n_norm, min=1e-9)
    degenerate = n_norm[:, 0] < 1e-9

    # (H, P) point-plane distances.
    d = torch.einsum("hj,hpj->hp", n, points[None, :, :] - a[:, None, :]).abs()
    inl = (d <= inlier_th) & valid[None, :]
    counts = torch.where(degenerate, -1, inl.sum(dim=1))
    # A device index, taken with index_select: indexing with a 0-d tensor
    # would read it on the host.
    best = torch.argmax(counts).view(1)

    wts = inl.index_select(0, best)[0].to(points.dtype)
    centroid = (points * wts[:, None]).sum(dim=0) / torch.clamp(wts.sum(), min=1.0)
    X = (points - centroid) * wts[:, None]
    lam, V = jacobi_eigh((X.T @ X).double(), SWEEPS_3)
    normal = V.index_select(1, torch.argmin(lam).view(1))[:, 0].to(points.dtype)
    normal = normal / torch.clamp(torch.linalg.vector_norm(normal), min=1e-9)
    n_inliers = counts.index_select(0, best)[0]
    return Plane(normal=normal, point=centroid, n_inliers=n_inliers, ok=n_inliers >= 20)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def cube_vertices(plane: Plane, size: float = 0.3, anchor: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """(8, 3) world corners of a cube standing on the plane."""
    n = _host(plane.normal).astype(np.float64)
    p0 = (_host(anchor) if anchor is not None else _host(plane.point)).astype(np.float64)
    # Orthonormal in-plane basis.
    t = np.array([1.0, 0.0, 0.0])
    if abs(n @ t) > 0.9:
        t = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, t)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    s = size / 2.0
    base = [p0 + du * s * u + dv * s * v for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]]
    top = [q + size * n for q in base]
    return np.stack(base + top)


CUBE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def project_points(T_cw, cam, pts_w: np.ndarray):
    """(N, 2) pixels and the in-front mask of world points under pose T_cw."""
    T = _host(T_cw).astype(np.float64)
    pc = pts_w @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    uv = np.stack(
        [float(cam.fx) * pc[:, 0] / np.maximum(z, 1e-9) + float(cam.cx),
         float(cam.fy) * pc[:, 1] / np.maximum(z, 1e-9) + float(cam.cy)], -1
    )
    return uv, z > 0.05


def draw_ar_overlay(image, T_cw, cam, plane: Plane, path: str, size: float = 0.3,
                    anchor=None):
    """The image and the cube's wireframe to ``path`` (a PNG)."""
    img = _host(image)
    verts = cube_vertices(plane, size=size, anchor=anchor)
    uv, front = project_points(T_cw, cam, verts)
    edges = [(i, j) for i, j in CUBE_EDGES if front[i] and front[j]]
    if not viewer._HAS_MPL:
        canvas = viewer._gray_canvas(img)
        draw = ImageDraw.Draw(canvas)
        for i, j in edges:
            draw.line([tuple(uv[i]), tuple(uv[j])], fill=(0, 255, 0), width=2)
        canvas.save(path)
        return
    plt = viewer.plt
    fig, ax = plt.subplots(figsize=(6.4, 4.8), dpi=100)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    for i, j in edges:
        ax.plot([uv[i, 0], uv[j, 0]], [uv[i, 1], uv[j, 1]], color="lime", lw=2)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
