"""Map and trajectory snapshots (the viewer).

Port of ``orbslam2_tpu/utils/viewer.py``: the role of ORB-SLAM2's Pangolin
viewer (``Viewer``, ``FrameDrawer``, ``MapDrawer``) on a host without a GL
stack.  ``draw_map`` renders the map points, the keyframes, the
covisibility graph and the trajectory top-down to a PNG, ``draw_frame`` a
FrameDrawer-style annotated frame, and ``LiveViewer`` writes such
snapshots during a run instead of a live window.

A snapshot reads the map from the device once, one ``.cpu()`` per field it
draws; ``LiveViewer.update`` reads nothing from the device on a frame that
draws nothing.  The figures are matplotlib's (Agg), as the reference's;
where matplotlib is not installed the same content is drawn with PIL.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image, ImageDraw

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _HAS_MPL = True
except ImportError:
    _HAS_MPL = False

from ..models import map_state as ms


def _map_scene(m: ms.MapState, show_covisibility: bool, min_covis_weight: int):
    """The host arrays ``draw_map`` draws: valid points, each keyframe's
    camera centre (None for an invalid one), the covisibility edges and
    the title."""
    pt_valid = m.pt_valid.cpu().numpy()
    pts = m.pt_pos.cpu().numpy()[pt_valid]
    kf_ok = m.kf_valid.cpu().numpy()
    n = int(m.n_kf.cpu())
    kf_poses = m.kf_pose_cw.cpu().numpy()
    centers = []
    for k in range(n):
        if not kf_ok[k]:
            centers.append(None)
            continue
        T = kf_poses[k]
        centers.append(-T[:3, :3].T @ T[:3, 3])
    edges = []
    if show_covisibility and n:
        W = ms.covisibility(m).cpu().numpy()
        for i in range(n):
            if centers[i] is None:
                continue
            for j in range(i + 1, n):
                if centers[j] is None or W[i, j] < min_covis_weight:
                    continue
                edges.append((centers[i], centers[j]))
    title = f"map: {int(pt_valid.sum())} points, {int(kf_ok[:n].sum())} keyframes"
    return pts, centers, edges, title


def draw_map(
    m: ms.MapState,
    path: str,
    trajectory: Optional[np.ndarray] = None,
    gt_trajectory: Optional[np.ndarray] = None,
    show_covisibility: bool = True,
    min_covis_weight: int = 100,
    follow: Optional[np.ndarray] = None,
    follow_radius: float = 0.0,
) -> bool:
    """Top-down (x-z) map view: points, keyframes, covisibility, trajectory
    (MapDrawer::DrawMapPoints / DrawKeyFrames, src/MapDrawer.cc:≈40-190)."""
    pts, centers, edges, title = _map_scene(m, show_covisibility, min_covis_weight)
    cs = np.array([c for c in centers if c is not None])
    est = None if trajectory is None else np.asarray(trajectory)[:, :3, 3]
    gt = None if gt_trajectory is None else np.asarray(gt_trajectory)[:, :3, 3]
    cam = None
    if follow is not None and follow_radius > 0:
        cam = np.asarray(follow, np.float64)
    if not _HAS_MPL:
        _draw_map_pil(path, pts, cs, edges, est, gt, cam, follow_radius, title)
        return True
    fig, ax = plt.subplots(figsize=(8, 8))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="k", alpha=0.3, label="map points")
    if len(cs):
        ax.scatter(cs[:, 0], cs[:, 2], s=14, c="tab:blue", marker="s", label="keyframes")
    for a, b in edges:
        ax.plot([a[0], b[0]], [a[2], b[2]], c="tab:green", lw=0.4, alpha=0.5)
    if est is not None:
        ax.plot(est[:, 0], est[:, 2], c="tab:red", lw=1.2, label="estimate")
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 2], c="tab:gray", lw=1.0, ls="--", label="ground truth")
    if cam is not None:
        # Follow-camera view (Viewer.cc menuFollowCamera): a window centred
        # on the current camera centre.
        ax.set_xlim(cam[0] - follow_radius, cam[0] + follow_radius)
        ax.set_ylim(cam[2] - follow_radius, cam[2] + follow_radius)
        ax.scatter([cam[0]], [cam[2]], s=60, c="tab:red", marker="x", label="camera")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def draw_frame(
    image: np.ndarray,
    kp_xy: np.ndarray,
    kp_tracked: np.ndarray,
    path: str,
    state_text: str = "",
) -> bool:
    """FrameDrawer::DrawFrame: keypoints over the image, tracked ones green,
    the others blue, and the status line (src/FrameDrawer.cc:≈120)."""
    img = np.asarray(image)
    kp = np.asarray(kp_xy)
    tracked = np.asarray(kp_tracked)
    if not _HAS_MPL:
        canvas = _gray_canvas(img)
        draw = ImageDraw.Draw(canvas)
        for pts, color in ((kp[~tracked], "blue"), (kp[tracked], "green")):
            for x, y in pts:
                draw.ellipse([x - 2, y - 2, x + 2, y + 2], outline=color)
        if state_text:
            draw.rectangle([2, 2, 8 + 6 * len(state_text), 16], fill="black")
            draw.text((4, 4), state_text, fill="yellow")
        canvas.save(path)
        return True
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    if len(kp):
        ax.scatter(kp[~tracked, 0], kp[~tracked, 1], s=6, c="tab:blue", marker="o",
                   linewidths=0.5, facecolors="none")
        ax.scatter(kp[tracked, 0], kp[tracked, 1], s=6, c="tab:green", marker="o",
                   linewidths=0.5, facecolors="none")
    if state_text:
        ax.text(4, 12, state_text, color="yellow", fontsize=9,
                bbox=dict(facecolor="black", alpha=0.6, pad=2))
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def _gray_canvas(img: np.ndarray) -> Image.Image:
    """An 8-bit image (gray values 0-255) as an RGB PIL canvas."""
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).convert("RGB")


def _draw_map_pil(path, pts, cs, edges, est, gt, cam, follow_radius, title, size=880):
    """``draw_map``'s content without matplotlib: the x-z plane fitted to
    an 880 x 880 canvas (or the follow window), z up."""
    if cam is not None:
        lo = np.array([cam[0] - follow_radius, cam[2] - follow_radius])
        hi = np.array([cam[0] + follow_radius, cam[2] + follow_radius])
    else:
        xz = [a[:, [0, 2]] for a in (pts, cs, est, gt) if a is not None and len(a)]
        xz = np.concatenate(xz) if xz else np.zeros((1, 2))
        lo, hi = xz.min(axis=0), xz.max(axis=0)
    span = max(float((hi - lo).max()), 1e-6)
    margin = 40

    def px(p):
        x = margin + (p[0] - lo[0]) / span * (size - 2 * margin)
        y = size - margin - (p[2] - lo[1]) / span * (size - 2 * margin)
        return float(x), float(y)

    canvas = Image.new("RGB", (size, size), "white")
    draw = ImageDraw.Draw(canvas)
    for p in pts:
        draw.point(px(p), fill=(110, 110, 110))
    for a, b in edges:
        draw.line([px(a), px(b)], fill=(44, 160, 44), width=1)
    for c in cs:
        x, y = px(c)
        draw.rectangle([x - 3, y - 3, x + 3, y + 3], fill=(31, 119, 180))
    for line, color in ((gt, (127, 127, 127)), (est, (214, 39, 40))):
        if line is not None and len(line) > 1:
            draw.line([px(p) for p in line], fill=color, width=2)
    if cam is not None:
        x, y = px(cam)
        draw.line([x - 6, y - 6, x + 6, y + 6], fill=(214, 39, 40), width=2)
        draw.line([x - 6, y + 6, x + 6, y - 6], fill=(214, 39, 40), width=2)
    draw.text((margin, 12), title, fill="black")
    canvas.save(path)


class LiveViewer:
    """Periodic snapshots, the Viewer::Run loop's role (src/Viewer.cc:≈60-140)
    without a window: a PNG every ``every_kf`` keyframes and on every loop
    closure, and a last full view at the end of the run.

        lv = LiveViewer(out_dir, every_kf=5, follow_radius=4.0)
        for each frame:  lv.update(system)      # draws only on an event
        lv.finish(system, gt_trajectory=...)    # the final map view
    """

    def __init__(self, out_dir: str, every_kf: int = 5, follow_radius: float = 0.0):
        self.out = out_dir
        self.every_kf = max(1, int(every_kf))
        self.follow_radius = float(follow_radius)
        self.last_kf_drawn = 0
        self.last_loops = 0
        self.n_snaps = 0
        os.makedirs(out_dir, exist_ok=True)

    def _snap(self, system, tag: str) -> None:
        follow = None
        if self.follow_radius > 0:
            T = system.tracker.last_T.cpu().numpy()
            follow = -T[:3, :3].T @ T[:3, 3]
        draw_map(
            system.map,
            os.path.join(self.out, f"map_{self.n_snaps:04d}_{tag}.png"),
            trajectory=system.poses_wc(),
            follow=follow,
            follow_radius=self.follow_radius,
        )
        self.n_snaps += 1

    def update(self, system) -> None:
        """Call once per tracked frame; draws only on a keyframe interval or
        a loop closure, so a frame costs a few integer comparisons."""
        # Never read the device per frame: the host copy of the keyframe
        # count that the chunked tracker keeps from its per-chunk read, else
        # the tracker's count of keyframes created.
        n_kf = getattr(system.tracker, "_host_n_kf", None)
        if n_kf is None:
            n_kf = system.tracker.metrics.get("keyframes_created", 0)
        loops = len(system.loop_closer.loop_edges) if system.loop_closer is not None else 0
        if loops > self.last_loops:
            self.last_loops = loops
            self._snap(system, "loop")
        elif n_kf - self.last_kf_drawn >= self.every_kf:
            self.last_kf_drawn = n_kf
            self._snap(system, "kf")

    def finish(self, system, gt_trajectory=None) -> None:
        draw_map(system.map, os.path.join(self.out, "map_final.png"),
                 trajectory=system.poses_wc(), gt_trajectory=gt_trajectory)
