"""Synthetic RGB-D sequences with exact ground truth (numpy).

A copy of the sequence half of ``orbslam2_tpu/utils/synthetic.py``, typed
against the port's ``CameraModel``: a 3-D landmark field, each landmark
carrying a binary texture sprite, rendered with a textured background
plane along a smooth camera trajectory.  The same seeds give the same
frames as the reference package.  ATE against the ground truth is the
end-to-end metric.  The room world and its circular loop sequence
(``make_loop_sequence``) are the relocalization and loop-closure fixtures.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..utils.camera import CameraModel


class SyntheticWorld(NamedTuple):
    points: np.ndarray   # (P, 3) world landmarks
    sprites: np.ndarray  # (P, S, S) per-landmark texture (float32 0..255)


class SyntheticSequence(NamedTuple):
    world: SyntheticWorld
    poses_wc: np.ndarray  # (F, 4, 4) camera-to-world (ground truth)
    images: np.ndarray    # (F, H, W) float32 grayscale
    depths: Optional[np.ndarray]  # (F, H, W) float32 depth or None
    timestamps: np.ndarray  # (F,)


def make_world(
    n_points: int = 600,
    extent=(8.0, 5.0, 4.0),
    z_offset: float = 6.0,
    sprite_size: int = 15,
    seed: int = 0,
) -> SyntheticWorld:
    """Landmarks in a box in front of the origin looking +z, each with a
    high-contrast random sprite sized to cover the rBRIEF sampling patch
    (radius 13), so descriptors are distinctive and repeatable."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, size=(n_points, 3)) * np.array(extent)
    pts[:, 2] += z_offset
    # 5x5 binary block texture, upsampled: 2^25 distinct patterns, stable
    # under small viewpoint change.
    base = rng.integers(0, 2, size=(n_points, 5, 5)).astype(np.float32)
    reps = sprite_size // 5 + 1
    sprites = np.kron(base, np.ones((reps, reps), np.float32))[
        :, :sprite_size, :sprite_size
    ]
    sprites = 40.0 + sprites * 180.0  # dark/bright blocks
    # Soften edges (sub-pixel-shift robustness of binary descriptors).
    for _ in range(2):
        acc = np.zeros_like(sprites)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc += np.roll(np.roll(sprites, dy, axis=1), dx, axis=2)
        sprites = acc / 9.0
    # Directional ramp per sprite -> stable dominant orientation.
    ramp = np.arange(sprite_size, dtype=np.float32) - sprite_size // 2
    sprites = np.clip(sprites + 4.0 * ramp[None, None, :], 0, 255)
    return SyntheticWorld(points=pts.astype(np.float32), sprites=sprites)


_PLANE_TEX_CACHE = {}


def _plane_texture(seed: int = 99, size: int = 512, block: int = 8) -> np.ndarray:
    """Static random texture for the background plane (cached).

    Band-limited (blurred block noise): hard edges would make binary
    descriptor bits flip with sub-pixel sampling shifts, which no natural
    image does to that degree.
    """
    key = (seed, size, block)
    if key not in _PLANE_TEX_CACHE:
        rng = np.random.default_rng(seed)

        def octave(blk, lo, hi):
            b = rng.uniform(lo, hi, size=(size // blk, size // blk))
            return np.kron(b, np.ones((blk, blk)))

        # Multi-octave noise with contrast modulation: corner responses then
        # span a wide range (like natural images), which keeps top-N
        # keypoint selection stable frame to frame.  Uniform-contrast noise
        # makes selection churn and kills detector repeatability.
        fine = octave(block, -1.0, 1.0)
        mid = octave(block * 2, -1.0, 1.0)
        coarse = octave(block * 4, -1.0, 1.0)
        amp = octave(block * 8, 0.15, 1.0)  # contrast modulation map
        tex = 130.0 + amp * (55.0 * fine + 45.0 * mid) + 25.0 * coarse
        # Separable box blur x3 ~ Gaussian sigma ~ block/3 (wrap to keep the
        # texture tileable).
        k = block // 2 * 2 + 1
        for _ in range(3):
            tex = (
                sum(np.roll(tex, i - k // 2, axis=0) for i in range(k)) / k
            )
            tex = (
                sum(np.roll(tex, i - k // 2, axis=1) for i in range(k)) / k
            )
        # Anisotropy: a tileable low-frequency gradient so the intensity-
        # centroid orientation is gradient-dominated (stable), as it is on
        # natural corner patches, instead of noise-driven.
        xs = np.arange(size) * (2 * np.pi / size)
        tex = (
            tex
            + 35.0 * np.sin(3 * xs)[None, :]
            + 15.0 * np.sin(3 * xs + 1.3)[:, None]
        )
        _PLANE_TEX_CACHE[key] = np.clip(tex, 0, 255).astype(np.float32)
    return _PLANE_TEX_CACHE[key]


def make_trajectory(
    n_frames: int = 30,
    radius: float = 0.8,
    forward: float = 1.5,
    yaw_amp: float = 0.05,
    seed: int = 1,
) -> np.ndarray:
    """Smooth sideways arc with slight yaw — keeps the landmark field in
    view while generating parallax (like the TUM fr1/xyz hand motion)."""
    t = np.linspace(0.0, 1.0, n_frames)
    poses = np.zeros((n_frames, 4, 4), np.float64)
    for i, s in enumerate(t):
        yaw = yaw_amp * np.sin(2 * np.pi * s)
        c, sn = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        pos = np.array(
            [radius * np.sin(2 * np.pi * s), 0.15 * np.sin(4 * np.pi * s),
             forward * s]
        )
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        poses[i, 3, 3] = 1.0
    return poses.astype(np.float32)


def render_frame(
    world: SyntheticWorld,
    pose_wc: np.ndarray,
    cam: CameraModel,
    noise: float = 2.0,
    seed: int = 0,
    with_depth: bool = False,
):
    """Render one grayscale frame (and optional depth map).

    The background is a textured plane at z = z_plane in world frame
    (perspective-correct ray casting, so plane features are geometrically
    consistent 3-D structure); landmark sprites are splatted axis-aligned
    at their projected locations with z-ordering on top.
    """
    H, W = cam.height, cam.width
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    rng = np.random.default_rng(seed)

    # --- background plane at world z = z_plane ---
    z_plane = float(world.points[:, 2].max()) + 2.0
    tex = _plane_texture()
    ts = tex.shape[0]
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack(
        [(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1
    )
    Rwc = pose_wc[:3, :3].astype(np.float64)
    C = pose_wc[:3, 3].astype(np.float64)
    d_w = d_cam @ Rwc.T
    s = (z_plane - C[2]) / np.where(np.abs(d_w[..., 2]) < 1e-9, 1e-9, d_w[..., 2])
    Xw = C + s[..., None] * d_w
    # texture lookup: 24 px per world unit, BILINEAR so the image is a
    # continuous function of sub-pixel camera motion (stereo sub-pixel
    # disparity refinement needs real sub-pixel structure).
    tx = Xw[..., 0] * 24.0
    ty = Xw[..., 1] * 24.0
    tx0 = np.floor(tx).astype(np.int64)
    ty0 = np.floor(ty).astype(np.int64)
    fx_t = tx - tx0
    fy_t = ty - ty0
    t00 = tex[ty0 % ts, tx0 % ts]
    t01 = tex[ty0 % ts, (tx0 + 1) % ts]
    t10 = tex[(ty0 + 1) % ts, tx0 % ts]
    t11 = tex[(ty0 + 1) % ts, (tx0 + 1) % ts]
    img = (
        t00 * (1 - fx_t) * (1 - fy_t) + t01 * fx_t * (1 - fy_t)
        + t10 * (1 - fx_t) * fy_t + t11 * fx_t * fy_t
    ).astype(np.float64)
    # Depth along camera z: transform plane hits into the camera frame.
    Tcw0 = np.linalg.inv(pose_wc.astype(np.float64))
    Xc = Xw @ Tcw0[:3, :3].T + Tcw0[:3, 3]
    bg_depth = np.where(s > 0, Xc[..., 2], np.inf)
    depth = bg_depth.astype(np.float32) if with_depth else None

    Tcw = np.linalg.inv(pose_wc.astype(np.float64))
    p_c = (Tcw[:3, :3] @ world.points.T).T + Tcw[:3, 3]
    z = p_c[:, 2]
    order = np.argsort(-z)  # far first so near overwrites
    S = world.sprites.shape[1]
    r = S // 2
    for i in order:
        if z[i] <= 0.2:
            continue
        u = fx * p_c[i, 0] / z[i] + cx
        v = fy * p_c[i, 1] / z[i] + cy
        ui, vi = int(np.floor(u)), int(np.floor(v))
        if not (r + 1 <= ui < W - r - 2 and r + 1 <= vi < H - r - 2):
            continue
        # Sub-pixel placement: bilinearly shift the sprite by the fractional
        # offset so sprite structure moves continuously with the camera.
        du, dv = u - ui, v - vi
        sp = world.sprites[i]
        P = np.pad(sp, 1, mode="edge")
        # output[j,k] = sprite(j - dv, k - du), bilinear:
        shifted = (
            du * dv * P[0:S, 0:S]
            + (1 - du) * dv * P[0:S, 1 : S + 1]
            + du * (1 - dv) * P[1 : S + 1, 0:S]
            + (1 - du) * (1 - dv) * P[1 : S + 1, 1 : S + 1]
        )
        img[vi - r : vi + r + 1, ui - r : ui + r + 1] = shifted
        if with_depth:
            depth[vi - r : vi + r + 1, ui - r : ui + r + 1] = z[i]

    img = img + rng.normal(0.0, noise, size=img.shape)
    out_img = np.clip(img, 0, 255).astype(np.float32)
    if with_depth:
        depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
        return out_img, depth
    return out_img


def make_sequence(
    cam: CameraModel,
    n_frames: int = 30,
    n_points: int = 600,
    with_depth: bool = False,
    stereo_baseline: float = 0.0,
    seed: int = 0,
    radius: float = 0.8,
    forward: float = 1.5,
) -> SyntheticSequence:
    """Full sequence with ground-truth poses.  If ``stereo_baseline`` > 0,
    ``images`` has shape (F, 2, H, W) with the right camera displaced by
    -baseline along x."""
    world = make_world(n_points=n_points, seed=seed)
    poses = make_trajectory(
        n_frames=n_frames, radius=radius, forward=forward, seed=seed + 1
    )
    frames = []
    depths = [] if with_depth else None
    for f in range(n_frames):
        if stereo_baseline > 0.0:
            right = poses[f].copy()
            right[:3, 3] = right[:3, 3] + right[:3, :3] @ np.array(
                [stereo_baseline, 0, 0], np.float32
            )
            im_l = render_frame(world, poses[f], cam, seed=seed + 100 + f)
            im_r = render_frame(world, right, cam, seed=seed + 5000 + f)
            frames.append(np.stack([im_l, im_r]))
        elif with_depth:
            im, d = render_frame(
                world, poses[f], cam, seed=seed + 100 + f, with_depth=True
            )
            frames.append(im)
            depths.append(d)
        else:
            frames.append(render_frame(world, poses[f], cam, seed=seed + 100 + f))
    return SyntheticSequence(
        world=world,
        poses_wc=poses,
        images=np.stack(frames),
        depths=np.stack(depths) if depths is not None else None,
        timestamps=np.arange(n_frames, dtype=np.float64) / 30.0,
    )


def ate_rmse(est_poses_wc: np.ndarray, gt_poses_wc: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after SE3 (or Sim3) alignment —
    the TUM evaluate_ate.py metric the reference is scored with."""
    est = est_poses_wc[:, :3, 3].astype(np.float64)
    gt = gt_poses_wc[:, :3, 3].astype(np.float64)
    if align:
        # Umeyama alignment est -> gt (optionally with scale).
        mu_e, mu_g = est.mean(0), gt.mean(0)
        ec, gc = est - mu_e, gt - mu_g
        Sigma = gc.T @ ec / len(ec)  # target x source covariance
        U, D, Vt = np.linalg.svd(Sigma)
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        if with_scale:
            var_e = (ec**2).sum() / len(ec)
            s = (D * np.diag(S)).sum() / var_e
        else:
            s = 1.0
        t = mu_g - s * R @ mu_e
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


# ---------------------------------------------------------------------------
# Room world: 4 textured walls + circular trajectory (loop-closure fixture)
# ---------------------------------------------------------------------------


def render_room_frame(
    world: SyntheticWorld,
    pose_wc: np.ndarray,
    cam: CameraModel,
    half_x: float = 6.0,
    half_z: float = 6.0,
    noise: float = 2.0,
    seed: int = 0,
    with_depth: bool = False,
    supersample: int = 2,
):
    """Render a frame inside a rectangular room with 4 textured walls.

    Walls: x = +-half_x, z = +-half_z (each with its own texture seed so
    opposite walls don't alias in place recognition); floor/ceiling are
    featureless gray.  Landmark sprites splat on top as in render_frame.

    Rendered at ``supersample``x and box-downsampled: without the pixel-
    footprint integration a real sensor performs, glancing-angle texture
    aliases and binary descriptors decorrelate between frames.
    """
    ss = supersample
    H, W = cam.height * ss, cam.width * ss
    fx, fy = float(cam.fx) * ss, float(cam.fy) * ss
    cx, cy = float(cam.cx) * ss, float(cam.cy) * ss
    rng = np.random.default_rng(seed)

    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack(
        [(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1
    )
    Rwc = pose_wc[:3, :3].astype(np.float64)
    C = pose_wc[:3, 3].astype(np.float64)
    d_w = d_cam @ Rwc.T

    img = np.full((H, W), 100.0)
    depth_best = np.full((H, W), np.inf)

    # (axis, sign, texture seed): planes axis = sign * half
    walls = [
        (0, +1, half_x, 201), (0, -1, half_x, 202),
        (2, +1, half_z, 203), (2, -1, half_z, 204),
    ]
    for axis, sign, half, tseed in walls:
        tex = _plane_texture(seed=tseed)
        ts = tex.shape[0]
        denom = d_w[..., axis]
        s = (sign * half - C[axis]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        Xw = C + s[..., None] * d_w
        # In-plane coordinates: the other horizontal axis + y.
        other = 2 if axis == 0 else 0
        in_a = Xw[..., other]
        in_b = Xw[..., 1]
        hit = (
            (s > 0.1)
            & (np.abs(in_a) <= (half_z if axis == 0 else half_x) + 1e-6)
            & (np.abs(in_b) <= 6.0)
        )
        # Bilinear texture sample.
        txf = in_a * 24.0
        tyf = in_b * 24.0
        tx0 = np.floor(txf).astype(np.int64)
        ty0 = np.floor(tyf).astype(np.int64)
        fxw = txf - tx0
        fyw = tyf - ty0
        t00 = tex[ty0 % ts, tx0 % ts]
        t01 = tex[ty0 % ts, (tx0 + 1) % ts]
        t10 = tex[(ty0 + 1) % ts, tx0 % ts]
        t11 = tex[(ty0 + 1) % ts, (tx0 + 1) % ts]
        val = (
            t00 * (1 - fxw) * (1 - fyw) + t01 * fxw * (1 - fyw)
            + t10 * (1 - fxw) * fyw + t11 * fxw * fyw
        )
        # Camera-z depth: d_cam = (x, y, 1), so z_cam = s * d_cam_z = s.
        z_cam = s * d_cam[..., 2]
        closer = hit & (z_cam > 0) & (z_cam < depth_best)
        img = np.where(closer, val, img)
        depth_best = np.where(closer, z_cam, depth_best)

    # Landmark sprites (same splat as render_frame).
    Tcw = np.linalg.inv(pose_wc.astype(np.float64))
    p_c = (Tcw[:3, :3] @ world.points.T).T + Tcw[:3, 3]
    z = p_c[:, 2]
    order = np.argsort(-z)
    S = world.sprites.shape[1]
    r = S // 2
    for i in order:
        if z[i] <= 0.3:
            continue
        u = fx * p_c[i, 0] / z[i] + cx
        v = fy * p_c[i, 1] / z[i] + cy
        ui, vi = int(np.floor(u)), int(np.floor(v))
        if not (r + 1 <= ui < W - r - 2 and r + 1 <= vi < H - r - 2):
            continue
        if z[i] > depth_best[vi, ui] + 0.3:
            continue  # occluded by a wall
        du, dv = u - ui, v - vi
        # Upsample the sprite to the supersampled grid so its on-screen
        # size is resolution-independent.
        sp_hi = np.kron(world.sprites[i], np.ones((ss, ss), np.float32))
        if sp_hi.shape[0] % 2 == 0:  # keep an odd size so the slice is 2r+1
            sp_hi = np.pad(sp_hi, ((0, 1), (0, 1)), mode="edge")
        Sh = sp_hi.shape[0]
        rh = Sh // 2
        if not (rh + 1 <= ui < W - rh - 2 and rh + 1 <= vi < H - rh - 2):
            continue
        P = np.pad(sp_hi, 1, mode="edge")
        shifted = (
            du * dv * P[0:Sh, 0:Sh]
            + (1 - du) * dv * P[0:Sh, 1 : Sh + 1]
            + du * (1 - dv) * P[1 : Sh + 1, 0:Sh]
            + (1 - du) * (1 - dv) * P[1 : Sh + 1, 1 : Sh + 1]
        )
        img[vi - rh : vi + rh + 1, ui - rh : ui + rh + 1] = shifted
        if with_depth:
            depth_best[vi - rh : vi + rh + 1, ui - rh : ui + rh + 1] = z[i]

    # Box-downsample back to the target resolution.
    Ho, Wo = cam.height, cam.width
    img = img.reshape(Ho, ss, Wo, ss).mean(axis=(1, 3))
    img = img + rng.normal(0.0, noise, size=img.shape)
    out = np.clip(img, 0, 255).astype(np.float32)
    if with_depth:
        d = depth_best.reshape(Ho, ss, Wo, ss)[:, 0, :, 0]
        d = np.where(np.isfinite(d), d, 0.0).astype(np.float32)
        return out, d
    return out


def make_room_world(n_points: int = 500, half_x: float = 6.0,
                    half_z: float = 6.0, seed: int = 0) -> SyntheticWorld:
    """Landmarks in a shell just inside the 4 walls."""
    rng = np.random.default_rng(seed)
    pts = []
    per_wall = n_points // 4
    for axis, sign, half in [
        (0, 1, half_x), (0, -1, half_x), (2, 1, half_z), (2, -1, half_z)
    ]:
        other = 2 if axis == 0 else 0
        o_half = half_z if axis == 0 else half_x
        p = np.zeros((per_wall, 3))
        p[:, axis] = sign * (half - 0.05)
        p[:, other] = rng.uniform(-o_half + 0.5, o_half - 0.5, per_wall)
        p[:, 1] = rng.uniform(-4.0, 4.0, per_wall)
        pts.append(p)
    pts = np.concatenate(pts).astype(np.float32)
    base = make_world(n_points=len(pts), seed=seed)
    return SyntheticWorld(points=pts, sprites=base.sprites[: len(pts)])


def loop_poses(n_frames: int, circle_radius: float, extra_turns: float = 1.25) -> np.ndarray:
    """(F, 4, 4) float32 camera-to-world poses of ``make_loop_sequence``:
    round the circle, heading along its tangent."""
    poses = np.zeros((n_frames, 4, 4), np.float64)
    for i in range(n_frames):
        a = 2 * np.pi * extra_turns * i / n_frames
        pos = np.array(
            [circle_radius * np.sin(a), 0.0, -circle_radius * np.cos(a)]
        )
        # Heading: tangent direction (derivative of position).
        yaw = a
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        poses[i, 3, 3] = 1.0
    return poses.astype(np.float32)


def render_loop_frame(world, poses, f: int, cam: CameraModel, seed: int, with_depth: bool,
                      stereo_baseline: float, **room):
    """Frame ``f`` of ``make_loop_sequence``: the image (and depth), or the
    (2, H, W) stereo pair, each rendered with its own seed, so that frames
    render alike one by one or in any split over processes."""
    if stereo_baseline > 0.0:
        right = poses[f].copy()
        right[:3, 3] = right[:3, 3] + right[:3, :3] @ np.array(
            [stereo_baseline, 0, 0], np.float32
        )
        im_l = render_room_frame(world, poses[f], cam, seed=seed + 300 + f, **room)
        im_r = render_room_frame(world, right, cam, seed=seed + 7000 + f, **room)
        return np.stack([im_l, im_r])
    return render_room_frame(world, poses[f], cam, seed=seed + 300 + f,
                             with_depth=with_depth, **room)


def make_loop_sequence(
    cam: CameraModel,
    n_frames: int = 48,
    circle_radius: float = 2.5,
    n_points: int = 500,
    with_depth: bool = False,
    seed: int = 0,
    extra_turns: float = 1.25,
    stereo_baseline: float = 0.0,
    room_half: float = None,
) -> SyntheticSequence:
    """Circular trajectory inside the room: heading tangent to the circle,
    closing a full loop (slightly more than 360 deg so the start viewpoint
    is revisited) — the loop-closure fixture.  ``stereo_baseline`` > 0
    renders (F, 2, H, W) stereo pairs (the KITTI-class fixture);
    ``room_half`` scales the room for large circles."""
    kwargs = {}
    if room_half is not None:
        kwargs["half_x"] = room_half
        kwargs["half_z"] = room_half
    world = make_room_world(n_points=n_points, seed=seed, **kwargs)
    poses = loop_poses(n_frames, circle_radius, extra_turns)
    frames, depths = [], ([] if with_depth else None)
    for f in range(n_frames):
        out = render_loop_frame(world, poses, f, cam, seed, with_depth, stereo_baseline,
                                **kwargs)
        if with_depth:
            frames.append(out[0])
            depths.append(out[1])
        else:
            frames.append(out)
    return SyntheticSequence(
        world=world,
        poses_wc=poses,
        images=np.stack(frames),
        depths=np.stack(depths) if depths is not None else None,
        timestamps=np.arange(n_frames, dtype=np.float64) / 30.0,
    )
