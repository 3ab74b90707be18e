"""The reference's trajectory error on ``chip_smoke.py``'s sequences.

    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py            # RGB-D
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --stereo   # stereo
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --reloc    # kidnap
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --reloc-carried
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --loop [--small] [--frames N]

Runs the JAX tracker with its LocalMapper (loop closing and the BoW
database off), the configuration ``chip_smoke.py`` drives the port in, and
prints one JSON line: the ATE with mapping on, the keyframes created and
the per-frame states.  ``chip_smoke.py``'s ATE limits are derived from it.

* RGB-D: the smoke run's bench settings (640x480, 1000 features, 8 levels,
  128 keyframes, 16384 points) on its 24-frame sequence (seed 0).
* ``--stereo``: the KITTI operating point of ``examples/run_matrix.py``
  (1241x376, fx 718.856, bf 386.1448, th_depth 35, 2000 features, 8
  levels, 2048 keypoints, 256 keyframes, 65536 points) on the smoke run's
  24-frame stereo sequence (baseline bf / fx).
* ``--reloc``: the kidnap of ``chip_smoke.py``'s ``reloc`` phase at the
  bench settings: ``SlamSystem`` (synchronous mapping, loop closing off,
  so with its keyframe database) on ``make_loop_sequence(n_frames=48,
  circle_radius=1.5, seed=5, n_points=900)`` fed frames 0-23 and then 4-7,
  with a vocabulary (k=10, L=4) trained on the descriptors of frames 0, 4,
  ..., 20.  Prints the ATE over the fed frames and over the tracked ones
  (state OK: a lost frame holds the last pose; SE(3) alignment), the
  relocalization count, the first frame (position in the feed) that
  relocalized, and the per-frame states and paths.
* ``--reloc-carried``: the same kidnap through the reference and, on the
  CPU, through the port twice, both drawing the reference's RANSAC
  samples (``torch_carried_tracker.JaxSampler``): from frame 0, and
  carried from the reference's whole state before fed frame
  ``RELOC_CARRY_AT`` (``carry_tracker``), the first frame that the port's
  run from frame 0 loses and the reference tracks.  Prints, for each run,
  the per-frame states, paths and counts, the ATEs, and the per-frame
  distance of its poses from the reference's (translation, m; rotation,
  rad).  It shows where the port's run from frame 0 parts from the
  reference and whether the port follows the reference through the loss
  and the relocalization from the same state (``chip_smoke.py``'s
  ``reloc`` limits cite it).  About 25 minutes and 3 GB on the CPU.
* ``--loop``: the loop closing fixture of ``tests/test_slam_e2e.py::
  TestLoopClosing`` (``make_loop_sequence(n_frames=84, circle_radius=1.5,
  with_depth=True, seed=5)``, a vocabulary (k=10, L=4) trained on every
  6th frame's descriptors, local BA and fuse off) through the reference's
  ``SlamSystem`` with its defaults, loop closing on and then off, at the
  bench settings (640x480, 1000 features) with the fixture's baseline (bf
  = 0.5 fx; ``--small``: the test's 320x240 settings, bf 160).  ``--frames N`` lengthens the circle (``extra_turns``
  grows with it so the frames keep their spacing).  Prints, for each run,
  the ATE, the keyframe count, the loop edges, the per-frame states, and
  for loop closing every Sim3 verification: current and loop keyframe,
  the gate scalars (matches, distinct, RANSAC ok, inliers, projections),
  the retry pass and the outcome.  ``chip_smoke.py``'s ``loop`` limits
  come from it.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings  # noqa: E402
from orbslam2_tpu.models.local_mapping import LocalMapper  # noqa: E402
from orbslam2_tpu.models.tracking import Tracker  # noqa: E402
from orbslam2_tpu.utils import synthetic  # noqa: E402

N_FRAMES = 24
# chip_smoke.py's kidnap (RELOC_SEQ and RELOC_FEED there).
RELOC_SEQ = dict(n_frames=48, circle_radius=1.5, with_depth=True, seed=5, n_points=900)
RELOC_FEED = list(range(24)) + [4, 5, 6, 7]
RELOC_CARRY_AT = 16
# chip_smoke.py's stereo sequence (STEREO_SEQ there).
STEREO_SEQ = dict(n_points=3000, seed=1, radius=0.4, forward=0.8)


def smoke_settings():
    """chip_smoke.py's bench_settings, in the reference's types."""
    return Settings(
        camera=CameraSettings(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                              width=640, height=480, bf=40.0, th_depth=40.0),
        orb=OrbSettings(n_features=1000, n_levels=8),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=128, max_points=16384),
    )


def kitti_settings():
    """chip_smoke.py's kitti_settings, in the reference's types."""
    return Settings(
        camera=CameraSettings(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                              width=1241, height=376, bf=386.1448, th_depth=35.0),
        orb=OrbSettings(n_features=2000, n_levels=8),
        tpu=TpuSettings(max_keypoints=2048, max_keyframes=256, max_points=65536),
    )


def reloc_setup():
    from orbslam2_tpu.ops.bow import train_vocabulary
    from orbslam2_tpu.ops.extractor import OrbExtractor

    s = smoke_settings()
    seq = synthetic.make_loop_sequence(s.camera_model(), **RELOC_SEQ)
    ex = OrbExtractor(s.orb, s.tpu)
    descs = np.concatenate([np.asarray(f.desc)[np.asarray(f.valid)]
                            for f in (ex(seq.images[i]) for i in range(0, 24, 4))])
    return s, seq, train_vocabulary(descs, k=10, levels=4, seed=0)


def reloc_main():
    from orbslam2_tpu.models.system import Sensor, SlamSystem

    s, seq, vocab = reloc_setup()
    system = SlamSystem(s, Sensor.RGBD, enable_loop_closing=False, vocabulary=vocab)
    states, paths = [], []
    for j, i in enumerate(RELOC_FEED):
        system.track_rgbd(seq.images[i], seq.depths[i], float(j))
        states.append(int(system.tracker.state))
        paths.append(system.tracker.metrics["track_path"])
    poses = system.poses_wc()
    gt = seq.poses_wc[RELOC_FEED]
    ok = np.asarray(states) == 1
    print(json.dumps({
        "ate_m": float(synthetic.ate_rmse(poses, gt, with_scale=False)),
        "ate_tracked_m": float(synthetic.ate_rmse(poses[ok], gt[ok], with_scale=False)),
        "relocalizations": system.tracker.metrics["relocalizations"],
        "first_reloc": paths.index("reloc") if "reloc" in paths else None,
        "keyframes_created": system.tracker.metrics["keyframes_created"],
        "states": states,
        "paths": paths,
    }))


def _rot_angle(R):
    return float(np.arctan2(np.linalg.norm(R - R.T) / np.sqrt(2.0), np.trace(R) - 1.0))


def reloc_carried_main():
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu_torch import convert
    from orbslam2_tpu_torch.models.system import SlamSystem as PortSystem
    from torch_carried_tracker import JaxSampler, carry_tracker

    s, seq, vocab = reloc_setup()
    ts = convert.settings_from_reference(s)
    port_vocab = convert.vocabulary_from_numpy(jax.tree.map(np.asarray, vocab))
    ref = SlamSystem(s, Sensor.RGBD, enable_loop_closing=False, vocabulary=vocab)
    runs = {"port": PortSystem(ts, "rgbd", enable_loop_closing=False, vocabulary=port_vocab,
                               device="cpu"),
            "carried": PortSystem(ts, "rgbd", enable_loop_closing=False, vocabulary=port_vocab,
                                  device="cpu")}
    runs["port"].tracker._ransac_samples = JaxSampler(ref.tracker.init_key)
    logs = {"ref": [], "port": [], "carried": []}
    for j, i in enumerate(RELOC_FEED):
        if j == RELOC_CARRY_AT:
            carry_tracker(ref, runs["carried"])
        for name, system in (("ref", ref), ("port", runs["port"]), ("carried", runs["carried"])):
            if name == "carried" and j < RELOC_CARRY_AT:
                continue
            system.track_rgbd(seq.images[i], seq.depths[i], float(j))
            m = system.tracker.metrics
            logs[name].append((int(system.tracker.state), m["track_path"],
                               m["relocalizations"], m["keyframes_created"]))
    gt = seq.poses_wc[RELOC_FEED]
    ref_poses = ref.poses_wc()
    out = {}
    for name, system in (("ref", ref),) + tuple(runs.items()):
        poses = np.asarray(system.poses_wc(), np.float64)
        ok = np.array([st == 1 for st, *_ in logs[name]])
        own = slice(len(RELOC_FEED) - len(logs[name]), None)
        out[name] = {
            "ate_m": float(synthetic.ate_rmse(poses, gt, with_scale=False)),
            "ate_tracked_m": float(synthetic.ate_rmse(poses[own][ok], gt[own][ok],
                                                      with_scale=False)),
            "first_reloc": next((j for j, r in enumerate(logs[name]) if r[1] == "reloc"), None),
            "log": logs[name],
            "dt_m": [float(np.abs(a[:3, 3] - b[:3, 3]).max())
                     for a, b in zip(poses, ref_poses)],
            "dr_rad": [_rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(poses, ref_poses)],
        }
    out["carried"]["first_reloc"] = (None if out["carried"]["first_reloc"] is None
                                     else out["carried"]["first_reloc"] + RELOC_CARRY_AT)
    out["carry_at"] = RELOC_CARRY_AT
    print(json.dumps(out))


# chip_smoke.py's loop sequence (LOOP_SEQ there) and TestLoopClosing's.
LOOP_SEQ = dict(n_frames=84, circle_radius=1.5, with_depth=True, seed=5)


def loop_setup(small: bool, n_frames: int):
    from orbslam2_tpu.ops.bow import train_vocabulary
    from orbslam2_tpu.ops.extractor import OrbExtractor
    from test_slam_e2e import small_settings

    if small:
        s = small_settings(bf=160.0)
    else:
        # The bench settings with the fixture's baseline (bf / fx = 0.5, as
        # small_settings(bf=160) at fx 320): the depth below which points
        # are spawned stays the fixture's 20 m.
        s = smoke_settings()
        s = dataclasses.replace(s, camera=dataclasses.replace(s.camera, bf=0.5 * s.camera.fx))
    kw = dict(LOOP_SEQ, n_frames=n_frames)
    if n_frames != LOOP_SEQ["n_frames"]:
        kw["extra_turns"] = 1.25 * n_frames / LOOP_SEQ["n_frames"]
    seq = synthetic.make_loop_sequence(s.camera_model(), **kw)
    ex = OrbExtractor(s.orb, s.tpu)
    descs = np.concatenate([np.asarray(f.desc)[np.asarray(f.valid)]
                            for f in (ex(seq.images[i]) for i in range(0, n_frames, 6))])
    return s, seq, train_vocabulary(descs, k=10, levels=4, seed=0)


def loop_main(small: bool, n_frames: int):
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from torch_carried_tracker import record_sim3_gates

    s, seq, vocab = loop_setup(small, n_frames)
    out = {"small": small, "n_frames": n_frames}
    for lc_on in (True, False):
        system = SlamSystem(s, Sensor.RGBD, vocabulary=vocab, enable_loop_closing=lc_on)
        system.local_mapper.enable_ba = False
        system.local_mapper.enable_fuse = False
        verified = []
        if lc_on:
            record_sim3_gates(system.loop_closer, verified)
        states = []
        for i in range(n_frames):
            system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
            states.append(int(system.tracking_state()))
        run = {
            "ate_m": float(synthetic.ate_rmse(system.poses_wc(), seq.poses_wc, with_scale=False)),
            "n_kf": int(np.asarray(system.map.n_kf)),
            "keyframes_created": system.tracker.metrics["keyframes_created"],
            "states": states,
        }
        if lc_on:
            run["loop_edges"] = [(int(a), int(b)) for a, b, _ in system.loop_closer.loop_edges]
            run["verified"] = verified
            run["metrics"] = {k: v for k, v in system.loop_closer.metrics.items()
                              if isinstance(v, int)}
        out["on" if lc_on else "off"] = run
    print(json.dumps(out))


def main():
    jax.config.update("jax_platforms", "cpu")
    if "--loop" in sys.argv[1:]:
        args = sys.argv[1:]
        n = int(args[args.index("--frames") + 1]) if "--frames" in args else LOOP_SEQ["n_frames"]
        return loop_main("--small" in args, n)
    if "--reloc-carried" in sys.argv[1:]:
        return reloc_carried_main()
    if "--reloc" in sys.argv[1:]:
        return reloc_main()
    stereo = "--stereo" in sys.argv[1:]
    s = kitti_settings() if stereo else smoke_settings()
    cam = s.camera_model()
    if stereo:
        seq = synthetic.make_sequence(cam, n_frames=N_FRAMES,
                                      stereo_baseline=s.camera.bf / s.camera.fx, **STEREO_SEQ)
    else:
        seq = synthetic.make_sequence(cam, n_frames=N_FRAMES, n_points=1500, with_depth=True,
                                      seed=0, radius=0.25, forward=0.5)
    tr = Tracker(s, local_mapper=LocalMapper(s, sensor="stereo" if stereo else "rgbd"),
                 database=None, loop_closer=None)
    states = []
    for i in range(N_FRAMES):
        if stereo:
            tr.track_stereo(seq.images[i][0], seq.images[i][1], seq.timestamps[i])
        else:
            tr.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        states.append(int(tr.state))
    poses = tr.poses_wc()
    print(json.dumps({
        "ate_m": float(synthetic.ate_rmse(poses, seq.poses_wc)),
        "keyframes_created": tr.metrics["keyframes_created"],
        "n_kf": int(np.asarray(tr.map.n_kf)),
        "states": states,
    }))


if __name__ == "__main__":
    main()
