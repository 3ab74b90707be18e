"""The reference's trajectory error on ``chip_smoke.py``'s sequences.

    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py            # RGB-D
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --unfused  # RGB-D, unfused
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --stereo   # stereo
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --reloc    # kidnap
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --reloc-carried
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --loop [--small] [--frames N]
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --bench [--chunk N] [--async] [--frames N]
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --mono [--seed S] [--frames N] [--chunk N]
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --mono-loop
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --tum

Runs the JAX tracker with its LocalMapper (loop closing and the BoW
database off), the configuration ``chip_smoke.py`` drives the port in, and
prints one JSON line: the ATE with mapping on, the keyframes created and
the per-frame states.  ``chip_smoke.py``'s ATE limits are derived from it.

* RGB-D: the smoke run's bench settings (640x480, 1000 features, 8 levels,
  128 keyframes, 16384 points) on its 24-frame sequence (seed 0);
  ``--unfused`` tracks with the reference's step-by-step tracker
  (``use_fused=False``), as ``chip_smoke.py``'s ``unfused`` phase.
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
* ``--bench``: ``bench.py``'s configuration: its settings (the bench
  settings above) and 96-frame sequence (``make_sequence(n_frames=96,
  n_points=1500, seed=0, radius=0.35, forward=2.0)``) through the
  reference's ``SlamSystem(settings, "rgbd", enable_loop_closing=True)``
  with the per-frame driver, or ``--chunk N`` (bench.py's is 8), and
  synchronous mapping, or ``--async`` (bench.py's); ``--frames N`` feeds the
  sequence's first N frames.  Prints the ATE, the
  keyframes created, ``jobs_run``, the loop edges, the per-frame states
  and the wall time.  ``chip_smoke.py``'s ``drivers`` limits come from the
  synchronous chunk-8 run; the async run's numbers depend on when each
  job is adopted (wall-clock time) and are a class reference only.
* ``--mono``: ``chip_smoke.py``'s ``mono`` phase: the reference's
  ``SlamSystem(settings, "mono")`` with its defaults (synchronous mapping,
  the loop closer built with the scale free, the per-frame driver) at the
  bench settings on ``make_sequence(**MONO_SEQ)`` rendered without depth
  (``--seed`` and ``--frames`` try another sequence).  Prints the frame
  that initialized and its model (H or F), the inliers of the accepted
  two-view solve, every attempt's outcome, the keyframes created, the
  frames OK, the loop edges, the per-frame states and paths, and the ATE
  over the frames from initialization on, Sim3-aligned (mono has no
  scale).  ``--chunk N`` runs the chunked driver (``chunk=N``, mapping
  still synchronous) and prints the same.  ``chip_smoke.py``'s ``mono``
  limits come from it.
* ``--mono-loop``: ``tests/test_slam_e2e.py::TestLoopClosing::
  test_mono_loop_closure_production_config`` through the reference:
  ``small_settings(bf=0)`` with pools of 160 keyframes and 16384 points,
  ``make_loop_sequence(**MONO_LOOP_SEQ)`` and a vocabulary (k=10, L=4)
  trained on every 6th frame, ``SlamSystem(settings, "mono", vocabulary=...)``
  with loop closing on.  Prints the keyframe and frame at which the first
  loop fired, its edge, S_CL and its scale, the frames lost, the loop
  edges, the keyframes, the Sim3-aligned ATE and the run's seconds.
  ``save=`` (``tools/torch_mono_loop_state.py``) also writes the state just
  before the firing keyframe's ``process_keyframe`` to an ``.npz``.
  About 9 minutes on the CPU.
* ``--tum``: ``chip_smoke.py``'s ``dataset`` phase: the RGB-D sequence above
  written in the TUM RGB-D layout by ``chip_smoke.write_tum_fixture`` (8-bit
  images, 16-bit depth at DepthMapFactor 5000, the bench settings as a
  reference-format YAML) and read back by the reference's loaders
  (``utils/datasets.iter_tum_rgbd``) into the reference's
  ``SlamSystem(settings, "rgbd")`` with its defaults (synchronous mapping,
  loop closing on), as ``examples/run_dataset.py`` runs it.  Prints the ATE
  that ``examples/evaluate.py`` gives the written CameraTrajectory.txt
  against the written groundtruth.txt, the pairs, the keyframes, the loop
  edges and the per-frame states.  ``chip_smoke.py``'s ``dataset`` limit
  comes from it.
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


BENCH_SEQ = dict(n_frames=96, n_points=1500, with_depth=True, seed=0, radius=0.35, forward=2.0)


def bench_main(chunk: int, async_mapping: bool, n_frames: int = BENCH_SEQ["n_frames"]):
    import time

    from orbslam2_tpu.models.system import Sensor, SlamSystem

    s = smoke_settings()
    seq = synthetic.make_sequence(s.camera_model(), **BENCH_SEQ)
    t0 = time.perf_counter()
    system = SlamSystem(s, Sensor.RGBD, chunk=chunk, async_mapping=async_mapping,
                        enable_loop_closing=True)
    states = []
    for i in range(n_frames):
        system.track_rgbd(seq.images[i], seq.depths[i], float(i) / 30.0)
        states.append(int(system.tracking_state()))
    system.shutdown()
    poses = system.poses_wc()
    tr = system.tracker
    print(json.dumps({
        "chunk": chunk, "async_mapping": async_mapping, "n_frames": n_frames,
        "ate_m": float(synthetic.ate_rmse(poses, seq.poses_wc[:n_frames])),
        "keyframes_created": tr.metrics["keyframes_created"],
        "jobs_run": system.mapping_pipeline.jobs_run if system.mapping_pipeline else None,
        "n_kf": int(np.asarray(tr.map.n_kf)),
        "loop_edges": [(int(a), int(b)) for a, b, _ in system.loop_closer.loop_edges],
        "frames_lost": tr.metrics["frames_lost"],
        "states": states,
        "trajectory_lost": [int(f) for f, _, _, lost in tr.trajectory if lost],
        "wall_s": time.perf_counter() - t0,
    }))


# chip_smoke.py's mono sequence (MONO_SEQ there), rendered without depth.
MONO_SEQ = dict(n_frames=16, n_points=1500, seed=7, radius=0.25, forward=0.5)


def mono_main(seed: int, n_frames: int, chunk: int = 0):
    import time

    from orbslam2_tpu.models import tracking as jtracking
    from orbslam2_tpu.models.system import Sensor, SlamSystem

    s = smoke_settings()
    kw = dict(MONO_SEQ, seed=seed, n_frames=n_frames)
    seq = synthetic.make_sequence(s.camera_model(), **kw)
    attempts = []
    solve = jtracking.twoview.initialize_two_view

    def recorded(*a, **k):
        res = solve(*a, **k)
        attempts.append({"frame": len(states), "success": bool(res.success),
                         "used_h": bool(res.used_h), "n_inliers": int(res.n_inliers)})
        return res

    jtracking.twoview.initialize_two_view = recorded
    t0 = time.perf_counter()
    try:
        system = SlamSystem(s, Sensor.MONOCULAR, chunk=chunk)
        states, paths = [], []
        for i in range(n_frames):
            system.track_monocular(seq.images[i], seq.timestamps[i])
            states.append(int(system.tracking_state()))
            paths.append(system.tracker.metrics["track_path"])
        system.shutdown()
    finally:
        jtracking.twoview.initialize_two_view = solve
    poses = system.poses_wc()
    init = next((j for j, st in enumerate(states) if st == 1), None)
    won = [a for a in attempts if a["success"]]
    print(json.dumps({
        "sequence": kw,
        "chunk": chunk,
        "init_frame": init,
        "model": (("H" if won[0]["used_h"] else "F") if won else None),
        "init_inliers": won[0]["n_inliers"] if won else None,
        "attempts": attempts,
        "ate_sim3_m": (None if init is None else float(
            synthetic.ate_rmse(poses[init:], seq.poses_wc[init:], with_scale=True))),
        "keyframes_created": system.tracker.metrics["keyframes_created"],
        "n_kf": int(np.asarray(system.map.n_kf)),
        "n_points": int(np.asarray(system.map.pt_valid).sum()),
        "frames_ok": sum(st == 1 for st in states),
        "loop_edges": [(int(a), int(b)) for a, b, _ in system.loop_closer.loop_edges],
        "states": states,
        "paths": paths,
        "wall_s": time.perf_counter() - t0,
    }))


# tests/test_slam_e2e.py::test_mono_loop_closure_production_config's
# sequence and pools.
MONO_LOOP_SEQ = dict(n_frames=280, circle_radius=2.5, with_depth=False, seed=6, n_points=2500)
MONO_LOOP_POOLS = dict(max_keyframes=160, max_points=16384)


def mono_loop_setup():
    """The reference fixture's settings, sequence and vocabulary."""
    from orbslam2_tpu.ops.bow import train_vocabulary
    from orbslam2_tpu.ops.extractor import OrbExtractor
    from test_slam_e2e import small_settings

    s = small_settings(bf=0.0)
    s = dataclasses.replace(s, tpu=dataclasses.replace(s.tpu, **MONO_LOOP_POOLS))
    seq = synthetic.make_loop_sequence(s.camera_model(), **MONO_LOOP_SEQ)
    ex = OrbExtractor(s.orb, s.tpu)
    descs = np.concatenate([np.asarray(f.desc)[np.asarray(f.valid)]
                            for f in (ex(seq.images[i])
                                      for i in range(0, MONO_LOOP_SEQ["n_frames"], 6))])
    return s, seq, train_vocabulary(descs, k=10, levels=4, seed=0)


def _capture_first_loop(system, frame_of, draws, captured):
    """Wrap the loop closer's ``process_keyframe`` so that ``captured``
    receives, for the first call that adds a loop edge, the state it
    started from (map, database, streaks, edges, RANSAC key), the keyframe
    and frame, the Sim3 RANSAC draws it made and the map it returned."""
    lc = system.loop_closer
    inner = lc.process_keyframe

    def process(m, kf_id, abort=None):
        if captured:
            return inner(m, kf_id, abort)
        db = lc.db
        before = dict(
            m=jax.device_get(m), kf_id=int(kf_id), frame=frame_of(), key=np.asarray(lc.key),
            streak=[(list(map(int, g)), int(n)) for g, n in lc.candidate_streak.items()],
            edges=[(int(a), int(b), np.asarray(S, np.float32)) for a, b, S in lc.loop_edges],
            last_loop_kf=int(lc.last_loop_kf),
            db={name: jax.device_get(getattr(db, name)) for name in
                (("db_words", "db_weights") if db.sparse else ("bow",)) + ("has_entry",
                                                                           "db_nodes")},
        )
        del draws[:]
        out = inner(m, kf_id, abort)
        if len(lc.loop_edges) > len(before["edges"]):
            captured.update(before, out=jax.device_get(out), draws=list(draws))
        return out

    lc.process_keyframe = process


def _record_sim3_draws(draws):
    """Wrap the reference's ``sim3_ransac`` so that each call's samples
    (as ``jax.random.choice`` draws them from its key) go to ``draws``."""
    from orbslam2_tpu.ops import sim3_solve
    from torch_carried_tracker import _choice

    solve = sim3_solve.sim3_ransac

    def recorded(p1, p2, valid, max_err1, max_err2, cam, key, iters=128, **kw):
        draws.append(np.asarray(_choice(key, valid, iters, 3), np.int32))
        return solve(p1, p2, valid, max_err1, max_err2, cam, key, iters=iters, **kw)

    sim3_solve.sim3_ransac = recorded
    return solve


def save_mono_loop_state(path, captured, vocab, result):
    """Write the captured state (``_capture_first_loop``) to ``path``:
    ``map.<field>``, ``db.<name>``, ``vocab.<field>``, ``edges.S``, ``draws``,
    ``out.kf_pose_cw`` and ``out.pt_pos`` (the map the firing call returned)
    as arrays, and the host values as JSON in ``meta``."""
    arrays = {f"map.{k}": np.asarray(v) for k, v in captured["m"]._asdict().items()}
    arrays.update({f"db.{k}": np.asarray(v) for k, v in captured["db"].items()
                   if v is not None})
    arrays.update({f"vocab.{k}": np.asarray(getattr(vocab, k))
                   for k in ("node_desc", "children", "word_id", "idf")})
    arrays["edges.S"] = np.array([S for _, _, S in captured["edges"]],
                                 np.float32).reshape(-1, 4, 4)
    arrays["draws"] = np.stack(captured["draws"]).astype(np.int32)
    arrays["key"] = np.asarray(captured["key"], np.uint32)
    arrays["out.kf_pose_cw"] = np.asarray(captured["out"].kf_pose_cw)
    arrays["out.pt_pos"] = np.asarray(captured["out"].pt_pos)
    meta = dict(kf_id=captured["kf_id"], frame=captured["frame"],
                streak=captured["streak"], last_loop_kf=captured["last_loop_kf"],
                edges=[(a, b) for a, b, _ in captured["edges"]], vocab_levels=int(vocab.levels),
                feat_capacity=int(result.pop("_feat_capacity")),
                sparse=bool(result.pop("_sparse")), result=result)
    arrays["meta"] = np.array(json.dumps(meta))
    np.savez_compressed(path, **arrays)


def mono_loop_main(save=None):
    import time

    from orbslam2_tpu.models.system import Sensor, SlamSystem

    t0 = time.perf_counter()
    s, seq, vocab = mono_loop_setup()
    n = MONO_LOOP_SEQ["n_frames"]
    system = SlamSystem(s, Sensor.MONOCULAR, vocabulary=vocab, enable_loop_closing=True)
    states = []
    captured, draws = {}, []
    _capture_first_loop(system, lambda: len(states), draws, captured)
    solve = _record_sim3_draws(draws)
    try:
        for i in range(n):
            system.track_monocular(seq.images[i], seq.timestamps[i])
            states.append(int(system.tracking_state()))
        system.shutdown()
    finally:
        from orbslam2_tpu.ops import sim3_solve

        sim3_solve.sim3_ransac = solve
    lc = system.loop_closer
    edges = [(int(a), int(b)) for a, b, _ in lc.loop_edges]
    S = np.asarray(lc.loop_edges[0][2], np.float64) if edges else None
    result = {
        "sequence": MONO_LOOP_SEQ,
        "fired_kf": captured.get("kf_id"),
        "fired_frame": captured.get("frame"),
        "edge": edges[0] if edges else None,
        "S_CL": None if S is None else S.tolist(),
        "scale": None if S is None else float(np.cbrt(np.linalg.det(S[:3, :3]))),
        "frames_lost": sum(st == 2 for st in states),
        "loop_edges": edges,
        "n_kf": int(np.asarray(system.map.n_kf)),
        "keyframes_created": system.tracker.metrics["keyframes_created"],
        "ate_sim3_m": float(synthetic.ate_rmse(system.poses_wc(), seq.poses_wc,
                                               with_scale=True)),
        "draws": len(captured.get("draws", [])),
        "metrics": {k: v for k, v in lc.metrics.items() if isinstance(v, int)},
        "states": states,
        "wall_s": time.perf_counter() - t0,
    }
    print(json.dumps(result), flush=True)
    if save is not None and captured:
        db = lc.db
        save_mono_loop_state(save, captured, vocab,
                             dict(result, _feat_capacity=db._feat_capacity, _sparse=db.sparse))
    return result


def tum_main():
    import importlib.util
    import tempfile

    import chip_smoke
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.utils import datasets
    from orbslam2_tpu_torch.utils import synthetic as port_synthetic

    s = smoke_settings()
    # The port's renderer (numpy, the reference's copy) and writer: the
    # very files chip_smoke.py writes.
    seq = port_synthetic.make_sequence(s.camera_model(), n_frames=N_FRAMES, n_points=1500,
                                       with_depth=True, seed=0, radius=0.25, forward=0.5)
    spec = importlib.util.spec_from_file_location(
        "evaluate", str(Path(__file__).resolve().parent.parent / "examples" / "evaluate.py"))
    ev = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ev)
    with tempfile.TemporaryDirectory() as root:
        chip_smoke.write_tum_fixture(seq, root, chip_smoke.bench_settings())
        settings = Settings.from_yaml(str(Path(root) / "settings.yaml"), sensor="rgbd")
        system = SlamSystem(settings, Sensor.RGBD)
        states = []
        for ts, image, depth in datasets.iter_tum_rgbd(root, str(Path(root) / "associations.txt")):
            system.track_rgbd(image, depth, ts)
            states.append(int(system.tracking_state()))
        system.shutdown()
        traj = str(Path(root) / "CameraTrajectory.txt")
        system.save_trajectory_tum(traj)
        res = ev.evaluate_files(traj, str(Path(root) / "groundtruth.txt"), fmt="tum")
    tr = system.tracker
    print(json.dumps({
        "ate_m": float(res["ate_rmse_m"]),
        "pairs": res["pairs"],
        "keyframes_created": tr.metrics["keyframes_created"],
        "loop_edges": [(int(a), int(b)) for a, b, _ in system.loop_closer.loop_edges],
        "frames_lost": tr.metrics["frames_lost"],
        "states": states,
    }))


def main():
    jax.config.update("jax_platforms", "cpu")
    if "--tum" in sys.argv[1:]:
        return tum_main()
    if "--mono-loop" in sys.argv[1:]:
        return mono_loop_main()
    if "--mono" in sys.argv[1:]:
        args = sys.argv[1:]
        seed = int(args[args.index("--seed") + 1]) if "--seed" in args else MONO_SEQ["seed"]
        n = int(args[args.index("--frames") + 1]) if "--frames" in args else MONO_SEQ["n_frames"]
        chunk = int(args[args.index("--chunk") + 1]) if "--chunk" in args else 0
        return mono_main(seed, n, chunk)
    if "--bench" in sys.argv[1:]:
        args = sys.argv[1:]
        chunk = int(args[args.index("--chunk") + 1]) if "--chunk" in args else 0
        n = (int(args[args.index("--frames") + 1]) if "--frames" in args
             else BENCH_SEQ["n_frames"])
        return bench_main(chunk, "--async" in args, n)
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
                 database=None, loop_closer=None, use_fused="--unfused" not in sys.argv[1:])
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
