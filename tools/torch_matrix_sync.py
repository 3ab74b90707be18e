"""The accuracy matrix's rgbd_640 cell with synchronous mapping, frame by
frame, for either package.

``examples/torch_run_matrix.py`` and ``examples/run_matrix.py`` run the
cell with ``async_mapping=True``, where the frame at which a mapping job
is adopted depends on wall-clock time.  This runs the same cell
(640x480, 1000 features, the TUM1 operating point, ``chunk=8``, loop
closing on, the 500-frame loop of seed 5) with ``async_mapping=False``
on its first ``--frames`` frames, so that two runs can be compared frame
by frame.  Both packages load one vocabulary, trained once by the port
on the CPU from the frames the CLIs train on (every 20th of the 500),
and saved in ``--cache-dir``.

  python tools/torch_matrix_sync.py --package torch --device cpu --out A.npz
  JAX_PLATFORMS=cpu python tools/torch_matrix_sync.py --package jax --out B.npz
  python tools/torch_matrix_sync.py --compare A.npz B.npz
  JAX_PLATFORMS=cpu python tools/torch_matrix_sync.py --replay-mapping --frames 70
  python tools/torch_matrix_sync.py --device cuda --frames 90 --out C.npz \
      --dump-frames 1 2 --dump-dir D
  python tools/torch_matrix_sync.py --replay-dump D/frame1_cuda.pt [--against D2/frame1_cpu.pt]

Each run writes an npz: per frame the tracking state after the call (as
the CLIs count it), the trajectory's lost flag and reference keyframe,
the camera-to-world pose; the frame ids of the keyframes in the map; the
tracker's counters; for the port, per tracked frame the keyframe policy's
inputs and decision (``DECISION_COLUMNS``) and the frame's final
bindings.  ``--compare`` prints the first frame where two runs part, the
ATE and the tracked share of each.  ``--dump-frames`` saves, for each
frame named, the tracking step's inputs and outputs and every pose
optimization inside it; ``--replay-dump`` reruns those on the CPU from
the dumped inputs and prints where the CPU's decisions differ from the
dump's (each pose optimization's inliers with their chi2 against its
threshold, the step's bindings and pose), and with ``--against`` how the
dumped inputs differ from another run's of the same frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, ".."), os.path.join(HERE, "..", "examples")]

CELL = "rgbd_640"
N_LOOP = 500   # the matrix's sequence length: the loop's poses depend on it


def _vocab_frames():
    return list(range(0, N_LOOP, max(1, N_LOOP // 24)))


def load_or_render(n_frames, cache_dir, workers):
    """(images, depths) of frames 0..n_frames-1 and of the vocabulary's
    frames, the ground-truth poses, and the vocabulary's path."""
    import numpy as np

    import torch_run_matrix as trm

    settings, radius, room, n_pts = trm.cell_settings(640, 480, 1000)
    cache = os.path.join(cache_dir, f"torch_matrix_sync_{CELL}_{n_frames}.npz")
    larger = sorted((int(f.rsplit("_", 1)[1][:-4]), f) for f in
                    (os.listdir(cache_dir) if os.path.isdir(cache_dir) else [])
                    if f.startswith(f"torch_matrix_sync_{CELL}_") and f[-5:-4].isdigit())
    larger = [f for n, f in larger if n >= n_frames]
    if not os.path.exists(cache) and larger:
        cache = os.path.join(cache_dir, larger[0])
    vocab_path = os.path.join(cache_dir, f"torch_matrix_sync_{CELL}_vocab.npz")
    if not os.path.exists(cache):
        t0 = time.time()
        frames = sorted(set(range(n_frames)) | set(_vocab_frames()))
        spec = dict(settings=settings, radius=radius, room=room, n_pts=n_pts, n_frames=N_LOOP,
                    baseline=0.0, with_depth=True)
        parts = [frames[k::workers] for k in range(workers)]
        if workers > 1:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            with ProcessPoolExecutor(workers,
                                     mp_context=multiprocessing.get_context("spawn")) as pool:
                done = list(pool.map(trm.render_frames, [spec] * workers, parts))
        else:
            done = [trm.render_frames(spec, parts[0])]
        order = np.argsort(np.concatenate(parts))
        frame_ids = np.sort(np.concatenate(parts))
        images = np.stack([im for ims, _ in done for im in ims])[order]
        depths = np.stack([d for _, ds in done for d in ds])[order]
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cache, images=images.astype(np.uint8) if np.all(images == np.round(images))
                 and images.max() <= 255 else images, depths=depths, frame_ids=frame_ids)
        print(f"rendered {len(frame_ids)} frames in {time.time() - t0:.0f} s", flush=True)
    data = np.load(cache)
    images, depths, frame_ids = data["images"], data["depths"], data["frame_ids"]
    row = {int(f): i for i, f in enumerate(frame_ids)}
    if not os.path.exists(vocab_path):
        import torch

        from orbslam2_tpu_torch.ops.bow import train_vocabulary
        from orbslam2_tpu_torch.ops.extractor import OrbExtractor
        from orbslam2_tpu_torch.utils.vocab import save_vocabulary

        ex = OrbExtractor(settings.orb, settings.tpu, device="cpu")
        descs = []
        for f in _vocab_frames():
            fr = ex(torch.as_tensor(images[row[f]], dtype=torch.float32))
            descs.append(fr.desc.numpy()[fr.valid.numpy()].view(np.uint32))
        save_vocabulary(train_vocabulary(np.concatenate(descs), k=10, levels=4, seed=0),
                        vocab_path)
    from orbslam2_tpu_torch.utils import synthetic

    poses = synthetic.loop_poses(N_LOOP, radius, 1.25)[:n_frames]
    sel = [row[f] for f in range(n_frames)]
    return settings, images[sel], depths[sel], poses, vocab_path


DECISION_COLUMNS = ("ok", "n_inliers", "need_kf", "path", "kf_tracked", "n_close_tracked",
                    "n_close_total", "frames_since_kf")


def _cpu(x):
    import torch

    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x


def _wrap_calls(calls):
    """Wrap the port's pose optimization (as ``tracking`` calls it) and
    projection matching (``matcher.projection_match``) so that each call's
    inputs and outputs are appended to ``calls`` as CPU copies; returns a
    function that undoes the wrapping."""
    from orbslam2_tpu_torch.models import tracking as trk
    from orbslam2_tpu_torch.ops import matcher

    optimize, match = trk.pose_optimization, matcher.projection_match

    def recorded_optimize(T, obs, cam, *a, **kw):
        res = optimize(T, obs, cam, *a, **kw)
        calls.append(("pose", _cpu((T, obs)), _cpu(res)))
        return res

    def recorded_match(*a, **kw):
        res = match(*a, **kw)
        calls.append(("match", _cpu((a, kw)), _cpu(res)))
        return res

    trk.pose_optimization, matcher.projection_match = recorded_optimize, recorded_match

    def undo():
        trk.pose_optimization, matcher.projection_match = optimize, match

    return undo


def install_recorder(dump_frames, dump_dir, device):
    """Wrap the port's tracking step (``track_fused._fused_track``, one
    call per tracked frame from frame 1 on); returns the record: per frame
    the keyframe policy's inputs and decision (DECISION_COLUMNS, as
    ``_fused_track`` computes them) and the final bindings; for each frame
    in ``dump_frames`` a file in ``dump_dir`` with the step's inputs and
    outputs and every pose optimization and projection match inside it."""
    import torch

    from orbslam2_tpu_torch.models import track_fused as tf

    rec = {"rows": [], "bindings": []}
    step = tf._fused_track
    calls = []
    _wrap_calls(calls)

    def recorded_step(m, frame, ctx, cam, sf, inv_s2, th_depth, **kw):
        calls.clear()
        out = step(m, frame, ctx, cam, sf, inv_s2, th_depth, **kw)
        fid = len(rec["rows"]) + 1
        mm, P = out.m, out.m.pt_capacity
        obs_ok = (mm.kf_point >= 0) & mm.kf_kp_valid & mm.kf_valid[:, None]
        counts = torch.bincount(torch.where(obs_ok, mm.kf_point, P).reshape(-1).long(),
                                minlength=P + 1)[:P]
        ref_pid = mm.kf_point[ctx.ref_kf]
        ref_bound = (ref_pid >= 0) & mm.kf_kp_valid[ctx.ref_kf]
        min_obs = 3 if int(mm.n_kf) > 2 else (2 if int(mm.n_kf) > 1 else 1)
        kf_tracked = int((ref_bound & (counts[ref_pid.clamp(min=0).long()] >= min_obs)).sum())
        close = (frame.depth > 0) & (frame.depth < th_depth)
        flags = out.flags.tolist()
        rec["rows"].append(flags + [kf_tracked, int((close & (out.bindings >= 0)).sum()),
                                    int((close & frame.valid).sum()), int(ctx.frames_since_kf)])
        rec["bindings"].append(out.bindings.cpu().numpy())
        if fid in dump_frames:
            os.makedirs(dump_dir, exist_ok=True)
            torch.save({"frame_id": fid, "device": device, "inputs": _cpu(
                (m, frame, ctx, cam, sf, inv_s2, th_depth)), "kw": kw,
                "T_cw": _cpu(out.T_cw), "bindings": _cpu(out.bindings), "flags": flags,
                "calls": list(calls)},
                os.path.join(dump_dir, f"frame{fid}_{device.split(':')[0]}.pt"))
        return out

    tf._fused_track = recorded_step
    return rec


def _max_diff(a, b):
    import torch

    if not torch.is_tensor(a):
        return 0.0 if a == b else float("inf")
    if a.dtype.is_floating_point:
        return float((a - b).abs().max()) if a.numel() else 0.0
    return float((a != b).sum())


def _match_parting(card, cpu):
    """Where two projection matches' outputs differ: per source row the
    decision on each side and what decided it (the window test
    d2 <= rr2 of the chosen keypoint, the best and second distances
    against the gates)."""
    (a, kw), out_a = card
    (b, _), out_b = cpu
    rows = torch_nonzero((out_a.ok != out_b.ok) | (out_a.ok & (out_a.idx != out_b.idx)))
    res = []
    for s in rows[:8]:
        one = {"source": s, "ok": [bool(out_a.ok[s]), bool(out_b.ok[s])],
               "idx": [int(out_a.idx[s]), int(out_b.idx[s])],
               "best": [int(out_a.dist[s]), int(out_b.dist[s])],
               "second": [int(out_a.dist2[s]), int(out_b.dist2[s])],
               "ratio_gate": kw.get("ratio"), "max_dist": kw.get("max_dist")}
        for side, args in (("card", a), ("cpu", b)):
            uv, rr2, xy = args[0], args[1], args[5]
            for k in {int(out_a.idx[s]), int(out_b.idx[s])}:
                if k >= 0:
                    d2 = float(((uv[s] - xy[k]) ** 2).sum())
                    one[f"{side}_d2_to_kp{k}"] = [d2, float(rr2[s])]
        res.append(one)
    return res


def torch_nonzero(mask):
    import torch

    return torch.nonzero(mask).flatten().tolist()


def _ulp_spread(T, obs, cam, res, n):
    """The pose optimization rerun ``n`` times with every observed pixel
    moved by at most one float32 ulp (a seeded draw): the spread of the
    final pose, and the chi2 range of each observation whose inlier flag
    changes in some run."""
    import torch

    gen = torch.Generator().manual_seed(0)
    from orbslam2_tpu_torch.solvers.pose_opt import pose_optimization

    poses, chi2s, flips = [], [], torch.zeros_like(obs.valid)
    for _ in range(n):
        step = torch.randint(-1, 2, obs.uv.shape, generator=gen).to(torch.float32)
        uv = torch.nextafter(obs.uv, obs.uv + step * torch.inf)
        uv = torch.where(step == 0, obs.uv, uv)
        r = pose_optimization(T, obs._replace(uv=uv), cam)
        poses.append(r.T_cw)
        chi2s.append(r.chi2)
        flips |= r.inlier != res.inlier
    P, C = torch.stack(poses), torch.stack(chi2s)
    return {"runs": n, "pose_spread": float((P.amax(0) - P.amin(0)).abs().max()),
            "flipping_obs": [{"obs": i, "chi2_min": float(C[:, i].min()),
                              "chi2_max": float(C[:, i].max())}
                             for i in torch_nonzero(flips)]}


def replay_dump(path, against=None, ulp_runs=0):
    """The dumped tracking step rerun on the CPU from its own inputs: the
    calls inside it are walked in order beside the dump's, and the first
    whose outputs differ is printed with what decided it.  ``ulp_runs``:
    each pose optimization is also rerun so many times on inputs moved by
    one ulp (``_ulp_spread``)."""
    import torch

    from orbslam2_tpu_torch.models import track_fused as tf
    from orbslam2_tpu_torch.solvers.pose_opt import pose_optimization

    d = torch.load(path, map_location="cpu", weights_only=False)
    m, frame, ctx, cam, sf, inv_s2, th_depth = d["inputs"]
    print(f"frame {d['frame_id']} dumped on {d['device']}: calls "
          f"{[c[0] for c in d['calls']]}, flags {d['flags']}")
    # Each pose optimization alone, from the dump's own inputs.
    for k, (kind, (T, obs), res) in enumerate(d["calls"]):
        if kind != "pose":
            continue
        cpu = pose_optimization(T, obs, cam)
        th = torch.where(obs.ur >= 0, 7.815, 5.991)
        print(json.dumps({"call": k, "alone": "pose optimization from the dump's inputs",
                          "observations": int(obs.valid.sum()),
                          "inliers": [int(res.n_inliers), int(cpu.n_inliers)],
                          "pose_max_abs_diff": _max_diff(cpu.T_cw, res.T_cw),
                          "inlier_differs": [
                              {"obs": i, "chi2_dump": float(res.chi2[i]),
                               "chi2_cpu": float(cpu.chi2[i]), "threshold": float(th[i])}
                              for i in torch_nonzero(cpu.inlier != res.inlier)]}))
        if ulp_runs:
            print(json.dumps({"call": k, "one_ulp_inputs": _ulp_spread(T, obs, cam, res,
                                                                      ulp_runs)}))
    # The whole step, its calls walked beside the dump's.
    calls = []
    undo = _wrap_calls(calls)
    try:
        out = tf._fused_track(m, frame, ctx, cam, sf, inv_s2, th_depth, **d["kw"])
    finally:
        undo()
    for k, (c_card, c_cpu) in enumerate(zip(d["calls"], calls)):
        kind = c_card[0]
        if kind != c_cpu[0]:
            print(json.dumps({"call": k, "parting": f"{kind} on the dump, {c_cpu[0]} here"}))
            break
        if kind == "pose":
            (T_a, obs_a), res_a = c_card[1], c_card[2]
            (T_b, obs_b), res_b = c_cpu[1], c_cpu[2]
            line = {"call": k, "kind": "pose", "input_pose_diff": _max_diff(T_a, T_b),
                    "input_obs_valid_differ": torch_nonzero(obs_a.valid != obs_b.valid),
                    "pose_max_abs_diff": _max_diff(res_a.T_cw, res_b.T_cw)}
            diff = torch_nonzero(res_a.inlier != res_b.inlier)
            th = torch.where(obs_a.ur >= 0, 7.815, 5.991)
            line["inlier_differs"] = [{"obs": i, "chi2_dump": float(res_a.chi2[i]),
                                       "chi2_cpu": float(res_b.chi2[i]),
                                       "threshold": float(th[i])} for i in diff]
            print(json.dumps(line))
            if diff or line["input_obs_valid_differ"]:
                break
        else:
            (a, _), res_a = c_card[1], c_card[2]
            (b, _), res_b = c_cpu[1], c_cpu[2]
            line = {"call": k, "kind": "match",
                    "input_uv_diff": _max_diff(a[0], b[0]), "input_rr2_diff": _max_diff(a[1], b[1]),
                    "input_valid_differ": torch_nonzero(a[4] != b[4]),
                    "partings": _match_parting(c_card[1:], c_cpu[1:])}
            print(json.dumps(line))
            if line["partings"] or line["input_valid_differ"]:
                break
    print(json.dumps({"step": "the tracking step on the CPU from the dumped inputs",
                      "flags": [out.flags.tolist(), d["flags"]],
                      "bindings_differ_at": torch_nonzero(out.bindings != d["bindings"]),
                      "pose_max_abs_diff": _max_diff(out.T_cw, d["T_cw"])}))
    if against:
        o = torch.load(against, map_location="cpu", weights_only=False)

        def diffs(a, b, name):
            if torch.is_tensor(a):
                return {name: _max_diff(a, b)}
            if isinstance(a, tuple) and hasattr(a, "_fields"):
                r = {}
                for f in a._fields:
                    r.update(diffs(getattr(a, f), getattr(b, f), f"{name}.{f}"))
                return r
            return {name: _max_diff(a, b)} if isinstance(a, (int, float, bool)) else {}

        names = ("m", "frame", "ctx", "cam", "sf", "inv_s2", "th_depth")
        r = {}
        for n, a, b in zip(names, d["inputs"], o["inputs"]):
            r.update(diffs(a, b, n))
        print(json.dumps({"inputs against": against,
                          "differences": {k: v for k, v in r.items() if v}}))
        print(json.dumps({"outputs against": against,
                          "bindings_differ_at": torch_nonzero(d["bindings"] != o["bindings"]),
                          "pose_max_abs_diff": _max_diff(d["T_cw"], o["T_cw"])}))


def run(package, device, n_frames, cache_dir, workers, out, dump_frames=(), dump_dir=None):
    import numpy as np

    settings, images, depths, poses_gt, vocab_path = load_or_render(n_frames, cache_dir, workers)
    rec = None
    if package == "torch":
        rec = install_recorder(set(dump_frames), dump_dir, device)
        from orbslam2_tpu_torch.models.system import SlamSystem
        from orbslam2_tpu_torch.utils.vocab import load_vocabulary

        system = SlamSystem(settings, "rgbd", vocabulary=load_vocabulary(vocab_path), chunk=8,
                            async_mapping=False, enable_loop_closing=True, device=device)
        n_kf = lambda: int(system.map.n_kf)  # noqa: E731
    else:
        import dataclasses

        import jax

        jax.config.update("jax_platforms", "cpu")
        from orbslam2_tpu import config as rc
        from orbslam2_tpu.models.system import Sensor, SlamSystem
        from orbslam2_tpu.utils.vocab import load_vocabulary

        ref = rc.Settings(camera=rc.CameraSettings(**dataclasses.asdict(settings.camera)),
                          orb=rc.OrbSettings(**dataclasses.asdict(settings.orb)),
                          tpu=rc.TpuSettings(**dataclasses.asdict(settings.tpu)))
        system = SlamSystem(ref, Sensor.RGBD, vocabulary=load_vocabulary(vocab_path), chunk=8,
                            async_mapping=False, enable_loop_closing=True)
        n_kf = lambda: int(np.asarray(system.map.n_kf))  # noqa: E731
    states = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        system.track_rgbd(images[i].astype(np.float32), depths[i], i / 10.0)
        states.append(int(system.tracking_state()))
        if (i + 1) % 20 == 0:
            print(f"[{package}] frame {i + 1}/{n_frames} lost={states.count(2)} "
                  f"n_kf={n_kf()} t={time.perf_counter() - t0:.0f}s", flush=True)
    system.shutdown()
    est = system.poses_wc()
    tr = system.tracker.trajectory
    host = (lambda t: t.cpu().numpy()) if package == "torch" else np.asarray
    kf_fid = host(system.map.kf_frame_id)[host(system.map.kf_valid)]
    metrics = {k: v for k, v in system.tracker.metrics.items() if isinstance(v, (int, float))}
    extra = {} if rec is None else dict(decisions=np.array(rec["rows"]),
                                        bindings=np.stack(rec["bindings"]))
    np.savez(out, state=np.array(states), lost=np.array([e[3] for e in tr]),
             ref_kf=np.array([e[2] for e in tr]), fid=np.array([e[0] for e in tr]),
             poses_wc=est, poses_gt=poses_gt, kf_frame_ids=np.sort(kf_fid),
             metrics=json.dumps(metrics), seconds=time.perf_counter() - t0, **extra)
    print(json.dumps(summary(np.load(out))), flush=True)


def replay_mapping(n_frames, cache_dir, workers):
    """The JAX package's run (as ``run``) to frame ``n_frames``, each of
    its mapping passes (``LocalMapper.process_keyframe``) then run again by
    the port's mapper on the CPU from the reference's input map: prints,
    per pass, the keyframe, its frame and the largest differences of the
    outputs (keyframe poses, point positions; integer and boolean fields
    equal or not)."""
    import dataclasses

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from orbslam2_tpu import config as rc
    from orbslam2_tpu.models.system import Sensor, SlamSystem
    from orbslam2_tpu.utils.vocab import load_vocabulary
    from orbslam2_tpu_torch import convert
    from orbslam2_tpu_torch.models.local_mapping import LocalMapper

    settings, images, depths, _, vocab_path = load_or_render(n_frames, cache_dir, workers)
    ref = rc.Settings(camera=rc.CameraSettings(**dataclasses.asdict(settings.camera)),
                      orb=rc.OrbSettings(**dataclasses.asdict(settings.orb)),
                      tpu=rc.TpuSettings(**dataclasses.asdict(settings.tpu)))
    system = SlamSystem(ref, Sensor.RGBD, vocabulary=load_vocabulary(vocab_path), chunk=8,
                        async_mapping=False, enable_loop_closing=True)
    passes = []
    inner = system.local_mapper.process_keyframe

    def recorded(m, kf_id, *a, **kw):
        out = inner(m, kf_id, *a, **kw)
        passes.append((jax.tree.map(np.array, m), int(kf_id), kw.get("n_now"),
                       jax.tree.map(np.array, out)))
        return out

    system.local_mapper.process_keyframe = recorded
    for i in range(n_frames):
        system.track_rgbd(images[i].astype(np.float32), depths[i], i / 10.0)
    system.tracker.flush()
    mapper = LocalMapper(settings, sensor="rgbd")
    for m_in, kf, n_now, want in passes:
        got = mapper.process_keyframe(convert.map_state_from_numpy(m_in, "cpu"), kf, n_now=n_now)
        diffs = {}
        for f in type(got)._fields:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            if b.dtype == np.uint32:  # descriptor words: the port keeps them as int32
                b = b.view(np.int32)
            if a.dtype.kind == "f":
                diffs[f] = float(np.abs(a - b).max())
            elif not np.array_equal(a, b):
                diffs[f] = int((a != b).sum())
        print(json.dumps({"kf": kf, "frame": int(m_in.kf_frame_id[kf]), "n_now": n_now,
                          "differences": diffs}), flush=True)


def summary(r):
    from orbslam2_tpu_torch.utils import synthetic

    est, gt = r["poses_wc"], r["poses_gt"]
    ok = ~r["lost"].astype(bool)
    return {
        "frames": int(len(r["state"])),
        "tracked_pct_cli": 100.0 * float((r["state"] == 1).mean()),
        "tracked_pct_trajectory": 100.0 * float(ok.mean()),
        "frames_lost": int((~ok).sum()),
        "first_lost": int(r["fid"][~ok][0]) if (~ok).any() else None,
        "keyframes": int(len(r["kf_frame_ids"])),
        "ate_m": float(synthetic.ate_rmse(est, gt, with_scale=False)),
        "ate_tracked_m": float(synthetic.ate_rmse(est[ok], gt[ok], with_scale=False))
        if ok.sum() > 2 else None,
        "metrics": json.loads(str(r["metrics"])),
        "seconds": float(r["seconds"]),
    }


def compare(a_path, b_path):
    import numpy as np

    a, b = np.load(a_path), np.load(b_path)
    out = {"a": summary(a), "b": summary(b)}
    n = min(len(a["lost"]), len(b["lost"]))
    firsts = {}
    for key in ("state", "lost", "ref_kf"):
        d = np.nonzero(a[key][:n] != b[key][:n])[0]
        firsts[key] = int(d[0]) if d.size else None
    kfa, kfb = list(a["kf_frame_ids"]), list(b["kf_frame_ids"])
    firsts["keyframe_ids"] = next((int(min(x, y)) for x, y in zip(kfa, kfb) if x != y), None)
    if "decisions" in a and "decisions" in b:
        # Row j is frame j + 1 (frame 0 initializes).
        k = min(len(a["decisions"]), len(b["decisions"]))
        for key, x, y in (("bindings", a["bindings"][:k], b["bindings"][:k]),
                          ("n_inliers", a["decisions"][:k, 1], b["decisions"][:k, 1]),
                          ("need_kf", a["decisions"][:k, 2], b["decisions"][:k, 2])):
            d = np.nonzero((x != y).reshape(k, -1).any(1))[0]
            firsts[key] = int(d[0]) + 1 if d.size else None
        j = firsts["need_kf"]
        if j is not None:
            out["decision_at_first_need_kf_difference"] = {
                "frame": j, "columns": DECISION_COLUMNS,
                "a": a["decisions"][j - 1].tolist(), "b": b["decisions"][j - 1].tolist()}
    dist = np.linalg.norm(a["poses_wc"][:n, :3, 3] - b["poses_wc"][:n, :3, 3], axis=1)
    far = np.nonzero(dist > 0.01)[0]
    firsts["pose_1cm"] = int(far[0]) if far.size else None
    out["first_difference"] = firsts
    out["pose_dist_max_m"] = float(dist.max())
    out["pose_dist_at"] = {int(i): float(dist[i]) for i in range(0, n, max(1, n // 13))}
    print(json.dumps(out, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda", help="the port's torch device")
    ap.add_argument("--frames", type=int, default=261)
    ap.add_argument("--threads", type=int, default=1, help="torch threads on the CPU")
    ap.add_argument("--workers", type=int, default=1, help="render processes")
    ap.add_argument("--cache-dir", default=os.path.join(HERE, "..", "build", "matrix_sync"))
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar="NPZ")
    ap.add_argument("--replay-mapping", action="store_true",
                    help="the JAX package's mapping passes rerun by the port's mapper")
    ap.add_argument("--dump-frames", type=int, nargs="*", default=(),
                    help="frames whose tracking step is saved (the port)")
    ap.add_argument("--dump-dir", default=os.path.join(HERE, "..", "build", "matrix_sync_dumps"))
    ap.add_argument("--replay-dump", metavar="PT", help="rerun a dumped step on the CPU")
    ap.add_argument("--against", metavar="PT", help="another run's dump of the same frame")
    ap.add_argument("--ulp-runs", type=int, default=0,
                    help="rerun each dumped pose optimization on inputs moved by one ulp")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    if args.replay_dump:
        import torch

        torch.set_num_threads(args.threads)
        replay_dump(args.replay_dump, args.against, args.ulp_runs)
        return 0
    import torch

    torch.set_num_threads(args.threads)
    if args.replay_mapping:
        replay_mapping(args.frames, args.cache_dir, args.workers)
        return 0
    run(args.package, args.device, args.frames, args.cache_dir, args.workers, args.out,
        args.dump_frames, args.dump_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
