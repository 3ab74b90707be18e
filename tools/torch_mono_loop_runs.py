"""Run the port's mono loop fixture from frame 0 on the CPU.

    python tools/torch_mono_loop_runs.py [--threads N] [--draws S [S ...]]
                                         [--jobs J] [--frames N]
                                         [--digest DIR [--tag TAG]]
    python tools/torch_mono_loop_runs.py --compare A.npz B.npz
    python tools/torch_mono_loop_runs.py --threads N --replay F [--times R]

The fixture is the reference's ``tests/test_slam_e2e.py::
test_mono_loop_closure_production_config``: ``chip_smoke.MONO_LOOP_SEQ`` at
``chip_smoke.mono_loop_settings()``, through ``SlamSystem(settings, "mono",
vocabulary=...)`` with the reference's vocabulary (from
``tests/torch_mono_loop_state.npz``).  Each run prints one JSON line: the
draw seed, torch's thread count, the frames at which a loop was corrected,
the loop edges and their Sim3 scales, the frames lost, the keyframes, the
Sim3-aligned ATE and the seconds.

``--draws``: one run per seed, ``--jobs`` at a time, each in a process of
its own with ``--threads`` torch threads (default 1).  Seed S seeds the
tracker's RANSAC generator with S and the loop closer's with S + 7, so
seed 0 is the system's own.  A run on the card draws other samples than
any of these (its generators are CUDA's), so the runs over seeds are the
spread of the fixture's outcome under the draws alone.
``--frames N`` stops each run after frame N - 1.  ``--digest DIR``: each
run also writes ``DIR/seed<S>_t<N><TAG>.npz`` (``--tag TAG``), the
tracker's state, the keyframe and point counts and a SHA-1 of every map
field after each frame.  ``--compare A B`` prints the first frame at which
two digests differ.  ``--replay F``: runs the first draw seed to frame F,
then tracks frame F ``--times`` times from copies of that state, each
under a dispatch mode that hashes every ATen operation's inputs and
outputs, and prints the first operation whose inputs are equal and whose
outputs differ between the copies (one that fills fresh memory aside),
and how many distinct outputs 100 calls of it on one copy's inputs give.
"""

import argparse
import hashlib
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def run_one(seed, threads, images, gt, digest, tag=""):
    """One run from frame 0; returns its JSON-able result."""
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    from orbslam2_tpu_torch.utils import synthetic

    system = fixture_system(seed)
    rec = {"state": [], "n_kf": [], "n_pt": [], "map": []}
    corrected, n_edges = [], 0
    t0 = time.perf_counter()
    for i in range(len(images)):
        system.track_monocular(torch.as_tensor(images[i]), float(i))
        if len(system.loop_closer.loop_edges) > n_edges:
            n_edges = len(system.loop_closer.loop_edges)
            corrected.append(i)
        m = system.map
        rec["state"].append(int(system.tracker.state))
        rec["n_kf"].append(int(m.n_kf))
        rec["n_pt"].append(int(m.n_pt))
        if digest:
            h = hashlib.sha1()
            for t in m:
                h.update(t.numpy().tobytes())
            rec["map"].append(h.hexdigest())
    system.shutdown()
    secs = time.perf_counter() - t0
    poses = system.poses_wc()
    if digest:
        np.savez(os.path.join(digest, f"seed{seed}_t{threads}{tag}.npz"),
                 **{k: np.asarray(v) for k, v in rec.items()}, poses=poses)
    lc = system.loop_closer
    return {"seed": seed, "threads": threads, "corrected_at": corrected,
            "edges": [(a, b) for a, b, _ in lc.loop_edges],
            "scales": [float(np.cbrt(np.linalg.det(S[:3, :3]))) for _, _, S in lc.loop_edges],
            "lost": rec["state"].count(2), "n_kf": int(system.map.n_kf),
            "ate_sim3_m": float(synthetic.ate_rmse(poses, gt, with_scale=True)),
            "secs": secs}


def fixture_system(seed):
    """The fixture's SlamSystem on the CPU, its generators seeded."""
    import chip_smoke as cs
    from orbslam2_tpu_torch import convert
    from orbslam2_tpu_torch.models.system import SlamSystem

    arrays, meta = cs.mono_loop_state()
    vocab = convert.vocabulary_from_numpy(dict(
        {k[6:]: v for k, v in arrays.items() if k.startswith("vocab.")},
        levels=meta["vocab_levels"]))
    system = SlamSystem(cs.mono_loop_settings(), "mono", vocabulary=vocab, device="cpu")
    system.tracker.generator.manual_seed(seed)
    system.loop_closer.generator.manual_seed(seed + 7)
    return system


def replay(seed, threads, images, frame, times):
    """``--replay``: the first ATen operation that gives other outputs for
    equal inputs when frame ``frame`` is tracked again from one state."""
    import copy

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    torch.set_num_threads(threads)
    system = fixture_system(seed)
    for i in range(frame):
        system.track_monocular(torch.as_tensor(images[i]), float(i))

    def digest(x):
        if x.is_meta:  # shape-only tensors (forward-mode AD's tangents, say)
            return "meta"
        return hashlib.sha1(x.detach().contiguous().numpy(force=True).tobytes()).hexdigest()

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
            outs = [a for a in tree_flatten(out)[0] if isinstance(a, torch.Tensor)]
            self.ops.append((str(func), [tuple(a.shape) for a in ins],
                             [digest(a) for a in ins], [digest(a) for a in outs]))
            return out

    def track_copy(log):
        gens = [system.tracker.generator, system.loop_closer.generator]
        memo = {id(g): torch.Generator() for g in gens}
        for g in gens:
            memo[id(g)].set_state(g.get_state())
        copied = copy.deepcopy(system, memo)
        log.ops = []
        with log:
            copied.track_monocular(torch.as_tensor(images[frame]), float(frame))
        return log.ops

    logs = [track_copy(Log()) for _ in range(times)]
    first = None
    for r, other in enumerate(logs[1:], 1):
        for k, (a, b) in enumerate(zip(logs[0], other)):
            if a[0] == b[0] and a[2] == b[2] and a[3] != b[3] and "empty" not in a[0]:
                print(f"copy {r}: operation {k} of {len(other)}, {a[0]} on inputs of shapes "
                      f"{a[1]}: equal inputs, other outputs")
                first = k if first is None else min(first, k)
                break
        else:
            print(f"copy {r}: all {len(other)} operations equal to the first copy's")
    if first is None:
        return

    class Keep(Log):
        """Keeps the arguments of operation ``first``."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if len(self.ops) == first:
                self.kept = tree_map(lambda a: a.clone() if isinstance(a, torch.Tensor) else a,
                                     (func, args, kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    keep = Keep()
    track_copy(keep)
    func, args, kwargs = keep.kept
    outs = {tuple(digest(a) for a in tree_flatten(func(*args, **kwargs))[0]
                  if isinstance(a, torch.Tensor)) for _ in range(100)}
    print(f"operation {first}, {func}, called 100 times on its inputs in this copy: "
          f"{len(outs)} distinct outputs with {threads} torch threads")


def compare(a, b):
    import numpy as np

    with np.load(a) as x, np.load(b) as y:
        n = min(len(x["map"]), len(y["map"]))
        for i in range(n):
            if any(x[k][i] != y[k][i] for k in ("state", "n_kf", "n_pt", "map")):
                print(f"first difference after frame {i}: state {x['state'][i]} / "
                      f"{y['state'][i]}, keyframes {x['n_kf'][i]} / {y['n_kf'][i]}, points "
                      f"{x['n_pt'][i]} / {y['n_pt'][i]}")
                return
        print(f"equal through frame {n - 1}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--draws", type=int, nargs="+", default=[0])
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--digest")
    ap.add_argument("--tag", default="")
    ap.add_argument("--frames", type=int)
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--replay", type=int)
    ap.add_argument("--times", type=int, default=3)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    import numpy as np

    import chip_smoke as cs

    seq = cs.render_sequence("mono_loop")[0]
    images, gt = np.asarray(seq.images), np.asarray(seq.poses_wc)
    if args.frames:
        images, gt = images[:args.frames], gt[:args.frames]
    if args.replay is not None:
        return replay(args.draws[0], args.threads, images, args.replay, args.times)
    if args.digest:
        os.makedirs(args.digest, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        futures = [pool.submit(run_one, s, args.threads, images, gt, args.digest, args.tag)
                   for s in args.draws]
        for f in futures:
            print(json.dumps(f.result()), flush=True)


if __name__ == "__main__":
    main()
