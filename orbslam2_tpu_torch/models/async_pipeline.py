"""Asynchronous local mapping and loop closing: the reference's thread
pipeline.

Port of ``orbslam2_tpu/models/async_pipeline.py``.  The reference spawns
``LocalMapping::Run`` and ``LoopClosing::Run`` as long-lived threads
(src/System.cc:≈90-100) that consume keyframe queues, so tracking never
waits on local BA or on a loop correction; the shared map is guarded by
mutexes.  Here the map is a functional struct of tensors, so the same
overlap needs no lock on the map:

  * when a keyframe is inserted, the tracker keeps its map (which already
    holds the keyframe) and submits a snapshot to a worker thread, which
    runs the mapping sequence (cull, triangulate, fuse, local BA, keyframe
    culling) and then loop closing on it;
  * while a job is in flight ``accept_keyframes()`` is False, the
    reference's ``SetAcceptKeyFrames(false)`` (LocalMapping.cc:≈30);
  * at a later frame boundary the tracker adopts the mapped state
    (``adopt_mapped_state``), folding back in what tracking changed since
    the snapshot.

At most one job is in flight, as the reference's LocalMapping processes
its queue strictly serially.

On a CUDA device the worker launches on CUDA streams of its own: they
wait for the tracker's stream at submission (the snapshot is cloned
there), and the caller's stream waits for them when the result is handed
back; every tensor of the result is then recorded on the caller's stream,
so the caching allocator reuses none of them under the tracker's work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Tuple

import torch

from . import map_state as ms

WORKER_THREAD = "mapping-worker"


def merge_tracking_stats(
    m_mapped: ms.MapState,
    snapshot: ms.MapState,
    m_tracked: ms.MapState,
) -> ms.MapState:
    """Fold the visibility and found statistics tracking accumulated since
    ``snapshot`` into the mapped state.  The deltas apply only to points
    that survived mapping with their identity intact (the same creation
    keyframe: a culled-and-reused slot inherits no foreign counters)."""
    same = (
        m_mapped.pt_valid
        & snapshot.pt_valid
        & (m_mapped.pt_first_kf == snapshot.pt_first_kf)
    )
    dv = m_tracked.pt_visible - snapshot.pt_visible
    df = m_tracked.pt_found - snapshot.pt_found
    return m_mapped._replace(
        pt_visible=m_mapped.pt_visible + torch.where(same, dv, 0),
        pt_found=m_mapped.pt_found + torch.where(same, df, 0),
    )


def adopt_mapped_state(
    m_mapped: ms.MapState,
    snapshot: ms.MapState,
    m_tracked: ms.MapState,
    job_kf: Optional[int] = None,
) -> ms.MapState:
    """The worker's mapped result plus everything the tracker changed since
    the snapshot:

      * the tracking statistics' deltas (``merge_tracking_stats``);
      * the keyframe rows created after the snapshot, [snapshot.n_kf,
        tracked.n_kf): rows come from the monotonic n_kf counter and only
        the tracker inserts, so those rows are the tracker's;
      * the map points the tracker spawned after the snapshot (close-depth
        points at keyframe creation).  The tracker takes point slots from
        the high end of the free list and the worker's triangulation from
        the low end (``tracking.add_points``'s ``reverse``); on a collision
        (pool pressure only) the worker's point stays and the binding
        scrub below drops the tracker's reference;
      * the binding scrub on the merged rows: a binding survives only if
        the final pool slot still holds the point it meant (the same
        pt_first_kf), as EraseObservation would leave it;
      * with ``job_kf`` given, the re-anchoring of the merged rows: they
        are in the snapshot's world frame, and a loop correction (or BA)
        moved the map, so they are expressed again through the job
        keyframe's pose delta R = T_j_snap^-1 T_j_mapped: pose rows become
        T_i R, positions p become R^-1 p and normals rotate with it (the
        reference CorrectLoop's correction of the keyframes the queue
        inserted during the job, LoopClosing.cc:≈330).

    As in the reference, R is inverted as a general 4x4 matrix and no Sim3
    scale is taken out of it; that matters only for mono, whose loop
    corrections carry a scale.  No host read."""
    m = merge_tracking_stats(m_mapped, snapshot, m_tracked)
    dev = m.kf_pose_cw.device
    K = m.kf_capacity
    rows = torch.arange(K, device=dev)
    new_kf = (rows >= snapshot.n_kf) & (rows < m_tracked.n_kf)

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    if job_kf is None:
        R = eye
    else:
        j = int(job_kf)
        T_snap = snapshot.kf_pose_cw[j]
        T_new = m_mapped.kf_pose_cw[j]
        R = torch.where(snapshot.kf_valid[j] & m_mapped.kf_valid[j],
                        torch.linalg.inv_ex(T_snap)[0] @ T_new, eye)
    # inv_ex: the inverse without its singularity check, which would read
    # the device.
    R_inv = torch.linalg.inv_ex(R)[0]

    def take_kf(a_mapped, a_tracked):
        return torch.where(new_kf.view((K,) + (1,) * (a_mapped.dim() - 1)), a_tracked, a_mapped)

    # Tracker-spawned points: new since the snapshot, and not overwritten
    # by a worker-created point in the same slot.
    trk_new = m_tracked.pt_valid & ~snapshot.pt_valid
    wrk_new = m_mapped.pt_valid & ~snapshot.pt_valid
    take_pt = trk_new & ~wrk_new
    P = m.pt_capacity

    def take_point(a_merged, a_tracked):
        return torch.where(take_pt.view((P,) + (1,) * (a_merged.dim() - 1)), a_tracked, a_merged)

    rot_inv = R_inv[:3, :3]
    m = m._replace(
        kf_pose_cw=take_kf(m.kf_pose_cw, m_tracked.kf_pose_cw @ R),
        kf_xy=take_kf(m.kf_xy, m_tracked.kf_xy),
        kf_level=take_kf(m.kf_level, m_tracked.kf_level),
        kf_angle=take_kf(m.kf_angle, m_tracked.kf_angle),
        kf_desc=take_kf(m.kf_desc, m_tracked.kf_desc),
        kf_ur=take_kf(m.kf_ur, m_tracked.kf_ur),
        kf_kp_valid=take_kf(m.kf_kp_valid, m_tracked.kf_kp_valid),
        kf_point=take_kf(m.kf_point, m_tracked.kf_point),
        kf_valid=take_kf(m.kf_valid, m_tracked.kf_valid),
        kf_frame_id=take_kf(m.kf_frame_id, m_tracked.kf_frame_id),
        kf_parent=take_kf(m.kf_parent, m_tracked.kf_parent),
        pt_pos=take_point(m.pt_pos, m_tracked.pt_pos @ rot_inv.T + R_inv[:3, 3]),
        pt_normal=take_point(m.pt_normal, m_tracked.pt_normal @ rot_inv.T),
        pt_desc=take_point(m.pt_desc, m_tracked.pt_desc),
        pt_min_dist=take_point(m.pt_min_dist, m_tracked.pt_min_dist),
        pt_max_dist=take_point(m.pt_max_dist, m_tracked.pt_max_dist),
        pt_ref_kf=take_point(m.pt_ref_kf, m_tracked.pt_ref_kf),
        pt_first_kf=take_point(m.pt_first_kf, m_tracked.pt_first_kf),
        pt_valid=take_point(m.pt_valid, m_tracked.pt_valid),
        pt_visible=take_point(m.pt_visible, m_tracked.pt_visible),
        pt_found=take_point(m.pt_found, m_tracked.pt_found),
        n_kf=torch.maximum(m.n_kf, m_tracked.n_kf),
        n_pt=torch.maximum(m.n_pt, m_tracked.n_pt),
    )
    # Binding scrub on the merged (tracker-owned) rows: keep a binding only
    # if the final pool still holds the point it meant.
    pid = m.kf_point.clamp(min=0).long()
    still = (m.kf_point >= 0) & m.pt_valid[pid] & (m.pt_first_kf[pid] == m_tracked.pt_first_kf[pid])
    kf_point = torch.where(new_kf[:, None], torch.where(still, m.kf_point, ms.NO_POINT),
                           m.kf_point)
    return m._replace(kf_point=kf_point)


def clone_map(m: ms.MapState) -> ms.MapState:
    """A map that owns copies of every tensor."""
    return ms.MapState._make(t.clone() for t in m)


def map_to(m: ms.MapState, device) -> ms.MapState:
    """The map on ``device`` (the same tensors where they are there)."""
    return ms.MapState._make(t.to(device) for t in m)


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class AsyncMappingPipeline:
    """Worker-thread driver of the per-keyframe mapping and loop-closing
    sequence.  The local mapper runs on ``device`` (default: the device of
    the submitted map) and the loop closer on its own device; the result
    comes back on the submitted map's device.  A worker exception is
    raised again in the thread that polls or waits."""

    def __init__(self, local_mapper, loop_closer=None, device=None):
        self.local_mapper = local_mapper
        self.loop_closer = loop_closer
        self.device = None if device is None else torch.device(device)
        self._thread: Optional[threading.Thread] = None
        self._result = None        # (mapped, snapshot, kf_id, pool_state, done events)
        self._error = None
        self._home = None          # the submitted map's device
        self._lock = threading.Lock()
        self.abort_gba = threading.Event()  # InterruptBA / mbStopGBA analog
        self.jobs_run = 0
        self.job_seconds = []      # host wall time of each finished job
        self._streams = {}         # CUDA device -> the worker's stream there

    # -- protocol (SetAcceptKeyFrames / queue) ------------------------------

    def accept_keyframes(self) -> bool:
        """False while a mapping job is in flight (LocalMapping's
        SetAcceptKeyFrames(false) during its work loop)."""
        return self._thread is None

    def _stream(self, dev: torch.device):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def submit(self, m: ms.MapState, kf_id: int):
        """Start the mapping and loop job for ``kf_id`` on a snapshot of
        ``m``; no other job may be in flight (``accept_keyframes``)."""
        assert self._thread is None, "one mapping job at a time"
        # Every tensor is copied (a move to another device copies): a later
        # in-place write to the tracker's map must not reach the worker's.
        home = m.pt_pos.device
        dev = _indexed(self.device) if self.device is not None else home
        snapshot = clone_map(m) if dev == home else map_to(m, dev)
        lc_dev = _indexed(self.loop_closer.device) if self.loop_closer is not None else dev
        cuda = sorted({d for d in (home, dev, lc_dev) if d.type == "cuda"}, key=str)
        ready = {}
        for d in cuda:
            ready[d] = torch.cuda.Event()
            ready[d].record(torch.cuda.current_stream(d))
        streams = {d: self._stream(d) for d in cuda}
        self._home = home
        self.abort_gba.clear()
        self._error = None
        kid = int(kf_id)

        def job():
            t0 = time.perf_counter()
            try:
                with contextlib.ExitStack() as stack:
                    for d, s in streams.items():
                        s.wait_event(ready[d])
                        stack.enter_context(torch.cuda.stream(s))
                    mm = self.local_mapper.process_keyframe(snapshot, kid, abort=self.abort_gba)
                    if self.loop_closer is not None:
                        mm = self.loop_closer.process_keyframe(map_to(mm, lc_dev), kid,
                                                               abort=self.abort_gba)
                    done = []
                    for s in streams.values():
                        done.append((s.device, torch.cuda.Event()))
                        done[-1][1].record(s)
                pool = getattr(self.loop_closer, "pool_state", None)
                with self._lock:
                    self._result = (mm, snapshot, kid, pool, done)
                    self.job_seconds.append(time.perf_counter() - t0)
            except BaseException as e:  # raised again in the caller's thread
                with self._lock:
                    self._error = e

        self._thread = threading.Thread(target=job, name=WORKER_THREAD, daemon=True)
        self._thread.start()
        self.jobs_run += 1

    def _finish(self):
        """Join the (finished) worker and hand back its result on the
        submitted map's device, raising a worker exception again here."""
        self._thread.join()
        self._thread = None
        with self._lock:
            err, self._error = self._error, None
            res, self._result = self._result, None
        if err is not None:
            raise err
        mm, snapshot, kid, pool, done = res
        for d, ev in done:
            torch.cuda.current_stream(d).wait_event(ev)
        mm, snapshot = map_to(mm, self._home), map_to(snapshot, self._home)
        for t in (*mm, *snapshot):
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
        return mm, snapshot, kid, pool

    def poll(self) -> Optional[Tuple[ms.MapState, ms.MapState, int, object]]:
        """Non-blocking: the finished job's (mapped, snapshot, kf_id,
        pool_state), or None while it runs or when nothing is in flight."""
        if self._thread is None or self._thread.is_alive():
            return None
        return self._finish()

    def wait(self, timeout: Optional[float] = None):
        """Block until the job in flight (if any) finishes and return it.
        Sets the GBA abort flag first (InterruptBA: tracking needs the map
        now, and the job skips what remains of its optional stages).  With
        ``timeout`` (seconds) the wait is bounded: a job still running past
        it is not adopted and None is returned, as the reference's tracking
        thread never blocks on LocalMapping."""
        if self._thread is None:
            return None
        self.abort_gba.set()
        if timeout is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return None
        return self._finish()
