"""Host-side SLAM facade: the single-writer tracking + mapping loop.

Port of the RGB-D and RGB-D inertial paths of ``visual_sgraphs_tpu/slam/
system.py`` (System::TrackRGBD, Tracking.cc state machine):

1. the first frame initialises the map (``_initialize``: the origin
   keyframe, every depth-valid keypoint a map point) into a host-chosen
   keyframe slot;
2. with ``pipeline_depth=1`` every later frame runs the tracking step
   (ORB, prediction, coarse / retry / fine tracking) and, one frame later,
   its host decisions (``_resolve_pending``): trajectory row, keyframe
   policy;
3. with ``pipeline_depth=B > 1`` (the B-frame pipeline, once the map
   holds 5 keyframes) frames are buffered B at a time; each full batch
   resolves the previous batch's decisions from one readback of its
   counters and board (``_resolve_batch_inner``), then dispatches one
   cycle (``slam/cycle_program.py``): the keyframe chosen out of the
   previous batch, then the tracking scan of the new batch.  A failed
   frame is tracked again against the current map, and opens a window of
   2B frames on the serial path;
4. a keyframe runs the keyframe program (insert, fuse, cull, local BA;
   with a ``SceneGraphManager`` attached as ``system.scenegraph``, plane
   detection and association, rooms, semantic point refinement and the
   scene-graph local BA; with ``loop_closing``, the place query) and
   leaves a slot board that the host checks later;
5. with ``loop_closing`` a ``LoopCloser`` (``system.loop_closer``)
   resolves the previous keyframe's query from that board, verifies
   consistent candidates one keyframe later, corrects the map (pose graph,
   scene graph, fusion, then a global BA or the welding-window local BA)
   and relocalises lost frames in the map;
6. ``frame_poses`` / ``positions`` recompose the trajectory against the
   current keyframe poses, re-basing rows of retired keyframes through the
   retirement ledger;
7. with ``Sensor.IMU_RGBD`` an ``ImuPipeline`` (``system.imu``) takes every
   frame's samples (``track_rgbd(..., imu=(omega, acc, t))``), and every
   frame runs the serial step (``_track``, as the reference gates its
   fused and pipelined paths on ``imu is None``): preintegration and,
   once the IMU is initialised, the dead-reckoned prediction (one launch
   of kernel K18), K6
   with its pose prior and the per-frame visual-inertial solve (kernel
   K20), else the velocity re-anchored on the visual pose; every keyframe
   goes through ``_insert_keyframe``, which binds the keyframe window,
   attempts the gravity / velocity / bias initialisation and runs the VI
   local BA once it succeeded (the generic LM local BA before).

The serial step reads one packed vector back per frame (two when it
retries), the pipeline one per batch; ``host_readbacks`` counts every
device-to-host read the loop makes (the inertial path adds one a frame
for the visual-inertial solve's inlier count, and one a keyframe for each
initialisation attempt).  Not ported yet, and raising
``NotImplementedError`` where the path would reach them: mono / stereo
input (with or without an IMU) and the Atlas (stash / merge,
relocalisation in stashed maps).  A frame tracked again
from a lost state makes a recovery keyframe outside the keyframe
program, with the generic LM local BA (``mapping.local_ba``, or
``scenegraph/joint_ba.py`` with the scene graph), as the reference does.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from visual_sgraphs_tpu_torch.config import Sensor, SystemConfig
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.cuda import resolve_device
from visual_sgraphs_tpu_torch.inertial.pipeline import (
    ImuPipeline,
    pose_inertial_gn,
    walk_info,
)
from visual_sgraphs_tpu_torch.parallel.dist_ba import global_ba_sharded
from visual_sgraphs_tpu_torch.place.loop_closer import LoopCloser
from visual_sgraphs_tpu_torch.scenegraph.joint_ba import scenegraph_local_ba
from visual_sgraphs_tpu_torch.scenegraph.state import empty_scenegraph
from visual_sgraphs_tpu_torch.slam import mapping, tracking
from visual_sgraphs_tpu_torch.slam.cycle_program import make_cycle_program
from visual_sgraphs_tpu_torch.slam.frame import (
    FrameObs,
    frame_at,
    make_frame_obs,
)
from visual_sgraphs_tpu_torch.slam.kf_program import (
    make_kf_program,
    scenegraph_keyframe,
)
from visual_sgraphs_tpu_torch.slam.map_state import MapState, empty_map
from visual_sgraphs_tpu_torch.utils.events import EventLog
from visual_sgraphs_tpu_torch.utils.timing import StageTimers


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


# numpy SE3 helpers for export-time trajectory recomposition
def _np_qmul(q, p):
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return np.stack([
        qw * pw - qx * px - qy * py - qz * pz,
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
    ], axis=-1)


def _np_qrot(q, v):
    u = q[..., 1:4]
    w = q[..., 0:1]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _np_se3_mul(A, B):
    q = _np_qmul(A[..., :4], B[..., :4])
    t = _np_qrot(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return np.concatenate([q, t], axis=-1)


def _velocity_of(new, last):
    return lie.se3_normalize(lie.se3_multiply(new, lie.se3_inverse(last)))


class SlamSystem:
    """Single-session SLAM over an RGB-D stream, on ``device`` (the card
    unless the caller asks for the CPU; raises when no card is there)."""

    def __init__(self, config: SystemConfig = SystemConfig(),
                 device: torch.device | str = "cuda"):
        t = config.tracking
        fx_scale = config.camera.fx / t.match_radius_ref_fx
        if abs(fx_scale - 1.0) > 0.05:
            # match windows are angular: pixels at the reference focal
            # length, scaled to the live camera
            config = dataclasses.replace(config, tracking=dataclasses.replace(
                t,
                match_radius_coarse=t.match_radius_coarse * fx_scale,
                match_radius_fine=t.match_radius_fine * fx_scale,
            ))
        for unsupported, what in (
            (config.sensor not in (Sensor.RGBD, Sensor.IMU_RGBD),
             "mono and stereo sensors (with or without an IMU)"),
            (not config.mapping.fast_ba, "the generic LM local BA"),
        ):
            if unsupported:
                raise NotImplementedError(f"SlamSystem: {what} not ported yet")
        self.cfg = config
        self.device = resolve_device(device)
        self.cam_K = torch.from_numpy(config.camera.K).to(self.device)
        self.cam_bf = torch.full((), config.camera.bf, dtype=torch.float32,
                                 device=self.device)
        self.map: MapState = empty_map(config.capacity, config.orb,
                                       self.device)
        self.state = TrackState.NOT_INITIALIZED
        self.last_pose = lie.se3_identity(device=self.device)
        self.velocity = lie.se3_identity(device=self.device)
        # the reference keyframe slot; the host chooses every slot, so it
        # never needs to read this back
        self.ref_kf_host = 0
        self.n_kf_host = 0
        K = config.capacity.max_keyframes
        self._kf_valid_mirror = np.zeros(K, bool)
        self._kf_seq_mirror = np.full(K, -1, np.int64)
        self.frames_since_kf = 0
        self.last_kf_inliers = 1
        self.peak_inliers = 1
        # (timestamp, epoch, ref_kf_slot, ref_kf_seq, T_rel, tracked): frame
        # poses relative to their reference keyframe, recomposed at export
        self.trajectory: list[tuple] = []
        self.epoch = 0
        self.lost_frames = 0
        self._last_ts: float | None = None
        self.timers = StageTimers(config.profile, config.profile_sync)
        self.events = EventLog(verbose=config.verbose_events)
        self.host_readbacks = 0
        self._pending = None
        self._stats_buf: list = []
        self._kf_counter = 0
        self._serial_board = None
        # B-frame pipeline (tracking.pipeline_depth > 1): frames buffered
        # for the next batch, the dispatched batch awaiting its resolve,
        # frames left to run serially after a failed frame in a batch
        self._batch_buf: list = []
        self._pending_batch = None
        self._serial_relief = 0
        self._batch_chain_broken = False
        self._in_batch_resolve = False
        # maps stashed in the Atlas: always empty, since stashing raises
        # (``_new_map``); the Atlas merge probes are not ported
        self.stashed_maps: list = []
        # attached by the caller (``system.scenegraph = SceneGraphManager(
        # ...)``); the keyframe program then runs the scene-graph stages
        self.scenegraph = None
        # place recognition, loop correction, relocalisation
        self.loop_closer = (LoopCloser(config.place)
                            if config.loop_closing else None)
        # the inertial pipeline (reference system.py:189-198)
        self.imu = (self._make_imu() if config.sensor == Sensor.IMU_RGBD
                    else None)
        self._step = tracking.make_frame_step(
            config.camera, config.orb, config.mapping.local_window, 4096,
            config.tracking.match_radius_coarse,
            config.tracking.match_radius_fine, True)

    def _make_imu(self) -> ImuPipeline:
        return ImuPipeline(self.cfg.imu, self.cfg.capacity.max_keyframes,
                           fix_scale=not self.cfg.sensor_is_monocular(),
                           device=self.device)

    # ------------------------------------------------------------------ api

    def track_rgbd(self, gray, depth, timestamp: float,
                   imu=None) -> torch.Tensor:
        """Process one RGB-D frame; returns T_cw (7,) (System::TrackRGBD).
        ``gray`` / ``depth``: (H, W) arrays or tensors, moved to the
        system's device; ``imu``: (omega (T, 3), acc (T, 3), t (T,)) numpy
        samples since the previous frame (inertial sensors)."""
        gray = torch.as_tensor(gray, dtype=torch.float32, device=self.device)
        depth = torch.as_tensor(depth, dtype=torch.float32,
                                device=self.device)
        if self.state == TrackState.OK and self.imu is None:
            if self.cfg.tracking.pipeline_depth > 1:
                # B-frame pipeline: one cycle and one readback per B frames
                return self._track_batched(gray, depth, timestamp)
            # one tracking step now, the previous frame's host decisions
            # after it (the reference's one-frame-deferred resolution)
            return self._track_fused(gray, depth, timestamp)
        self.flush()
        with self.timers.stage("orb_extract"):
            frame = make_frame_obs(gray, depth, timestamp, self.cfg.camera,
                                   self.cfg.orb)
        return self._track(frame, timestamp, depth, imu)

    # ------------------------------------------------------------- internals

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """Device-to-host read (counted)."""
        self.host_readbacks += 1
        return t.cpu().numpy()

    def _track_fused(self, gray, depth, timestamp: float):
        t = self.cfg.tracking
        ts = float(timestamp)
        self._last_ts = ts
        with self.timers.stage("track_dispatch"):
            frame, res, pose_sel, vel_sel, T_rel, packed, n_read = self._step(
                self.map, gray, depth, ts, self.last_pose, self.velocity,
                self.ref_kf_host, self.cam_K, t.min_inliers_ok, self.cam_bf,
                self.timers)
        self.host_readbacks += n_read
        self.last_pose = pose_sel
        self.velocity = vel_sel
        prev = self._pending
        self._pending = {
            "ts": ts, "frame": frame, "res": res, "T_rel": T_rel,
            "packed": packed, "depth_img": depth,
            "ref_host": self.ref_kf_host,
            "ref_seq": self._ref_seq(self.ref_kf_host), "epoch": self.epoch,
        }
        if prev is not None:
            self._resolve_pending(prev)
        return self.last_pose

    # -------------------------------------------------- B-frame pipeline

    def _track_batched(self, gray, depth, timestamp: float):
        """Buffer frames; every ``pipeline_depth`` frames resolve the
        previous batch's decisions from its one readback and dispatch the
        cycle (``slam/cycle_program.py``): the chosen keyframe's program,
        then the new batch's scan against the fresh map (reference
        ``system.py:286-363``)."""
        B = self.cfg.tracking.pipeline_depth
        self._last_ts = float(timestamp)
        if ((self._serial_relief > 0 or self.n_kf_host < 5)
                and not self._batch_buf and self._pending_batch is None):
            # a stress window after a failed frame, or the early map's
            # ramp-in: the serial path, one keyframe chance per frame
            self._serial_relief = max(self._serial_relief - 1, 0)
            return self._track_fused(gray, depth, timestamp)
        if self._pending is not None:
            # serial -> batched: resolve the serial path's in-flight frame
            # now, so trajectory rows stay in frame order
            p, self._pending = self._pending, None
            self._resolve_pending(p)
        self._batch_buf.append((gray, depth, float(timestamp)))
        if len(self._batch_buf) < B:
            return self.last_pose
        buf, self._batch_buf = self._batch_buf, []
        prev, self._pending_batch = self._pending_batch, None
        kf_choice = None
        fused_cycle = self.cfg.mapping.fast_ba
        self._batch_chain_broken = False
        if prev is not None:
            self._in_batch_resolve = True
            try:
                kf_choice = self._resolve_batch_inner(prev,
                                                      defer_kf=fused_cycle)
            finally:
                self._in_batch_resolve = False
        if self.state != TrackState.OK:
            if kf_choice is not None:
                # a keyframe chosen before the stream went lost anchors
                # later relocalisation: insert it now
                self._insert_kf_from_batch(prev, *kf_choice)
            for g, d, ts in buf:
                self.track_rgbd(g, d, ts)
            return self.last_pose
        relief = self._serial_relief > 0
        if (fused_cycle and prev is not None and not self._batch_chain_broken
                and not relief):
            self._dispatch_cycle(buf, prev, kf_choice)
        else:
            # the first batch, a broken chain (a re-track or a
            # relocalisation inside the batch) or a stress window
            if kf_choice is not None:
                self._insert_kf_from_batch(prev, *kf_choice)
            if relief:
                for g, d, ts in buf:
                    self._serial_relief = max(self._serial_relief - 1, 0)
                    if self.state == TrackState.OK:
                        self._track_fused(g, d, ts)
                    else:
                        self.track_rgbd(g, d, ts)
            else:
                self._dispatch_scan(buf)
        return self.last_pose

    def _retrack_from_batch(self, pb, i: int):
        """Track the batch's rejected frame ``i`` again against the current
        map (keyframes may have landed since its scan), with a 2x window;
        accepted only at twice the per-frame inlier floor.  Returns
        (n_inliers, ref slot, ref seq, T_rel) or None."""
        t = self.cfg.tracking
        with self.timers.stage("track_retry"):
            res, new_m, packed = tracking.track_frame_full(
                self.map, frame_at(pb["frames"], i), self.last_pose,
                self.last_pose, self.ref_kf_host, self.cam_K,
                t.min_inliers_ok, n_window=self.cfg.mapping.local_window,
                fx_radius=t.match_radius_coarse * 2.0,
                fine_radius=t.match_radius_fine, cam_bf=self.cam_bf,
                img_wh=(self.cfg.camera.width, self.cfg.camera.height))
        self.host_readbacks += 1 + int(packed[3])
        n_inl = int(packed[1])
        if n_inl < 2 * t.min_inliers_ok:
            return None
        self.map = new_m
        pose = lie.se3_normalize(res.pose)
        # the chain pose before the re-track is the scan's end-of-batch
        # pose: a velocity from it would be meaningless
        self.velocity = lie.se3_identity(device=self.device)
        self.last_pose = pose
        self.events.emit("batch_retrack", frame=i, n_inliers=n_inl)
        T_rel = _velocity_of(pose, self.map.kf_pose[self.ref_kf_host])
        return (n_inl, self.ref_kf_host, self._ref_seq(self.ref_kf_host),
                T_rel)

    def _insert_kf_from_batch(self, pb, i: int, n_inl: int, ts: float):
        """Insert the batch's frame ``i`` as a keyframe now, outside the
        cycle: its pose recomposed from its scan-time T_rel onto the
        current reference row, as the cycle program does."""
        res_i = tracking.result_at(pb["results"], i)
        res_i = res_i._replace(pose=lie.se3_normalize(lie.se3_multiply(
            pb["T_rels"][i], self.map.kf_pose[pb["ref_host"]])))
        with self.timers.stage("kf_insert"):
            self._insert_keyframe_fused(frame_at(pb["frames"], i), res_i,
                                        n_inl, ts=ts,
                                        depth_img=pb["depths"][i])

    def _batch_record(self, buf, frames, results, T_rels, packeds, depths,
                      board=None, expected_kf=None, expected_n_kf=None):
        """The dispatched batch, awaiting its resolve.  Its counters and
        board are read back as one vector (``readout``)."""
        readout = packeds.reshape(-1)
        if board is not None:
            readout = torch.cat([readout, board])
        self._pending_batch = {
            "frames": frames, "results": results, "T_rels": T_rels,
            "packeds": packeds, "depths": depths, "readout": readout,
            "has_board": board is not None,
            "tss": [ts for _, _, ts in buf], "epoch": self.epoch,
            "ref_host": self.ref_kf_host,
            "ref_seq": self._ref_seq(self.ref_kf_host),
            "expected_kf": expected_kf, "expected_n_kf": expected_n_kf,
        }

    def _dispatch_scan(self, buf) -> None:
        """A plain tracking scan over ``buf`` (the first batch, or after a
        broken chain)."""
        t = self.cfg.tracking
        scan = tracking.make_frame_scan(
            self.cfg.camera, self.cfg.orb, self.cfg.mapping.local_window,
            4096, t.match_radius_coarse, t.match_radius_fine, True, len(buf))
        grays = torch.stack([g for g, _, _ in buf])
        depths = torch.stack([d for _, d, _ in buf])
        with self.timers.stage("track_dispatch"):
            frames, results, T_rels, packeds, T_out, vel_out = scan(
                self.map, grays, depths, [ts for _, _, ts in buf],
                self.last_pose, self.velocity, self.ref_kf_host, self.cam_K,
                t.min_inliers_ok, self.cam_bf, self.timers)
        self.last_pose = T_out
        self.velocity = vel_out
        self._batch_record(buf, frames, results, T_rels, packeds, depths)

    def _dispatch_cycle(self, buf, prev, kf_choice) -> None:
        """Dispatch the cycle: the keyframe ``kf_choice`` = (frame index,
        n_inliers, ts) chosen out of the resolved batch ``prev`` (or none),
        then the scan of ``buf`` (reference ``system.py:448-589``)."""
        t = self.cfg.tracking
        mc = self.cfg.mapping
        pc = self.cfg.place
        lc = self.loop_closer
        sg_on = self.scenegraph is not None
        insert_kf = kf_choice is not None
        do_lba = do_cull = do_maint = False
        sem_img = conf_img = hyp = None
        if lc is not None:
            # a serial keyframe's place-query scalars ride its board
            self._deliver_serial_board()
        loop_on = lc is not None and lc._ensure_vocab(self)
        kf_slot = 0
        i_kf, n_inl = 0, 0
        if insert_kf:
            i_kf, n_inl, kf_ts = kf_choice
            kf_slot = self._host_alloc_kf_slot()
            self._kf_counter += 1
            do_lba = (self._kf_counter % mc.lba_interval) == 0 and mc.fast_ba
            do_cull = (self._kf_counter % mc.cull_interval) == 0
            if lc is not None:
                # the previous keyframe's place query first: a loop
                # correction lands in the map before this cycle runs (the
                # keyframe pose and the chain recompose inside it)
                with self.timers.stage("loop_detect"):
                    closed = lc.resolve_pending(self)
                if closed:
                    self.events.emit("loop_closed", cand=lc.last_loop)
                loop_on = lc._ensure_vocab(self)
            if sg_on:
                do_maint, _, sem_img, conf_img, hyp = \
                    self._scenegraph_operands(kf_ts, None)
        program = make_cycle_program(
            self.cfg.camera, self.cfg.orb, mc.local_window,
            t.match_radius_coarse, t.match_radius_fine, len(buf),
            self.cfg.scenegraph if sg_on else None, loop_on, mc.lba_iters,
            mc.point_cull_min_obs, mc.point_cull_min_found_ratio,
            mc.kf_cull_redundancy, pc.min_gap if lc else 10,
            pc.top_n_candidates if lc else 3, self._pt_quarantine())
        grays = torch.stack([g for g, _, _ in buf])
        depths = torch.stack([d for _, d, _ in buf])
        with self.timers.stage("track_dispatch"):
            (new_map, new_sg, new_db, _, board, frames, results, T_rels,
             packeds, T_out, vel_out) = program(
                self.map, self.scenegraph.state if sg_on else None,
                lc.db if loop_on else None, lc.vocab if loop_on else None,
                prev["frames"], prev["results"], prev["packeds"],
                prev["T_rels"], insert_kf, i_kf, kf_slot, prev["ref_host"],
                prev["depths"], sem_img, conf_img, hyp, grays, depths,
                [ts for _, _, ts in buf], self.velocity, self.cam_K,
                self.cam_bf, t.min_inliers_ok, do_lba, do_cull, do_maint,
                self.timers)
        self.map = new_map
        if sg_on and insert_kf:
            self.scenegraph.state = new_sg
        self.last_pose = T_out
        self.velocity = vel_out
        expected_kf = expected_n_kf = None
        if insert_kf:
            expected_kf, expected_n_kf = kf_slot, self.n_kf_host
            self.events.emit("keyframe", kf=kf_slot, n_inliers=n_inl,
                             lba=do_lba, cull=do_cull)
            self.ref_kf_host = kf_slot
            self.frames_since_kf = 0
            self.last_kf_inliers = max(n_inl, 1)
            self.peak_inliers = self.last_kf_inliers
            if loop_on:
                lc.db = new_db
                # its scalars arrive on this cycle's board
                lc.queue_detection(kf_slot, None)
            if self.stashed_maps:
                raise NotImplementedError(
                    "SlamSystem: merging a stashed Atlas map is not ported")
        self._batch_record(buf, frames, results, T_rels, packeds, depths,
                           board, expected_kf, expected_n_kf)

    def _resolve_batch(self) -> None:
        pb, self._pending_batch = self._pending_batch, None
        if pb is None:
            return
        self._in_batch_resolve = True
        try:
            self._resolve_batch_inner(pb)
        finally:
            self._in_batch_resolve = False

    def _batch_stats(self, pb) -> None:
        """Queue the batch's accepted frames' match and visibility tables
        for the next keyframe program."""
        acc = pb["packeds"][:, 1] >= self.cfg.tracking.min_inliers_ok
        self._stats_buf.append((
            torch.where(acc[:, None], pb["results"].slot_pt, -1),
            torch.where(acc[:, None], pb["results"].vis_pt, -1)))

    def _resolve_batch_inner(self, pb, defer_kf: bool = False):
        """Apply batch ``pb``'s host decisions from its one readback
        (reference ``system.py:625-845``).  With ``defer_kf`` (the cycle
        pipeline) the last chosen keyframe is returned, not inserted: it
        rides the next cycle, which also folds the batch's statistics;
        earlier choices in the same batch insert now.  Returns (frame
        index, n_inliers, ts) or None."""
        t = self.cfg.tracking
        with self.timers.stage("track_resolve"):
            out = self._read(pb["readout"])
        B = len(pb["tss"])
        pk = out[:4 * B].reshape(B, 4)
        if pb["has_board"]:
            self._verify_slot_board(pb["expected_kf"], pb["expected_n_kf"],
                                    out[4 * B:])
        relocated_any = False
        kf_choice = None
        n_batch_kf = 0  # keyframes chosen out of this batch
        acc_np = pk[:, 1] >= t.min_inliers_ok
        if not bool(acc_np.all()):
            # a frame failed: drop to the serial path for a window so
            # keyframes land between frames again
            if self._serial_relief == 0:
                self.events.emit("serial_relief",
                                 n_fail=int(B - acc_np.sum()))
            self._serial_relief = 2 * B
        if not defer_kf:
            self._batch_stats(pb)
        for i in range(B):
            n_inl = int(pk[i, 1])
            accepted = bool(acc_np[i])
            traj_ref, traj_seq = pb["ref_host"], pb["ref_seq"]
            traj_rel = pb["T_rels"][i]
            if not accepted and not self.cfg.localization_only:
                # the scan could only retry against the map as of its
                # dispatch; keyframes inserted since may make the frame
                # trackable now
                if kf_choice is not None:
                    self._insert_kf_from_batch(pb, *kf_choice)
                    kf_choice = None
                rec = self._retrack_from_batch(pb, i)
                if rec is not None:
                    n_inl, traj_ref, traj_seq, traj_rel = rec
                    accepted = True
                    self._batch_chain_broken = True
            self.trajectory.append((pb["tss"][i], pb["epoch"], traj_ref,
                                    traj_seq, traj_rel, accepted))
            if accepted:
                self.state = TrackState.OK
                self.lost_frames = 0
                self.peak_inliers = max(self.peak_inliers, n_inl)
                if (not relocated_any and not self.cfg.localization_only
                        and self._need_keyframe(
                            n_inl, allow_ratio=(n_batch_kf == 0))):
                    n_batch_kf += 1
                    if defer_kf and not self._batch_chain_broken:
                        if kf_choice is not None:
                            # a second keyframe in one batch: the earlier
                            # choice inserts now, the newer one rides
                            self._insert_kf_from_batch(pb, *kf_choice)
                        kf_choice = (i, n_inl, pb["tss"][i])
                        # the spacing policy sees the deferred insertion
                        self.frames_since_kf = 0
                        self.last_kf_inliers = max(n_inl, 1)
                        self.peak_inliers = self.last_kf_inliers
                    else:
                        self._insert_kf_from_batch(pb, i, n_inl,
                                                   pb["tss"][i])
            else:
                self.state = TrackState.RECENTLY_LOST
                self.velocity = lie.se3_identity(device=self.device)
                self.lost_frames += 1
                relocated = False
                if self.loop_closer is not None:
                    relocated = self.loop_closer.relocalize(
                        self, frame_at(pb["frames"], i))
                    if relocated:
                        if kf_choice is not None:
                            # the chosen keyframe lands before the
                            # relocalisation takes over
                            self._insert_kf_from_batch(pb, *kf_choice)
                            kf_choice = None
                        self.state = TrackState.OK
                        self.lost_frames = 0
                        relocated_any = True
                        self._batch_chain_broken = True
                if not relocated:
                    budget = int(t.recently_lost_budget
                                 * self.cfg.camera.fps)
                    if self.lost_frames >= budget:
                        # the rest of the batch is recorded untracked
                        # before the map is replaced
                        for j in range(i + 1, B):
                            self.trajectory.append((
                                pb["tss"][j], pb["epoch"], pb["ref_host"],
                                pb["ref_seq"], pb["T_rels"][j], False))
                        self._new_map()
                        return None
        if defer_kf and (self._batch_chain_broken
                         or self.state != TrackState.OK):
            # no cycle will fold this batch's statistics: queue them for
            # the next keyframe program
            self._batch_stats(pb)
        if (self._batch_chain_broken and self.state == TrackState.OK
                and not relocated_any and bool(acc_np[B - 1])):
            # the chain broke inside the batch but the scan held its last
            # frame: restart from its recomposed pose
            self.last_pose = lie.se3_normalize(lie.se3_multiply(
                pb["T_rels"][-1], self.map.kf_pose[pb["ref_host"]]))
        if (self.state == TrackState.OK and not relocated_any
                and not defer_kf):
            # re-anchor the chain on the (BA / loop adjusted) reference
            # row; in the cycle pipeline the cycle does it
            self.last_pose = lie.se3_normalize(lie.se3_multiply(
                pb["T_rels"][-1], self.map.kf_pose[pb["ref_host"]]))
        return kf_choice

    def _pt_quarantine(self) -> int:
        return max(3, self.cfg.tracking.pipeline_depth)

    def _host_alloc_kf_slot(self) -> int:
        """Choose the next keyframe slot from the host mirror (first free
        slot; else evict the oldest non-anchor)."""
        free = np.flatnonzero(~self._kf_valid_mirror)
        if free.size:
            slot = int(free[0])
        else:
            seqs = self._kf_seq_mirror.copy()
            seqs[0] = np.iinfo(np.int64).max  # slot 0 = gauge anchor
            if self.ref_kf_host < len(seqs):
                seqs[self.ref_kf_host] = np.iinfo(np.int64).max
            slot = int(np.argmin(seqs))
            self.events.emit("capacity_evict", slot=slot,
                             seq=int(self._kf_seq_mirror[slot]))
        self._kf_valid_mirror[slot] = True
        self._kf_seq_mirror[slot] = self.n_kf_host
        self.n_kf_host += 1
        return slot

    def _sync_kf_mirror(self) -> None:
        self._kf_valid_mirror = self._read(self.map.kf_valid).copy()
        self._kf_seq_mirror = self._read(self.map.kf_seq).astype(np.int64)

    def _ref_seq(self, slot: int) -> int:
        if 0 <= slot < len(self._kf_seq_mirror):
            return int(self._kf_seq_mirror[slot])
        return -1

    def _deliver_serial_board(self) -> None:
        """Read the pending serial keyframe board now (counted) and hand
        its place-query scalars to the loop closer; the rest of its check
        stays where the reference makes it."""
        if self._serial_board is None or not self._serial_board[3]:
            return
        kf, n_kf, board, _ = self._serial_board
        bd = self._read(board)
        if bd.shape[0] > 6:
            self.loop_closer.deliver(bd[6:])
        self._serial_board = (kf, n_kf, bd, False)

    def _verify_slot_board(self, expected_kf, expected_n_kf, board,
                           deliver: bool = True) -> None:
        """Check the device's keyframe slot against the host's choice
        (``expected_kf`` None: no keyframe was inserted) and fold the
        device-side cull into the validity mirror.  ``board`` is the
        device board, read here, or its host copy; ``deliver``: hand its
        place-query scalars to the loop closer (not yet done)."""
        bd = board if isinstance(board, np.ndarray) else self._read(board)
        if self.scenegraph is not None:
            # the lagged n_obs mirror rides the board: no sync of its own
            self.scenegraph.n_obs_host = int(bd[5])
        if deliver and self.loop_closer is not None and bd.shape[0] > 6:
            # the keyframe's place-query scalars ride the same board
            self.loop_closer.deliver(bd[6:])
        culled = int(bd[3])
        if culled >= 0:
            self._kf_valid_mirror[culled] = False
            self.events.emit("kf_culled", slot=culled)
        if expected_kf is None:
            return
        dev_kf, dev_n_kf = int(bd[0]), int(bd[1])
        if dev_kf == expected_kf and dev_n_kf == expected_n_kf:
            return
        self.events.emit("slot_divergence", host_kf=expected_kf,
                         dev_kf=dev_kf, host_n_kf=expected_n_kf,
                         dev_n_kf=dev_n_kf)
        if self.cfg.strict_slot_check:
            raise RuntimeError(
                f"host/device keyframe slot divergence: host slot "
                f"{expected_kf} (n_kf {expected_n_kf}) vs device slot "
                f"{dev_kf} (n_kf {dev_n_kf})")
        self.n_kf_host = dev_n_kf
        if self.ref_kf_host == expected_kf:
            self.ref_kf_host = dev_kf
        self._sync_kf_mirror()
        self.n_kf_host = max(self.n_kf_host,
                             int(self._kf_seq_mirror.max()) + 1)

    def _resolve_pending(self, p) -> None:
        """Apply frame ``p``'s host-side decisions (its counters are
        already on the host)."""
        t = self.cfg.tracking
        with self.timers.stage("track_resolve"):
            n_inl = int(p["packed"][1])
        accepted = n_inl >= t.min_inliers_ok
        self.trajectory.append((p["ts"], p["epoch"], p["ref_host"],
                                p["ref_seq"], p["T_rel"], accepted))
        if accepted:
            self.state = TrackState.OK
            self.lost_frames = 0
            self.peak_inliers = max(self.peak_inliers, n_inl)
            self._stats_buf.append((p["res"].slot_pt, p["res"].vis_pt))
            if self._need_keyframe(n_inl):
                with self.timers.stage("kf_insert"):
                    self._insert_keyframe_fused(p["frame"], p["res"], n_inl,
                                                ts=p["ts"],
                                                depth_img=p["depth_img"])
            return
        # lost handling (Tracking.cc:2024-2098)
        self.state = TrackState.RECENTLY_LOST
        self.velocity = lie.se3_identity(device=self.device)
        self.lost_frames += 1
        self._relocalize_or_count(p["frame"])

    def _relocalize_or_count(self, frame: FrameObs) -> None:
        """A lost frame: relocalise in the map (Tracking.cc:3687) when a
        loop closer is attached; otherwise, or when that fails, restart
        the map once the lost budget is spent."""
        if self.loop_closer is not None and self.loop_closer.relocalize(
                self, frame):
            self.state = TrackState.OK
            self.lost_frames = 0
            return
        t = self.cfg.tracking
        budget = int(t.recently_lost_budget * self.cfg.camera.fps)
        if self.lost_frames >= budget:
            self._new_map()

    def flush(self) -> None:
        """Resolve the in-flight frame decisions and the queued loop
        detection (call before reading host-visible state such as the
        trajectory); a partial batch's frames run the serial path."""
        self._resolve_batch()
        buf, self._batch_buf = self._batch_buf, []
        for g, d, ts in buf:
            if self.state == TrackState.OK:
                self._track_fused(g, d, ts)
            else:
                self._track(make_frame_obs(g, d, ts, self.cfg.camera,
                                           self.cfg.orb), ts, d)
        p, self._pending = self._pending, None
        if p is not None:
            self._resolve_pending(p)
        if self._serial_board is not None:
            board, self._serial_board = self._serial_board, None
            self._verify_slot_board(*board)
        if self.loop_closer is not None and self.loop_closer.flush(self):
            self.last_pose = self.map.kf_pose[self.ref_kf_host]

    def run_global_ba(self, iters: int = 10) -> None:
        """Full-map BA (LoopClosing::RunGlobalBundleAdjustment) through the
        landmark-grouped Schur backend on one device
        (``parallel/dist_ba.py``, K8)."""
        with self.timers.stage("global_ba", sync_on=self.map.n_kf):
            self.map, _ = global_ba_sharded(self.map, self.cam_K,
                                            self.cam_bf, iters=iters)
        self.events.emit("global_ba", n_kf=int(self.n_kf_host))

    def _abort_pending(self) -> None:
        """Record an in-flight frame whose map is being replaced as
        untracked, so the trajectory stays frame-aligned."""
        p, self._pending = self._pending, None
        if p is not None:
            self.trajectory.append((p["ts"], p["epoch"], p["ref_host"],
                                    p["ref_seq"], p["T_rel"], False))
        pb, self._pending_batch = self._pending_batch, None
        if pb is not None:
            for i, ts in enumerate(pb["tss"]):
                self.trajectory.append((ts, pb["epoch"], pb["ref_host"],
                                        pb["ref_seq"], pb["T_rels"][i],
                                        False))
        for _, _, ts in self._batch_buf:
            self.trajectory.append((
                ts, self.epoch, self.ref_kf_host,
                self._ref_seq(self.ref_kf_host),
                lie.se3_identity(device=self.device), False))
        self._batch_buf = []
        self._stats_buf = []
        self._serial_board = None

    def _stacked_stats(self):
        """((B, F), (B, n_local)) -1-padded batches of the per-frame match
        and visibility tables since the last keyframe."""
        F = self.map.F
        B = 32  # static bucket (kf_max_interval is 30)
        buf, self._stats_buf = self._stats_buf, []
        if not buf:
            return torch.full((B, F), -1, dtype=torch.int32,
                              device=self.device), None
        # serial frames queue rows, batches (B, .) tables
        slots = torch.cat([s.reshape(-1, F) for s, _ in buf])[-B:]
        vis = torch.cat([v.reshape(-1, v.shape[-1]) for _, v in buf])[-B:]
        nrow = slots.shape[0]
        if nrow < B:
            slots = torch.cat([slots, torch.full(
                (B - nrow, F), -1, dtype=torch.int32, device=self.device)])
            vis = torch.cat([vis, torch.full(
                (B - nrow, vis.shape[1]), -1, dtype=torch.int32,
                device=self.device)])
        return slots, vis

    def _scenegraph_operands(self, ts: float | None, depth_img):
        """(do_maint, depth, sem, conf, hypotheses) for this keyframe's
        scene-graph stages: the maintenance cadence, the keyframe's own
        depth image (the reference pairs the keyframe's pose with the next
        frame's depth: ROADMAP.md, known reference defects), the
        nearest-in-time semantics (within 50 ms of the
        keyframe's timestamp, else all UNDEFINED / unit confidence) and
        the RANSAC samples."""
        mgr = self.scenegraph
        mgr._kf_count += 1
        do_maint = (mgr._kf_count % mgr.maintenance_interval) == 0
        pending = mgr.pop_semantics(ts if ts is not None else self._last_ts)
        sem_img = conf_img = None
        if pending is not None:
            sem_img, conf_img = (
                None if x is None else torch.as_tensor(x, device=self.device)
                for x in pending)
        if sem_img is not None:
            sem_img = sem_img.to(torch.int32)
        if conf_img is not None:
            conf_img = conf_img.to(torch.float32)
        return (do_maint, depth_img, sem_img, conf_img,
                mgr.draw_hypotheses())

    def _insert_keyframe_fused(self, frame: FrameObs,
                               res: tracking.TrackResult, n_inl: int,
                               ts: float | None = None, depth_img=None):
        """Keyframe path (slam/kf_program.py).  ``lba_interval`` /
        ``cull_interval`` skip the heavy stages on intermediate keyframes
        (the reference's LBA is likewise aborted under load)."""
        mc = self.cfg.mapping
        self._kf_counter += 1
        do_lba = (self._kf_counter % mc.lba_interval) == 0
        do_cull = (self._kf_counter % mc.cull_interval) == 0
        stats_slots, stats_vis = self._stacked_stats()
        if stats_vis is None:
            stats_vis = torch.full((stats_slots.shape[0], 1), -1,
                                   dtype=torch.int32, device=self.device)
        if self._serial_board is not None:
            # the previous keyframe's board: long finished on the device
            prev_board, self._serial_board = self._serial_board, None
            self._verify_slot_board(*prev_board)
        kf_slot = self._host_alloc_kf_slot()
        lc = self.loop_closer
        loop_on = False
        if lc is not None:
            # resolve the previous keyframe's place query first: a loop
            # correction must land before this keyframe's program runs
            ref_pose_before = self.map.kf_pose[self.ref_kf_host].clone()
            with self.timers.stage("loop_detect"):
                closed = lc.resolve_pending(self)
            if closed:
                # carry the pending keyframe's tracked pose into the
                # corrected world (LoopClosing.cc:977-1008)
                ref_new = self.map.kf_pose[self.ref_kf_host]
                res = res._replace(pose=lie.se3_normalize(lie.se3_multiply(
                    _velocity_of(res.pose, ref_pose_before), ref_new)))
                self.last_pose = ref_new
                self.events.emit("loop_closed", cand=lc.last_loop)
            loop_on = lc._ensure_vocab(self)
        sg_on = self.scenegraph is not None
        do_maint, depth, sem_img, conf_img, hyp = (
            self._scenegraph_operands(ts, depth_img) if sg_on
            else (False, None, None, None, None))
        if sg_on and self.scenegraph.cfg.room_method == "freespace":
            # free-space rooms (reference system.py:1035-1043): the grid
            # takes every keyframe of this path, here with the keyframe's
            # own depth; the clustering runs at maintenance cadence.  The
            # B-frame cycle never reaches this, as in the reference.
            with self.timers.stage("freespace"):
                if depth is not None:
                    self.scenegraph.update_freespace(depth, res.pose,
                                                     self.cam_K)
                if do_maint:
                    self.scenegraph.infer_rooms_freespace()
        pc = self.cfg.place
        program = make_kf_program(
            self.cfg.scenegraph if sg_on else None, loop_on, mc.local_window,
            mc.lba_iters, mc.point_cull_min_obs,
            mc.point_cull_min_found_ratio, mc.kf_cull_redundancy,
            pc.min_gap if lc else 10, pc.top_n_candidates if lc else 3,
            self._pt_quarantine())
        with self.timers.stage("kf_program", sync_on=self.map.n_kf):
            new_map, new_sg, new_db, kf, board = program(
                self.map, self.scenegraph.state if sg_on else None,
                lc.db if loop_on else None, lc.vocab if loop_on else None,
                frame, res.pose, res.slot_pt, kf_slot, stats_slots,
                stats_vis, depth, sem_img, conf_img, hyp, self.cam_K,
                self.cam_bf, do_lba, do_cull, do_maint)
        self.map = new_map
        if sg_on:
            self.scenegraph.state = new_sg
        if loop_on:
            lc.db = new_db
            # its scalars arrive on this keyframe's board
            lc.queue_detection(kf_slot, None)
        self._serial_board = (kf_slot, self.n_kf_host, board, True)
        self.events.emit("keyframe", kf=kf_slot, n_inliers=n_inl,
                         lba=do_lba, cull=do_cull)
        self.ref_kf_host = kf_slot
        self.frames_since_kf = 0
        self.last_kf_inliers = max(n_inl, 1)
        self.peak_inliers = self.last_kf_inliers
        if self._pending is None and not self._in_batch_resolve:
            # no newer frame in flight: re-anchor on the BA-adjusted pose
            self.last_pose = self.map.kf_pose[kf_slot]

    def _track(self, frame: FrameObs, timestamp, depth_img, imu=None):
        """The serial step (reference ``system.py:1144-1260``): every frame
        of the inertial path, and on the visual path the frames tracked
        from a lost or uninitialised state."""
        ts = float(timestamp)
        frame_pre = None
        if self.imu is not None:
            if imu is not None:
                self.imu.add_samples(*imu)
            with self.timers.stage("imu_preint"):
                # K18, with the prediction from the last pose once the
                # IMU is initialised
                frame_pre = self.imu.preintegrate_frame(ts, self.last_pose)
        if self.state == TrackState.NOT_INITIALIZED:
            self._initialize(frame)
            self._record(ts)
            return self.last_pose
        t = self.cfg.tracking
        T_pred = None
        if self.imu is not None:
            # the IMU's dead-reckoned prediction once initialised
            T_pred = self.imu.predict(self.last_pose, frame_pre)
        if T_pred is None:
            T_pred = lie.se3_normalize(lie.se3_multiply(self.velocity,
                                                        self.last_pose))
        # the dead-reckoned pose prior once the IMU is initialised
        prior_w = (t.imu_prior_weight
                   if self.imu is not None and self.imu.initialized else 0.0)
        with self.timers.stage("track_dispatch"):
            res, map_stats, packed = tracking.track_frame_full(
                self.map, frame, T_pred, self.last_pose, self.ref_kf_host,
                self.cam_K, t.min_inliers_ok,
                n_window=self.cfg.mapping.local_window,
                fx_radius=t.match_radius_coarse,
                fine_radius=t.match_radius_fine, cam_bf=self.cam_bf,
                img_wh=(self.cfg.camera.width, self.cfg.camera.height),
                prior_weight=prior_w)
        self.host_readbacks += 1 + int(packed[3])
        n_inl = int(packed[1])
        if n_inl >= t.min_inliers_ok:
            recovered = self.state != TrackState.OK
            self.state = TrackState.OK
            self.lost_frames = 0
            new_pose = lie.se3_normalize(res.pose)
            vi_solved = False
            if frame_pre is not None and prior_w > 0.0:
                new_pose, vi_solved = self._vi_solve(frame, res, new_pose)
            self.velocity = _velocity_of(new_pose, self.last_pose)
            if (self.imu is not None and self._last_ts is not None
                    and not vi_solved):
                # re-anchor the IMU velocity on the accepted visual pose
                # delta (the joint solve's own velocity is kept)
                self.imu.correct_velocity(self.last_pose, new_pose,
                                          ts - self._last_ts)
            self._last_ts = ts
            self.last_pose = new_pose
            self.map = map_stats
            self.peak_inliers = max(self.peak_inliers, n_inl)
            if recovered or self._need_keyframe(n_inl):
                self._insert_keyframe(frame, res, n_inl, ts, depth_img,
                                      recovered)
        else:
            self.state = (TrackState.RECENTLY_LOST
                          if self.state in (TrackState.OK,
                                            TrackState.RECENTLY_LOST)
                          else TrackState.LOST)
            self.velocity = lie.se3_identity(device=self.device)
            self.lost_frames += 1
            self._relocalize_or_count(frame)
        self._record(ts)
        return self.last_pose

    def _vi_solve(self, frame: FrameObs, res, new_pose):
        """The exact per-frame visual-inertial solve on top of the visual
        result (PoseInertialOptimizationLastFrame, kernel K20) with the
        frame window K18 wrote (``imu.frame_vec``), accepted at
        ``min_inliers_ok`` inliers.  Returns (pose, accepted)."""
        imu = self.imu
        with self.timers.stage("vi_solve"):
            T_r, v_r, bg_r, ba_r, n_vi = pose_inertial_gn(
                self.map, frame, res.slot_pt, new_pose, imu.vel,
                self.last_pose,
                imu.vel if imu.vel_prev is None else imu.vel_prev,
                imu.frame_vec, imu.T_bc, self.cam_K, self.cam_bf,
                walk_info(imu.cfg, imu.frame_dt))
            n_vi = int(self._read(n_vi))
        self.events.emit("vi_solve", n_inliers=n_vi,
                         accepted=n_vi >= self.cfg.tracking.min_inliers_ok)
        if n_vi < self.cfg.tracking.min_inliers_ok:
            return new_pose, False
        imu.vel = v_r
        imu._cur_bias_g = bg_r
        imu._cur_bias_a = ba_r
        return lie.se3_normalize(T_r), True

    def _new_map(self, stash: bool = True):
        """Restart tracking on a fresh map (CreateMapInAtlas)."""
        if stash and self.n_kf_host >= 5:
            raise NotImplementedError(
                "SlamSystem._new_map: stashing the lost map in the Atlas is "
                "not ported yet")
        self._abort_pending()
        if self.loop_closer is not None:
            self.loop_closer.reset()
        self.map = empty_map(self.cfg.capacity, self.cfg.orb, self.device)
        if self.imu is not None:
            self.imu = self._make_imu()
        if self.scenegraph is not None:
            self.scenegraph.state = empty_scenegraph(
                self.cfg.capacity, self.scenegraph.state.ob_kf.shape[0],
                self.scenegraph.device)
            self.scenegraph.n_obs_host = 0
        self.state = TrackState.NOT_INITIALIZED
        self.last_pose = lie.se3_identity(device=self.device)
        self.velocity = lie.se3_identity(device=self.device)
        self.ref_kf_host = 0
        self.n_kf_host = 0
        self._kf_valid_mirror[:] = False
        self._kf_seq_mirror[:] = -1
        self.lost_frames = 0
        self.peak_inliers = 1

    def _initialize(self, frame: FrameObs):
        """StereoInitialization (Tracking.cc:2396): the first frame is the
        origin keyframe; every depth-valid keypoint becomes a map point."""
        if not bool(self._read(torch.any(frame.depth > 0))):
            raise NotImplementedError(
                "SlamSystem: initialisation without depth (monocular "
                "two-view bootstrap) is not ported yet")
        pose = lie.se3_identity(device=self.device)
        slot_pt = torch.full((frame.uv.shape[0],), -1, dtype=torch.int32,
                             device=self.device)
        kf_host = self._host_alloc_kf_slot()
        self.map, kf, _ = mapping.insert_keyframe(
            self.map, frame, pose, slot_pt, self.cam_K, slot=kf_host)
        n_pts = int(self._read(self.map.n_pt))
        if n_pts >= 100:
            self.ref_kf_host = kf_host
            self.last_pose = pose
            self.state = TrackState.OK
            self.frames_since_kf = 0
            self.last_kf_inliers = n_pts

    def _need_keyframe(self, n_inliers: int, allow_ratio: bool = True) -> bool:
        """NeedNewKeyFrame (Tracking.cc:3133): minimum spacing, decay of
        tracked inliers relative to the peak since the last keyframe, an
        absolute floor and a maximum interval.  ``allow_ratio`` False (a
        second keyframe out of one batch, whose frames were all tracked
        against the pre-insert map) skips the decay test."""
        t = self.cfg.tracking
        self.frames_since_kf += 1
        if self.frames_since_kf < t.kf_min_interval:
            return False
        if self.frames_since_kf >= t.kf_max_interval:
            return True
        if n_inliers < 3 * t.min_inliers_ok:
            return True
        if not allow_ratio:
            return False
        return n_inliers < t.kf_min_tracked_ratio * self.peak_inliers

    def _insert_keyframe(self, frame: FrameObs, res, n_inl: int, ts: float,
                         depth_img, recovered: bool = True):
        """The serial keyframe (reference ``slam/system.py:1555-1630``):
        the recovery keyframe of a frame tracked again from a lost state,
        and every keyframe of the inertial path.  Outside the keyframe
        program: insert and fuse, the scene-graph update, the IMU hooks
        (bind the keyframe window, attempt the initialisation), the local
        BA on every call (the scene graph's joint BA once it holds plane
        observations, else the VI local BA once the IMU is initialised,
        else the generic LM local BA), both culls, then the loop closer's
        place query for this keyframe."""
        mc = self.cfg.mapping
        kf = self._host_alloc_kf_slot()
        self.map, _, _ = mapping.insert_keyframe(
            self.map, frame, res.pose, res.slot_pt, self.cam_K, slot=kf)
        self.map = mapping.fuse_observations(self.map, kf, self.cam_K)
        sgm, sg_cfg = self.scenegraph, self.cfg.scenegraph
        if sgm is not None:
            do_maint, depth, sem_img, conf_img, hyp = (
                self._scenegraph_operands(ts, depth_img))
            self.map, sgm.state = scenegraph_keyframe(
                sg_cfg, self.map, sgm.state, kf, depth, sem_img, conf_img,
                hyp, self.cam_K, do_maint)
        joint = (sgm is not None and sg_cfg.plane_kf_factor
                 and sgm.n_obs_host > 0)
        imu = self.imu
        if imu is not None:
            # bind the keyframe window, then the initialisation schedule
            # (LocalMapping.cc:142, 175-238)
            imu.on_keyframe(kf)
            if not imu.initialized:
                with self.timers.stage("imu_init"):
                    imu.try_initialize(self)
        vi_ba = not joint and imu is not None and imu.initialized
        stage = ("recovery_lba" if recovered
                 else "vi_lba" if vi_ba else "local_ba")
        with self.timers.stage(stage, sync_on=self.map.n_kf):
            if joint:
                self.map, sgm.state, _ = scenegraph_local_ba(
                    self.map, sgm.state, kf, self.cam_K, self.cam_bf,
                    n_window=mc.local_window, iters=mc.lba_iters,
                    config=sg_cfg)
            elif vi_ba:
                imu.local_ba(self, kf, n_window=mc.local_window,
                             iters=mc.lba_iters)
            else:
                self.map, _ = mapping.local_ba(
                    self.map, kf, self.cam_K, self.cam_bf,
                    n_window=mc.local_window, iters=mc.lba_iters)
        # the reference drops the culled slot here without folding it into
        # its host mirror; so does the port
        self.map, _ = mapping.cull_map(
            self.map, kf, mc.point_cull_min_obs,
            mc.point_cull_min_found_ratio, mc.kf_cull_redundancy)
        self.events.emit("recovery_keyframe" if recovered else "keyframe",
                         kf=kf, n_inliers=n_inl, joint_ba=joint,
                         vi_ba=vi_ba, lba=True, cull=True)
        self.ref_kf_host = kf
        self.frames_since_kf = 0
        self.last_kf_inliers = max(n_inl, 1)
        self.peak_inliers = self.last_kf_inliers
        self.last_pose = self.map.kf_pose[kf]
        if self.loop_closer is not None and self.loop_closer.on_keyframe(
                self, kf):
            # the whole map moved: resume from the corrected pose
            self.last_pose = self.map.kf_pose[kf]

    def _record(self, ts: float):
        T_rel = _velocity_of(self.last_pose, self.map.kf_pose[self.ref_kf_host])
        self.trajectory.append((ts, self.epoch, self.ref_kf_host,
                                self._ref_seq(self.ref_kf_host), T_rel,
                                self.state == TrackState.OK))

    # ------------------------------------------------------------- exports

    def _ledger_tables(self, m: MapState):
        """Host-side (alive seq -> slot, retired seq -> (parent_seq, T_cp))."""
        kf_seq = self._read(m.kf_seq)
        kf_valid = self._read(m.kf_valid)
        alive = {int(kf_seq[s]): s for s in range(len(kf_seq))
                 if kf_valid[s] and kf_seq[s] >= 0}
        ln = int(self._read(m.led_n))
        led_seq = self._read(m.led_seq)[:ln]
        led_parent = self._read(m.led_parent_seq)[:ln]
        led_T = self._read(m.led_T_cp)[:ln].astype(np.float64)
        ledger = {int(led_seq[i]): (int(led_parent[i]), led_T[i])
                  for i in range(ln)}
        return alive, ledger

    @staticmethod
    def _resolve_retired(seq: int, alive: dict, ledger: dict, memo: dict):
        """Walk the retirement ledger from ``seq`` to an alive keyframe,
        accumulating the relative-pose chain.  Returns (slot, T_acc) or
        None."""
        if seq in memo:
            return memo[seq]
        T_acc = np.array([1.0, 0, 0, 0, 0, 0, 0])
        s = seq
        for _ in range(len(ledger) + 1):
            if s in alive:
                memo[seq] = (alive[s], T_acc)
                return memo[seq]
            e = ledger.get(s)
            if e is None:
                break
            parent, T_cp = e
            T_acc = _np_se3_mul(T_acc, T_cp)
            s = parent
        memo[seq] = None
        return None

    def frame_poses(self) -> np.ndarray:
        """(T, 7) current-best T_cw per recorded frame: relative poses
        recomposed against the current keyframe poses; rows of retired
        keyframes re-base through the ledger."""
        self.flush()
        if not self.trajectory:
            return np.zeros((0, 7), np.float32)
        rels = self._read(torch.stack([r[4] for r in self.trajectory])
                          ).astype(np.float64)
        refs = np.asarray([r[2] for r in self.trajectory])
        seqs = np.asarray([r[3] for r in self.trajectory])
        pose = self._read(self.map.kf_pose).astype(np.float64)
        alive, ledger = self._ledger_tables(self.map)
        memo: dict = {}
        K = pose.shape[0]
        bases = np.zeros((len(self.trajectory), 7))
        for i in range(len(self.trajectory)):
            s = int(seqs[i])
            if s in alive:
                bases[i] = pose[alive[s]]
                continue
            res = self._resolve_retired(s, alive, ledger, memo) \
                if s >= 0 else None
            if res is not None:
                slot, T_acc = res
                rels[i] = _np_se3_mul(rels[i], T_acc)
                bases[i] = pose[slot]
            else:
                if s >= 0 and self.trajectory[i][5]:
                    # unresolvable chain: the slot may hold an unrelated
                    # reused keyframe, so the row is untracked
                    self.trajectory[i] = self.trajectory[i][:5] + (False,)
                bases[i] = pose[min(max(int(refs[i]), 0), K - 1)]
        return _np_se3_mul(rels, bases).astype(np.float32)

    def positions(self) -> np.ndarray:
        """(T, 3) camera centres in the world frame (all frames; mask with
        ``tracked_mask()`` for evaluation)."""
        poses = self.frame_poses()
        if poses.shape[0] == 0:
            return np.zeros((0, 3))
        return lie.se3_inverse(torch.from_numpy(poses))[:, 4:7].numpy()

    def tracked_mask(self) -> np.ndarray:
        """(T,) bool — frames with a real pose estimate."""
        self.flush()
        return np.asarray([r[-1] for r in self.trajectory], bool)
