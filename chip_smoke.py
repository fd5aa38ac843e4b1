#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, exit code != 0):

1. card and toolchain: nvidia-smi name + power limit, torch / CUDA
   versions, nvcc version;
2. build of the hand-written kernels (visual_sgraphs_tpu_torch/csrc) into
   build/kernels/libvsg_kernels.so, with the seconds it took;
3. every kernel against its plain PyTorch twin on the card, at the main
   path's shapes (K1's resize chain, one launch a pyramid, over a batch
   of 8 frames and over one frame as the serial path extracts it, K1's
   blur, one launch (one device operation) an extraction over every
   level of the batch, of one frame, at 240x320, at 720x1280 and on
   levels smaller than its taps, bitwise equal to its twin and from
   launch to launch, K3 keypoint selection over every level of the
   batch in one launch (all five fields bitwise, also on one frame, on
   tie-heavy quantised scores and at 240x320 / 600 features), K7
   compaction, one launch (one device operation) a call, bitwise equal to
   its twin and from launch to launch: its plain entry on 32768-entry
   masks at the main path's three shapes, an empty one and one off a
   16-byte boundary, its observed entry (the observed-point mask built in
   the same launch) on a seeded map and, after phase 4d, on
   ``bench_slice``'s map at the tracking table's keyframes, K9
   observation grouping at the local and global BAs' shapes and on an
   empty list, an all-invalid one, heavy overflow and valid out-of-range
   ids (-1, n_pt, n_pt + 1, 10^6), one launch a call, with the
   nearest single PyTorch call timed beside each as a yardstick; K2
   FAST+NMS and K4 ORB descriptor, each one launch (one device
   operation) an extraction over every level of a batch of 8 frames, of
   one frame, at 240x320, at 720x1280 and on levels smaller than the
   41x41 patch and FAST's ring (K2 bitwise, K4's angles within 1e-5 rad
   and descriptors bitwise given the twin's angles, both bitwise from
   launch to launch), K5 window matcher (no main-path caller since
   ``fuse_observations`` runs on the tracking pass: checked here only),
   the tracking pass
   (K5's redesign: projection, gates, binned window match, gathers, one
   launch) on seeded operands at the main path's four radii (15, 7, 60,
   14 px), every integer output exact and the predicted and gathered
   pixels bitwise, and again after phase 4d on ``bench_slice``'s map and
   last frame, and there at ``fuse_observations``' 4 px on the reference
   keyframe, its even keypoints unlinked (no image gate, no depths), K6
   pose-only GN (also at 1 to 4096 matches, mono and stereo, with and
   without its prior: bitwise equal from launch to launch, one launch a
   call), K8 Schur reduction and back-substitution (with the points'
   update, as the Schur BAs launch it; a seeded eighth of the points
   masked and bitwise unmoved) at the local
   BA's L = 11 and the global BA's L = 128 (the reduction one launch a
   call, S and rhs bitwise equal from launch to launch, S exactly
   symmetric), and after phase 4e on the tables of one of
   ``bench_slice``'s scene-graph BAs (the back-substitution there against
   the float64 twin within the reduction's tolerance), K10 BoW rows, K11's
   two entries (the query, and the keyframe program's query with the
   validity sync, the insertion and the packed vector; one launch, one
   device operation a call, ids, valid count and database bitwise, both
   bitwise from launch to launch) on a seeded (128, 512) database, on
   ``selfcheck.place_cases`` and after phase 4e on a ``bench_slice``
   keyframe's recorded operands, K5's NN ratio (one launch, one device
   operation a call, exact) at the three call shapes on seeded operands
   (1000 x 1000 with angles at 0.85; without at 0.8; 1000 x 1237), on
   ``selfcheck.nn_cases`` and on ``bench_slice``'s first loop
   verification's recorded operands, K12 depth cloud + voxel downsample, K13 weighted RANSAC (every
   round of a detection in one launch, one device operation, bitwise
   equal from launch to launch; also after phase 4e on one of
   ``bench_slice``'s detections), K14 plane statistics; K5's NN-ratio
   entry, K15's Sim3 half, K16 and K19 on the loop path's map saved at
   its first accepted loop, after phase 4; K16 (the guided re-match
   count: the rows' validity, the refined Sim3's projection, the gate
   and the count in one launch, one device operation, exact, bitwise
   from launch to launch) also at 1000 x 1000 seeded, on
   ``selfcheck.guided_cases`` and on ``bench_slice``'s first loop
   verification's recorded operands;
   K15's PnP half on seeded picks, and again (with K5's NN ratio as the
   relocalisation calls it) on phase 5's relocalisation; the inertial path's K18 (preintegration, merge and
   the dead-reckoned pose prediction in one launch) on a 64-row sample
   window, K20 per-frame visual-inertial solve on a rendered
   frame's 1000 keypoints and K6's pose-prior branch at 4096 matches,
   at weights 10, 1e5 and 1e9, where the dominant prior must move the
   pose by >= 0.01 as it moves the twin's; K17a free-space carving on a
   rendered 640x480 frame at a non-identity pose, K17b's components on a
   serpentine grid longer than its 48 sweeps reach and, after phase 4, on
   ``freespace_slice``'s accumulated grid, both exact; K21, the
   scene-graph BA's reduced system (S and rhs with the landmarks' keyframe
   block, one device operation an iteration, bitwise equal from launch to
   launch, S exactly symmetric) and its once-a-call plan (exactly its
   twin's), on seeded operands at D = 402 with live items of all five
   factor types and after phase 4e on the operands of one of
   ``bench_slice``'s scene-graph BA iterations, against the float64 twin,
   and a whole scene-graph BA on ``freespace_slice``'s final map with a
   seeded room, corridor and door, K21 against the float64 twin; K23's
   two entries (the room pair analysis, walls and free space) and K24
   (plane association: one device operation a call, every table bitwise
   from launch to launch)
   on the seeded cases the CPU parity tests use, and again on real inputs:
   K23's wall entry on ``bench_slice``'s final scene graph, K24 on one
   keyframe's detections recorded in phase 4e's untimed run, K23's
   free-space entry on ``freespace_slice``'s final scene graph and its
   grid's cluster centres (integer and bool fields exact, room centres
   within 1e-6 m, plane and observation floats within 1e-5; the eager
   operations of one twin call counted with ``torch.profiler``); after
   phase 4j, K22a
   (the row plan, exact; the LM engine's reprojection rows and landmark
   reduction at two dampings, one launch a call given the plan and
   bitwise equal from launch to launch, and its back-substitution and
   cost, one device operation a call with and without a step, bitwise
   from launch to launch), K22b (the plan: each edge's whitening and the
   valid-edge index, once a solve; the inertial rows and their cost;
   each entry one device operation a call, counted as the nodes of a CUDA graph
   captured from the call; H, g and the cost bitwise equal from launch
   to launch, also on the initialisation problem over that map's
   keyframes and that problem tiled to 100 and 1500 edges) and K22c (the
   damped dense solve and retraction) on
   the inputs of the inertial path's fourth VI local BA (D = 150) and its
   last generic local BA (11 slots, 8192 points, D = 66; also tiled to 22
   and 44 slots), recorded in phase 4j's run, against the float64 twins,
   K22c also on seeded systems of D = 1 to 264 (across its shared-memory
   tiles' limit) and a system that is not positive definite, with
   ``torch.linalg.cholesky_ex`` of the same size as K22c's yardstick),
   with kernel and twin times (CUDA events, median of 20 after 3
   warm-ups; for K1's chain, K22c, K9, K6, K6's prior branch, K5's
   window matcher and K20 also the device time of one call
   (``selfcheck.device_time``), for the kernel and for its library call) and
   the bytes / operations each function needs, from which its bound is
   derived; K25 (the scan's per-frame bookkeeping: its frame entry on
   seeded attempts with the retry taken and accepted, not taken, taken and
   rejected, and after phase 4e on a recorded ``bench_slice`` scan frame;
   its first-frame and tail entries) with integers and decisions exact and
   poses within ``selfcheck.SCAN_POSE_TOL``, and K26 (the Schur BAs' damped
   solve and retraction) at D = 66, 402, 768 and 1536 (each of its three
   paths) on seeded systems, on one
   that is not positive definite (a zero step) and after phase 4e on a
   recorded ``bench_slice`` scene-graph BA iteration, against the float64
   twin with ``cholesky_ex`` + ``cholesky_solve`` timed beside it; both
   one device operation a call and bitwise from launch to launch; the
   keyframe program's map maintenance, K27 (found stats; insertion), K28
   (fusion's prologue and write-back) and K29 (point and keyframe
   culling), on the seeded maps of ``selfcheck.maint_cases`` at the
   cells' capacities (an empty map's first keyframe, a fold, evictions
   with a full ledger and without a parent, tied parents, tied
   covisibility and redundancy) and after phase 4e on a recorded
   ``bench_slice`` keyframe program's operands: integer fields exact,
   floats within ``selfcheck.MAINT_TOL``, the input map unmodified, one
   device operation a call, bitwise from launch to launch;
4. the port's main paths at full size through its public entry point
   (``SlamSystem.track_rgbd``), 640x480 RGB-D, 1000 ORB features,
   128 keyframes / 32768 points, 96 frames of the two-lap ``orbit2``
   sequence rendered on the card, serial path unless stated:
   a. scene graph off, loops off (the tracking + local-mapping path);
   b. scene graph on (``SceneGraphManager`` attached, semantics provided
      per frame, plane covisibility and semantic point refinement on),
      K23's wall entry and K24 launched once per scene-graph keyframe
      (as often as K14);
   c. path (b) again over frames 0-47 under ``torch.cuda.set_sync_debug_
      mode``: synchronising calls per frame against counted readbacks;
   d. ``bench_slice``, the main path: the headline configuration of
      ``bench.py:64-91`` (``main_path.bench_config``: path (b) with loop
      closing, on the B-frame pipeline, ``pipeline_depth=8``) over the
      192-frame ``orbit2`` sequence, fps and counted readbacks over
      frames 64-191, the reference's bench-scale gates (ATE <= 0.1 m,
      >= 90 % tracked, >= 20 keyframes, >= 1 loop), planes,
      serial-relief windows and batch re-tracks, K23's wall entry and K24
      launched once per scene-graph keyframe (as often as K14), K16 once
      a loop verification and its twin never on the card (also on (f));
   e. path (d) again over frames 0-95, frames 64-95 under sync-debug
      mode (four batches, across keyframe cycles): synchronising calls
      must equal the counted readbacks (this run, not timed, also records
      the operands of its eighth plane association for K24's check, of
      its 17th K8 reduction, of its 17th scene-graph BA iteration for
      K21's and K26's, of its eighth plane detection for K13's, of its
      40th scan frame for K25's, and of its eighth keyframe insertion, the
      fuse and the cull after it and its eighth cycle's fold for K27's,
      K28's and K29's);
   f. ``loop_slice``: path (b) with loop closing, a global BA after each
      accepted loop and relocalisation of lost frames;
   g. path (f) again over frames 0-79 under sync-debug mode, across a loop
      closure;
   h. path (f) over frames 0-29, two blank frames and frames 29-39: the
      repeated frame 29 makes the recovery keyframe (the joint scene-graph
      BA on the LM engine), which path (f) reaches when a relocalisation
      fails;
   i. ``inertial_slice``: the inertial row of ``bench.py:178-219``
      (``main_path.inertial_config``: ``Sensor.IMU_RGBD``, 64 keyframes /
      16384 points) over the 128-frame ``orbit`` sequence with its 200 Hz
      IMU samples, fps over frames 48-127, gated on the IMU initialising,
      >= 90 % tracked, ATE <= 0.08 m (the reference's visual-inertial
      gate), >= 8 keyframes, K18, K20, K6's prior branch and K22a / K22b
      / K22c launched and no generic LM linearisation on the card, K22b's
      plan once a solve with inertial rows, K18
      once a frame with samples, no ``predict_state`` on the card and no
      pack a frame (only a keyframe's two); the VI
      local BA's ms a keyframe and the initialisation's ms an attempt
      printed;
   j. path (i) again over a 16-frame window after the IMU initialised
      that holds a keyframe, under sync-debug mode: synchronising calls
      must equal the counted readbacks;
   k. ``freespace_slice``: path (b) with free-space rooms
      (``main_path.freespace_config``), gated as (b), with K17a launched
      once per keyframe, K17b once per maintenance pass, K23's free-space
      entry as often as K17b, its wall entry never, K24 as often as K14
      and K21 once per scene-graph BA iteration; the free-voxel count,
      rooms and corridors printed;
   l. path (k) again over a 16-frame window that holds a maintenance
      pass, under sync-debug mode: synchronising calls must equal the
      counted readbacks;
   the kernel launch counters are zeroed just before each of (a), (b),
   (d), (f), (h), (i) and (k) and read just after (K25's frame entry once
   a scan frame and its first-frame entry once a scan, on (d) only, its
   tail entry once a tracking attempt outside the scan, no K25 twin on the
   card, on (a), (b), (d), (f), (i) and (k); K26 and K8's
   back-substitution once a Schur BA iteration and no ``cholesky_ex`` on
   the card from ``fast_ba.py`` / ``dist_ba.py``, on (a), (b), (d), (f)
   and (k); K1's resize chain,
   K2, K3, K1's blur and K4 must launch once an ORB extraction on each,
   and their plain per-level versions never on the card; on (a), (b),
   (d), (f), (i) and (k) the tracking pass once a tracking pose solve, K6
   or its prior branch, plus once a ``fuse_observations`` call, no
   standalone window matcher launched, K7's observed entry launched and
   ``observed_mask`` never run on the card, K7's plain entry not
   launched; on (a), (b), (d), (f), (i) and (k) K27's insert entry once a
   keyframe insertion, its stats entry once a cycle and once a frame the
   serial step tracks, K28's two entries once a ``fuse_observations`` call and K29
   once a cull, and none of their twins on the card; on (b), (d), (f) and
   (k) K21's
   system once a scene-graph BA iteration, its plan once a call and the
   plain assembly never on the card; on (d) and (f) K11 once a place
   query, the keyframe program's and the relocalisations', and the plain
   insertion never on the card); the JSON
   kernel table's launches are (d)'s, (i)'s for the inertial path's K18,
   K20, K6's prior branch and K22, and (k)'s for K17a and K17b;
5. the same 12 small frames through the port on the card (kernels) and on
   the CPU (twins), with the scene graph off and on, whose positions must
   agree; the loop correction chain (verification, pose graph, map
   correction, fusion, global BA) on the saved map, card against CPU; and
   relocalisation in the loop path's final map of a frame rendered 0.3 m
   off the path, card against CPU; and 72 small ``arc`` frames with their
   IMU samples through the inertial path on the card and on the CPU,
   whose positions, keyframe counts and initialisation frames must agree;
   and 24 small ``arc`` frames through the free-space path (clustering
   every second keyframe) on the card and on the CPU, whose free-voxel
   counts must agree within 1 % and rooms in count and centre within
   0.05 m;
6. the card's name and power limit, the JSON kernel table, and the
   result line.

Needs torch, numpy and nvcc; no JAX and no network.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# NVIDIA H100 SXM peaks (data sheet): HBM3 bandwidth, and float32
# outside the tensor cores; the
# kernels' 32-bit integer work is counted against the same rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

WARM = 16
SG_ONLY = {"depth_cloud", "extract_planes", "plane_epilogue", "sg_assemble",
           "sg_plan", "plane_assoc", "rooms_walls"}
# the free-space room method's kernels (room_method="freespace" only)
FREESPACE_ONLY = {"freespace_carve", "freespace_components",
                  "rooms_freespace"}
# the wall-based room method's kernel (every other scene-graph cell)
WALLS_ONLY = {"rooms_walls"}
LOOP_ONLY = {"bow_vectors", "place_query", "match_nn_ratio", "guided_count",
             "verify_sim3", "pnp_hypotheses", "pgo_assemble", "pgo_cost"}
# the LM engine's kernel route (K22a / K22b / K22c): the inertial path's
# local BAs and initialisation; elsewhere only a recovery keyframe's local
# BA or a loop weld runs them
LM_KERNELS = {"lm_reproj_plan", "lm_reproj_reduce", "lm_reproj_cost",
              "lm_inertial_plan", "lm_inertial_assemble", "lm_inertial_cost",
              "lm_solve"}
INERTIAL_ONLY = {"pose_gn_prior", "preint", "vi_pose"} | LM_KERNELS
# kernels checked in phase 3 only: K5's standalone window matcher has no
# main-path caller since fuse_observations runs on the tracking pass, K7's
# plain entry none since the keyframe insertion's free ids are K27's
PHASE3_ONLY = {"match_window", "compact_true"}
# the keyframe program's map maintenance (K27, K28, K29)
MAP_KERNELS = ("found_stats", "kf_insert", "fuse_prologue", "fuse_writeback",
               "map_cull")
# K27's stats entry folds a cycle's batch (the pipeline) or a frame the
# serial step tracks (every inertial frame, a frame after a loss); the
# serial visual path queues its frames' stats for the keyframe program's
# insertion instead, so a clean serial visual run may not launch it
FOLD_ONLY = {"found_stats"}
# K25's scan entries: only the B-frame pipeline's scan launches them
PIPELINE_ONLY = {"scan_prologue", "scan_epilogue"}
# the kernels of the inertial path
INERTIAL_PATH = INERTIAL_ONLY | {"pyramid_resize", "gaussian_blur",
                                 "fast_nms", "detect_level", "orb_desc",
                                 "track_pass", "pose_gn",
                                 "compact_observed", *MAP_KERNELS}


def _line(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=str), flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _check_sg_launches(tag: str, cnt: dict, freespace: bool = False) -> None:
    """K24 and the cell's room entry of K23 launch once per scene-graph
    keyframe (as often as K14, which the plane detection of each runs);
    with free-space rooms K23's free-space entry launches once per
    clustering pass (as often as K17b) and its wall entry never."""
    n = cnt["plane_epilogue"][0]
    rooms = (cnt["rooms_freespace"][0] == cnt["freespace_components"][0]
             and cnt["rooms_walls"][0] == 0 if freespace
             else cnt["rooms_walls"][0] == n)
    _check(n > 0 and cnt["plane_assoc"][0] == n and rooms,
           f"{tag}: K24 {cnt['plane_assoc'][0]}, K23 walls "
           f"{cnt['rooms_walls'][0]} / free space "
           f"{cnt['rooms_freespace'][0]} launches for {n} scene-graph "
           f"keyframes and {cnt['freespace_components'][0]} clustering "
           "passes")


def _check_pyramid_launches(tag: str, cnt: dict) -> None:
    """K1's resize chain, K2, K3, K1's blur and K4 launch once an ORB
    extraction (a frame on the serial path, a batch on the pipeline; K2,
    K3, the blur and K4 for every budgeted level of it), and no plain K2,
    K3, blur or K4 of a level runs on CUDA tensors."""
    from visual_sgraphs_tpu_torch.features import fast, orb, pyramid
    n = cnt["pyramid_resize"][0]
    plain = (fast.fast_nms_torch.cuda_calls,
             orb.detect_level_torch.cuda_calls,
             pyramid.gaussian_blur_torch.cuda_calls,
             orb.orb_describe_torch.cuda_calls)
    per_kernel = {k: cnt[k][0] for k in ("fast_nms", "detect_level",
                                         "gaussian_blur", "orb_desc")}
    _check(n > 0 and all(v == n for v in per_kernel.values())
           and not any(plain),
           f"{tag}: K1's chain launched {n} times for K2 / K3 / blur / K4 "
           f"launches {per_kernel}; {plain} plain K2 / K3 / blur / K4 level "
           "calls on the card")


def _reset_plain_counts() -> None:
    """Zero the kernel counts and the plain functions' counts of calls on
    CUDA tensors that ``cuda.counts`` does not hold."""
    from visual_sgraphs_tpu_torch import cuda
    from visual_sgraphs_tpu_torch.features import fast, orb, pyramid
    from visual_sgraphs_tpu_torch.inertial import preintegration
    from visual_sgraphs_tpu_torch.optim import fast_ba
    from visual_sgraphs_tpu_torch.parallel import dist_ba
    from visual_sgraphs_tpu_torch.place import database, loop_closer
    from visual_sgraphs_tpu_torch.slam import (cycle_program, map_state,
                                               mapping, tracking)
    cuda.reset_counts()
    cycle_program.make_cycle_program.cuda_cycles = 0
    tracking.track_frame_full.cuda_calls = 0
    fast_ba.fast_scenegraph_ba.cuda_calls = 0
    fast_ba.fast_scenegraph_ba.cuda_iters = 0
    fast_ba.fast_local_ba.cuda_iters = 0
    dist_ba.global_ba_sharded.cuda_iters = 0
    tracking.make_frame_scan.cuda_scans = 0
    tracking.make_frame_scan.cuda_frames = 0
    fast_ba.sg_assemble_torch.cuda_calls = 0
    fast.fast_nms_torch.cuda_calls = 0
    orb.detect_level_torch.cuda_calls = 0
    pyramid.gaussian_blur_torch.cuda_calls = 0
    orb.orb_describe_torch.cuda_calls = 0
    preintegration.predict_state.cuda_calls = 0
    mapping.fuse_observations.cuda_calls = 0
    map_state.observed_mask.cuda_calls = 0
    loop_closer._detect_program.cuda_calls = 0
    loop_closer.reloc_in_map.cuda_calls = 0
    loop_closer._loop_geometry.cuda_calls = 0
    database.add_keyframe.cuda_calls = 0


def _path_calls(system) -> dict:
    """The calls on the card that ``cuda.counts`` does not hold, read just
    after ``system``'s run of a main path: ``fuse_observations``' (one
    tracking pass each), ``observed_mask``'s (the plain composition K7's
    observed entry replaces), the scene-graph BA's calls and iterations
    (K21's plan once a call, its system once an iteration), the plain
    assembly K21 replaces, the place queries (the keyframe program's and
    the relocalisations', K11 once each), the plain insertion K11's
    keyframe entry replaces, the loop verifications (K16 once each), the
    scans and their frames (K25's two scan entries once each), the Schur
    BAs' iterations (K26 once each), the cycles and the serial frames
    (K27's stats entry once each), the keyframe insertions (the map's
    n_kf: K27's insert entry once each) and the culls (the keyframes
    events marked ``cull``: K29 once each)."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    from visual_sgraphs_tpu_torch.parallel import dist_ba
    from visual_sgraphs_tpu_torch.place import database, loop_closer
    from visual_sgraphs_tpu_torch.slam import (cycle_program, map_state,
                                               mapping, tracking)
    ev = system.events
    return dict(place_queries=loop_closer._detect_program.cuda_calls,
                reloc_queries=loop_closer.reloc_in_map.cuda_calls,
                add_keyframe=database.add_keyframe.cuda_calls,
                loop_verifications=loop_closer._loop_geometry.cuda_calls,
                fuse=mapping.fuse_observations.cuda_calls,
                observed_mask=map_state.observed_mask.cuda_calls,
                sg_ba=fast_ba.fast_scenegraph_ba.cuda_calls,
                sg_ba_iters=fast_ba.fast_scenegraph_ba.cuda_iters,
                sg_assemble_torch=fast_ba.sg_assemble_torch.cuda_calls,
                scans=tracking.make_frame_scan.cuda_scans,
                scan_frames=tracking.make_frame_scan.cuda_frames,
                schur_iters=(fast_ba.fast_local_ba.cuda_iters
                             + fast_ba.fast_scenegraph_ba.cuda_iters
                             + dist_ba.global_ba_sharded.cuda_iters),
                gba_iters=dist_ba.global_ba_sharded.cuda_iters,
                cycles=cycle_program.make_cycle_program.cuda_cycles,
                serial_frames=tracking.track_frame_full.cuda_calls,
                inserts=int(system.map.n_kf),
                culls=sum(bool(e.get("cull")) for e in ev.of_kind("keyframe")
                          + ev.of_kind("recovery_keyframe")))


@contextlib.contextmanager
def _match_window_callers():
    """Inside the block, count K5's standalone window matcher's calls by
    the calling file: every module's binding of ``match_window`` (not the
    wrapper itself, whose launch count ``cuda.counts`` reads) goes through
    a spy."""
    from visual_sgraphs_tpu_torch.features import match
    orig = match.match_window
    seen = collections.Counter()

    def spy(*args, **kw):
        seen[sys._getframe(1).f_code.co_filename.rsplit("/", 1)[-1]] += 1
        return orig(*args, **kw)

    bound = [m for m in list(sys.modules.values())
             if m is not None and m is not match
             and getattr(m, "match_window", None) is orig]
    for m in bound:
        m.match_window = spy
    try:
        yield seen
    finally:
        for m in bound:
            m.match_window = orig


@contextlib.contextmanager
def _schur_choleskies():
    """Inside the block, count the calls of ``torch.linalg.cholesky_ex`` on
    CUDA tensors from the Schur BAs' modules (``optim/fast_ba.py``,
    ``parallel/dist_ba.py``), where K26 factors on the card."""
    orig = torch.linalg.cholesky_ex
    seen = collections.Counter()

    def spy(A, *args, **kw):
        f = sys._getframe(1).f_code.co_filename.rsplit("/", 1)[-1]
        if A.is_cuda and f in ("fast_ba.py", "dist_ba.py"):
            seen[f] += 1
        return orig(A, *args, **kw)

    torch.linalg.cholesky_ex = spy
    try:
        yield seen
    finally:
        torch.linalg.cholesky_ex = orig


@contextlib.contextmanager
def _card_packs():
    """Inside the block, count the calls of ``preintegration.pack`` on one
    (unbatched) preintegration on the card by the calling function: every
    module's binding of ``pack`` goes through a spy."""
    from visual_sgraphs_tpu_torch.inertial import preintegration
    orig = preintegration.pack
    seen = collections.Counter()

    def spy(pre):
        if pre.dV.is_cuda and pre.dV.dim() == 1:
            seen[sys._getframe(1).f_code.co_name] += 1
        return orig(pre)

    bound = [m for m in list(sys.modules.values())
             if m is not None and getattr(m, "pack", None) is orig]
    for m in bound:
        m.pack = spy
    try:
        yield seen
    finally:
        for m in bound:
            m.pack = orig


@contextlib.contextmanager
def _inertial_solves():
    """Inside the block, count the LM solves that hold inertial rows (the
    VI local BAs and the initialisation attempts), each of which builds
    K22b's plan once."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    orig = lmk.optimize_reproj_inertial
    seen = {"solves": 0}

    def spy(*args, **kw):
        if kw.get("imu") is not None:
            seen["solves"] += 1
        return orig(*args, **kw)

    lmk.optimize_reproj_inertial = spy
    try:
        yield seen
    finally:
        lmk.optimize_reproj_inertial = orig


def _check_track_launches(tag: str, cnt: dict, callers,
                          calls: dict) -> None:
    """The tracking pass launches once a pose solve of tracking (K6 and
    its prior branch, less the PnP refinement of each relocalisation) and
    once a ``fuse_observations`` call, and no module launches the
    standalone window matcher."""
    k6 = (cnt["pose_gn"][0] + cnt["pose_gn_prior"][0]
          - cnt["pnp_hypotheses"][0])
    n = cnt["track_pass"][0]
    _check(calls["fuse"] > 0 and n == k6 + calls["fuse"] and not callers
           and cnt["match_window"][0] == 0,
           f"{tag}: {n} tracking passes for {k6} tracking pose solves and "
           f"{calls['fuse']} fuse_observations calls; window matcher "
           f"{cnt['match_window'][0]} launches, callers {dict(callers)}")


def _check_scan_launches(tag: str, cnt: dict, calls: dict,
                         pipeline: bool) -> None:
    """K25's frame entry launches once a scan frame and its first-frame
    entry once a scan (the pipeline's cells only), its tail entry once a
    tracking attempt outside the scan (two pose solves each, two attempts
    a scan frame), and no twin of K25 runs on the card."""
    k6 = (cnt["pose_gn"][0] + cnt["pose_gn_prior"][0]
          - cnt["pnp_hypotheses"][0])
    serial = k6 // 2 - 2 * calls["scan_frames"]
    twins = sum(cnt[k][1] for k in ("scan_epilogue", "scan_prologue",
                                    "inlier_tail"))
    _check((calls["scan_frames"] > 0) == pipeline
           and cnt["scan_epilogue"][0] == calls["scan_frames"]
           and cnt["scan_prologue"][0] == calls["scans"]
           and cnt["inlier_tail"][0] == serial and twins == 0,
           f"{tag}: K25 {cnt['scan_epilogue'][0]} frame / "
           f"{cnt['scan_prologue'][0]} first-frame / "
           f"{cnt['inlier_tail'][0]} tail launches for "
           f"{calls['scan_frames']} scan frames in {calls['scans']} scans "
           f"and {serial} serial attempts; {twins} twin calls on the card")


def _check_ba_launches(tag: str, cnt: dict, calls: dict, chol) -> None:
    """K26 launches once a Schur BA iteration (windowed, scene-graph and
    global), as does K8's back-substitution, and no ``cholesky_ex`` runs
    on the card from the Schur BAs' modules."""
    n = calls["schur_iters"]
    _check(n > 0 and cnt["ba_solve"][0] == n
           and cnt["schur_backsub"][0] == n and not chol
           and cnt["ba_solve"][1] == 0,
           f"{tag}: K26 {cnt['ba_solve'][0]} / K8 back-substitution "
           f"{cnt['schur_backsub'][0]} launches for {n} Schur BA "
           f"iterations; cholesky_ex on the card {dict(chol)}")


def _check_compact_launches(tag: str, cnt: dict, calls: dict) -> None:
    """K7's observed entry launches where the plain composition
    (``observed_mask`` & ``pt_valid``, then ``compact_true``) ran (the
    tracking tables and the BA windows; the fuse's runs inside K28),
    ``observed_mask`` never runs on the card, and K7's plain entry, whose
    last caller was the insertion's free ids (now K27's), is not
    launched."""
    n = cnt["compact_observed"][0]
    _check(n > 0 and calls["observed_mask"] == 0
           and cnt["compact_true"][0] == 0,
           f"{tag}: K7's observed entry {n} / plain entry "
           f"{cnt['compact_true'][0]} launches; {calls['observed_mask']} "
           "observed_mask calls on the card")


def _check_map_launches(tag: str, cnt: dict, calls: dict) -> None:
    """K27's insert entry launches once a keyframe insertion (the
    program's, the serial keyframe's and the first frame's: the map's
    n_kf), its stats entry once a cycle (the batch's fold, its acceptance
    mask inside) and once a frame the serial step tracks
    (``track_frame_full``), K28's prologue and write-back
    once a ``fuse_observations`` call each and K29 once a cull (a
    keyframe program with ``do_cull``, every serial keyframe), and none of
    their twins runs on the card."""
    stats = calls["cycles"] + calls["serial_frames"]
    twins = {k: cnt[k][1] for k in MAP_KERNELS if cnt[k][1]}
    _check(cnt["kf_insert"][0] == calls["inserts"] > 0
           and cnt["found_stats"][0] == stats
           and cnt["fuse_prologue"][0] == cnt["fuse_writeback"][0]
           == calls["fuse"] > 0
           and cnt["map_cull"][0] == calls["culls"] > 0 and not twins,
           f"{tag}: K27 insert {cnt['kf_insert'][0]} launches for "
           f"{calls['inserts']} insertions, stats {cnt['found_stats'][0]} "
           f"for {calls['cycles']} cycles and {calls['serial_frames']} "
           f"serial frames; K28 {cnt['fuse_prologue'][0]} / "
           f"{cnt['fuse_writeback'][0]} for {calls['fuse']} fuses; K29 "
           f"{cnt['map_cull'][0]} for {calls['culls']} culls; twins on the "
           f"card {twins}")


def _check_sg_system_launches(tag: str, cnt: dict, calls: dict) -> None:
    """K21's system launches once a scene-graph BA iteration and its plan
    once a call, and the plain assembly never runs on the card."""
    _check(calls["sg_ba"] > 0
           and cnt["sg_assemble"][0] == calls["sg_ba_iters"]
           and cnt["sg_plan"][0] == calls["sg_ba"]
           and calls["sg_assemble_torch"] == 0,
           f"{tag}: K21 {cnt['sg_assemble'][0]} system / "
           f"{cnt['sg_plan'][0]} plan launches for {calls['sg_ba']} "
           f"scene-graph BAs of {calls['sg_ba_iters']} iterations; "
           f"{calls['sg_assemble_torch']} plain assemblies on the card")


def _check_place_launches(tag: str, cnt: dict, calls: dict) -> None:
    """K11 launches once a place query (the keyframe program's, each with
    its insertion, and each relocalisation's), and the plain insertion
    never runs on the card."""
    n = calls["place_queries"] + calls["reloc_queries"]
    _check(calls["place_queries"] > 0 and cnt["place_query"][0] == n
           and calls["add_keyframe"] == 0,
           f"{tag}: K11 {cnt['place_query'][0]} launches for "
           f"{calls['place_queries']} keyframe place queries and "
           f"{calls['reloc_queries']} relocalisations; "
           f"{calls['add_keyframe']} plain insertions on the card")


def _check_loop_launches(tag: str, cnt: dict, calls: dict) -> None:
    """K16 launches once a loop verification (the rows' validity, the Sim3
    projection and the count in the one launch), and its twin never runs
    on the card."""
    n = calls["loop_verifications"]
    _check(n > 0 and cnt["guided_count"][0] == n
           and cnt["guided_count"][1] == 0,
           f"{tag}: K16 {cnt['guided_count'][0]} launches for {n} loop "
           f"verifications; {cnt['guided_count'][1]} twin calls on the card")


def _bound(r: dict) -> tuple[float, str]:
    """Least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger (ms)."""
    t_bytes = r["bytes"] / PEAK_BYTES_PER_S
    t_ops = r["ops"] / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _drive(system, frames, warm: int = WARM, sync_window=None,
           feed=None, after=None) -> dict:
    """Feed ``frames`` [(gray, depth, sem, T_wc, ts)] (or, with ``feed``,
    whatever it takes; ``after(i)`` runs after frame i); returns timing
    and readback figures over frames ``warm``.. (and, with
    ``sync_window`` (lo, hi), the synchronising calls counted by
    sync-debug mode and the keyframes made over frames lo..hi-1)."""
    torch.cuda.synchronize()
    t_warm = readbacks_warm = None
    warm_stages = {}
    syncs = None
    caught = None
    from visual_sgraphs_tpu_torch import main_path
    feed = feed or main_path.feed
    for i, frame in enumerate(frames):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
            readbacks_warm = system.host_readbacks
            warm_stages = system.timers.summary()
            system.timers.reset()
        if sync_window is not None and i == sync_window[0]:
            rb_lo = system.host_readbacks
            kf_lo = system.events.count("keyframe")
            vi_lo = system.events.count("vi_solve")
            # switching the mode on warns once itself: record after it
            torch.cuda.set_sync_debug_mode(1)
            caught = warnings.catch_warnings(record=True)
            log = caught.__enter__()
            warnings.simplefilter("always")
        feed(system, frame)
        if after is not None:
            after(i)
        if sync_window is not None and i == sync_window[1] - 1:
            caught.__exit__(None, None, None)
            torch.cuda.set_sync_debug_mode(0)
            n = sync_window[1] - sync_window[0]
            sites = collections.Counter(
                f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in log
                if "synchroniz" in str(w.message))
            syncs = dict(
                syncs_per_frame=sum(sites.values()) / n,
                readbacks_per_frame=(system.host_readbacks - rb_lo) / n,
                keyframes=system.events.count("keyframe") - kf_lo,
                vi_solves=system.events.count("vi_solve") - vi_lo,
                sync_sites=dict(sites.most_common(8)))
    system.flush()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    out = dict(fps=(len(frames) - warm) / (t_end - t_warm),
               readbacks_per_frame=(system.host_readbacks - readbacks_warm)
               / (len(frames) - warm), warm_stages=warm_stages)
    if syncs is not None:
        out.update(syncs)
    return out


def _accuracy(system, frames, gt=None) -> dict:
    """Tracked frames, keyframes, points and ATE against the frames'
    ground truth (``gt``: (n, 3) camera centres, else from the frames'
    T_wc)."""
    from visual_sgraphs_tpu_torch.core import geometry
    if gt is None:
        gt = np.stack([T[4:7] for _, _, _, T, _ in frames])
    pos = system.positions()
    tracked = system.tracked_mask()
    ate = float(geometry.ate_rmse(torch.from_numpy(pos[tracked]),
                                  torch.from_numpy(gt[tracked]))[0])
    _check(np.isfinite(pos).all() and pos.shape == (len(frames), 3),
           "positions not finite")
    return dict(tracked=int(tracked.sum()), n_kf=int(system.map.n_kf),
                n_pt=int(system.map.n_pt), ate_m=ate)


def _scenegraph_summary(system) -> dict:
    from visual_sgraphs_tpu_torch.scenegraph.manager import sign_duplicates
    mgr = system.scenegraph
    planes = mgr.planes()
    return dict(n_planes=int(len(planes["coeffs"])),
                plane_classes=planes["semantic"].tolist(),
                plane_coeffs=np.round(planes["coeffs"], 4).tolist(),
                n_rooms=int(mgr.state.n_rooms), n_obs=int(mgr.state.n_obs),
                sign_duplicates=sign_duplicates(planes["coeffs"]))


def _watch_loops(system) -> dict:
    """Keep a copy of the map just before the first accepted loop's
    correction, record every accepted loop (a loop accepted at the end of
    the stream, in ``flush``, emits no ``loop_closed`` event), and count
    the K8 launches made inside global BAs."""
    from visual_sgraphs_tpu_torch.parallel import dist_ba
    from visual_sgraphs_tpu_torch.slam.map_state import MapState
    lc = system.loop_closer
    state = {"saved": None, "closed": [], "gba_k8": 0}
    verify, gba = lc.resolve_verify, system.run_global_ba

    def resolve_verify(sys_):
        pv, n0 = lc._pending_verify, lc.n_loops_closed
        snap = None
        if pv is not None and state["saved"] is None:
            snap = dict(map=MapState(*(t.clone() for t in sys_.map)),
                        kf=pv[0], cand=pv[1])
        out = verify(sys_)
        if lc.n_loops_closed > n0:
            state["closed"].append((pv[0], pv[1]))
            if snap is not None:
                state["saved"] = snap
        return out

    def run_global_ba(iters: int = 10):
        n0 = dist_ba.local_reduced_system.launches
        gba(iters)
        state["gba_k8"] += dist_ba.local_reduced_system.launches - n0

    lc.resolve_verify = resolve_verify
    system.run_global_ba = run_global_ba
    return state


def _loop_summary(system, frames, closed) -> dict:
    """Loops (``closed``: the accepted (kf, cand) pairs), global BAs,
    relocalisations, the vocabulary and the position error (after the ATE
    alignment) every 8 frames."""
    from visual_sgraphs_tpu_torch.core import geometry, lie
    ev = system.events
    verified = [dict(kf=e["kf"], cand=e["cand"], drift=e["drift"],
                     n_inl=e["n_inl"], n_guided=e["n_guided"],
                     closed=(e["kf"], e["cand"]) in closed)
                for e in ev.of_kind("loop_verified")]
    gt = np.stack([T[4:7] for _, _, _, T, _ in frames])
    pos, tracked = system.positions(), system.tracked_mask()
    _, S = geometry.ate_rmse(torch.from_numpy(pos[tracked]),
                             torch.from_numpy(gt[tracked]))
    err = np.linalg.norm(lie.sim3_apply(S, torch.from_numpy(pos)).numpy()
                         - gt, axis=1)
    lc = system.loop_closer
    return dict(n_loops_closed=lc.n_loops_closed,
                loops=[list(c) for c in closed], verified=verified,
                n_global_ba=ev.count("global_ba"), n_reloc=ev.count("reloc"),
                reloc_cands=[e["cand"] for e in ev.of_kind("reloc")],
                recovery_keyframes=[[e["kf"], e["joint_ba"]] for e in
                                    ev.of_kind("recovery_keyframe")],
                vocab_words=lc.vocab.n_words if lc.vocab else None,
                pos_err_every_8=[round(float(err[i]), 4) if tracked[i]
                                 else None for i in range(0, len(frames), 8)])


def _loop_chain(m, kf: int, cand: int, cam_K, cam_bf, pc):
    """Verification -> pose graph -> map correction -> fusion -> global
    BA of one loop, on whichever device ``m`` lies (the kernels on the
    card, the twins on the CPU), on the same samples."""
    from visual_sgraphs_tpu_torch.core import lie
    from visual_sgraphs_tpu_torch.parallel.dist_ba import global_ba_sharded
    from visual_sgraphs_tpu_torch.place import pgo
    from visual_sgraphs_tpu_torch.place.loop_closer import (
        _loop_geometry, default_draw)
    from visual_sgraphs_tpu_torch.slam import mapping
    S, n_inl, n_guided, _ = _loop_geometry(
        m, kf, cand, lambda v: default_draw("sim3", 1234, v),
        pc.loop_inlier_thresh_3d, cam_K, fix_scale=True)
    edges = pgo.build_covis_edges(m, pc.essential_min_weight,
                                  pc.essential_max_edges)
    res = pgo.optimize_essential_graph(
        m.kf_pose, m.kf_valid, edges, cand, kf, lie.sim3_inverse(S),
        torch.arange(m.K, device=S.device) == cand, pc.pgo_iters, True)
    m = mapping.fuse_observations(pgo.correct_map(m, res), kf, cam_K)
    m, _ = global_ba_sharded(m, cam_K, cam_bf, iters=pc.gba_iters)
    centres = lie.se3_inverse(m.kf_pose)[:, 4:7]
    return (S.cpu(), int(n_inl), int(n_guided),
            centres[m.kf_valid].cpu().numpy())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from visual_sgraphs_tpu_torch import cuda, main_path, selfcheck
    from visual_sgraphs_tpu_torch.config import CapacityConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # ---- 1. card and toolchain
    card = _card()
    nvcc = subprocess.run([cuda.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    _line("toolchain", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=nvcc,
          python=sys.version.split()[0])

    # ---- 2. kernel build
    _, build_s = cuda.build(force=True, verbose=True)
    cuda.library()
    _line("build", seconds=build_s, lib=str(cuda.BUILD_DIR / cuda.LIB_NAME))

    # ---- 3. each kernel against its twin at the main path's shapes
    checks = {}

    def report(results):
        for r in results:
            bound_ms, bound_by = _bound(r)
            r.update(bound_ms=bound_ms, bound_by=bound_by)
            _line("kernel", **r)
            checks[r["name"]] = r
        bad = [r["name"] for r in results if not r["ok"]]
        _check(not bad, f"kernels disagree with their twins: {bad}")

    report(selfcheck.run_all(device) + [
        selfcheck.check_bow(device), selfcheck.check_place_query(device),
        *selfcheck.run_place_cases(device),
        selfcheck.check_match_nn(device, name="match_nn_ratio@seeded"),
        selfcheck.check_match_nn(device, ratio=0.8, angles=False,
                                 name="match_nn_ratio@reloc_seeded"),
        selfcheck.check_match_nn(device, selfcheck.nn_inputs(
            device, 1000, n_b=1237), name="match_nn_ratio@1000x1237"),
        *selfcheck.run_nn_cases(device),
        selfcheck.check_guided(device, name="guided_count@seeded"),
        *selfcheck.run_guided_cases(device),
        *selfcheck.check_schur_gba(device),
        *selfcheck.check_front_end_small(device),
        *selfcheck.run_scan(device), *selfcheck.run_ba_solve(device),
        *selfcheck.run_maintenance(device)])
    _check(checks["detect_level@240x320"]["padded_levels"] >= 1,
           "K3 at 240x320: no level shorter than its budget")
    _check(checks["detect_level@720x1280"]["max_candidates"] > 1024,
           "K3 at 720x1280: no level past 1024 candidates")
    # K15's PnP half on seeded picks of six distinct matches, where every
    # hypothesis is well posed, so every output is compared (phase 5 checks
    # it again on the loop path's map, where repeated picks occur)
    report([selfcheck.check_pnp(device)])
    _check(checks["pnp_hypotheses"]["n_well_posed"] == 192
           and checks["pnp_hypotheses"]["winner_well_posed"],
           "K15 PnP: a seeded hypothesis is not well posed")
    # the inertial path's kernels: K18, K20 and K6's pose prior
    report(selfcheck.run_inertial(device))
    # K17a, K17b on the snake grid, K21 on seeded operands
    report(selfcheck.run_freespace(device))
    _check(all(checks["sg_assemble"]["live_items"].values()),
           "K21: a factor type has no live item")
    # K23 (walls, free space) and K24 on the CPU parity tests' cases
    report(selfcheck.run_rooms(device))

    # ---- 4. the main paths at full size
    scene, frames = main_path.frames(device)
    n_frames = len(frames)
    cfg, sg_cfg = main_path.configs(scene)
    counts = {}
    for tag, c, with_sg in (("slice", cfg, False),
                            ("scenegraph_slice", sg_cfg, True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        system = main_path.make_system(c, device, with_sg)
        _reset_plain_counts()
        t0 = time.perf_counter()
        with _match_window_callers() as callers, \
                _schur_choleskies() as chol:
            perf = _drive(system, frames)
        total_s = time.perf_counter() - t0
        counts[tag] = cuda.counts()
        calls = _path_calls(system)
        acc = _accuracy(system, frames)
        extra = _scenegraph_summary(system) if with_sg else {}
        _line(tag, frames=n_frames, **acc, fps_16_95=perf["fps"],
              total_s=total_s,
              host_readbacks_per_frame=perf["readbacks_per_frame"],
              keyframes=system.events.count("keyframe"),
              kf_culled=system.events.count("kf_culled"),
              peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20, **extra)
        _line(tag + "_stages", **system.timers.summary())
        _line(tag + "_launches", path_calls=calls, **{
            k: {"launches": v[0], "twin_calls_on_cuda": v[1]}
            for k, v in counts[tag].items()})
        _check(acc["tracked"] >= 90,
               f"{tag}: tracked {acc['tracked']}/{n_frames}")
        _check(acc["n_kf"] >= 2, f"{tag}: n_kf {acc['n_kf']}")
        _check(acc["ate_m"] < 0.05, f"{tag}: ATE {acc['ate_m']:.4f} m")
        _check(all(v[1] == 0 for v in counts[tag].values()),
               f"{tag}: a twin ran on CUDA tensors: {counts[tag]}")
        _check_pyramid_launches(tag, counts[tag])
        _check_track_launches(tag, counts[tag], callers, calls)
        _check_compact_launches(tag, counts[tag], calls)
        _check_map_launches(tag, counts[tag], calls)
        _check_scan_launches(tag, counts[tag], calls, pipeline=False)
        _check_ba_launches(tag, counts[tag], calls, chol)
        if with_sg:
            _check(extra["n_planes"] >= 2,
                   f"{tag}: n_planes {extra['n_planes']}")
            _check(not extra["sign_duplicates"],
                   f"{tag}: sign-duplicate planes {extra['sign_duplicates']}")
            _check_sg_launches(tag, counts[tag])
            _check_sg_system_launches(tag, counts[tag], calls)
        # the loop kernels run on loop_slice only, the plane kernels with
        # the scene graph only
        skip = (LOOP_ONLY | INERTIAL_ONLY | FREESPACE_ONLY | PHASE3_ONLY
                | PIPELINE_ONLY | FOLD_ONLY | (set() if with_sg else SG_ONLY))
        _check(all(v[0] > 0 for k, v in counts[tag].items()
                   if k not in skip),
               f"{tag}: a kernel was not launched: {counts[tag]}")
        del system

    # 4c. hidden host syncs of the scene-graph path
    system = main_path.make_system(sg_cfg, device, True)
    syncs = _drive(system, frames[:48], sync_window=(16, 48))
    _line("scenegraph_sync_debug", frames="16-47",
          syncs_per_frame=syncs["syncs_per_frame"],
          readbacks_per_frame=syncs["readbacks_per_frame"],
          sync_sites=syncs["sync_sites"])
    _check(syncs["syncs_per_frame"] <= syncs["readbacks_per_frame"],
           f"hidden host syncs on the scene-graph path: {syncs}")
    del system

    # 4d. bench_slice: the headline configuration of bench.py:64-91 on
    # the B-frame pipeline, 192 frames, fps over frames 64-191
    bench_frames = main_path.frames(device, main_path.BENCH_FRAMES)[1]
    bench_cfg = main_path.bench_config(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system = main_path.make_system(bench_cfg, device, True)
    bench_watch = _watch_loops(system)
    _reset_plain_counts()
    t0 = time.perf_counter()
    # (the first loop verification's NN-ratio and guided-count operands
    # are copied once: two 32 KB descriptor sets and their keyframes' rows)
    with _match_window_callers() as callers, \
            _schur_choleskies() as chol, \
            selfcheck.watch_nn(which=1) as nn_seen, \
            selfcheck.watch_guided(which=1) as guided_seen:
        perf = _drive(system, bench_frames, warm=main_path.BENCH_WARMUP)
    total_s = time.perf_counter() - t0
    counts["bench_slice"] = cuda.counts()
    calls = _path_calls(system)
    acc = _accuracy(system, bench_frames)
    loops = _loop_summary(system, bench_frames, bench_watch["closed"])
    sg_sum = _scenegraph_summary(system)
    ev = system.events
    _line("bench_slice", frames=len(bench_frames), **acc,
          fps_64_191=perf["fps"], fps_64_191_pr5=16.569106091514872,
          total_s=total_s,
          host_readbacks_per_frame_64_191=perf["readbacks_per_frame"],
          keyframes=ev.count("keyframe"), kf_culled=ev.count("kf_culled"),
          serial_relief=ev.count("serial_relief"),
          batch_retrack=ev.count("batch_retrack"),
          peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
          **sg_sum, **loops)
    _line("bench_slice_stages", **system.timers.summary())
    _line("bench_slice_launches", path_calls=calls, **{
        k: {"launches": v[0], "twin_calls_on_cuda": v[1]}
        for k, v in counts["bench_slice"].items()})
    _check(acc["tracked"] >= 0.9 * len(bench_frames),
           f"bench_slice: tracked {acc['tracked']}/{len(bench_frames)}")
    _check(acc["n_kf"] >= 20, f"bench_slice: n_kf {acc['n_kf']}")
    # the reference's bench-scale pipelined gate (tests/test_pipeline.py)
    _check(acc["ate_m"] <= 0.1, f"bench_slice: ATE {acc['ate_m']:.4f} m")
    _check(loops["n_loops_closed"] >= 1, "bench_slice: no loop closed")
    _check(not sg_sum["sign_duplicates"] and sg_sum["n_planes"] >= 2,
           f"bench_slice: planes {sg_sum['n_planes']}, sign duplicates "
           f"{sg_sum['sign_duplicates']}")
    _check(perf["readbacks_per_frame"] < 1.0,
           f"bench_slice: {perf['readbacks_per_frame']} readbacks a frame")
    _check_pyramid_launches("bench_slice", counts["bench_slice"])
    _check(all(v[1] == 0 for v in counts["bench_slice"].values()),
           f"bench_slice: a twin ran on CUDA tensors: "
           f"{counts['bench_slice']}")
    _check(all(v[0] > 0 for k, v in counts["bench_slice"].items()
               if k != "pnp_hypotheses"
               and k not in INERTIAL_ONLY | FREESPACE_ONLY | PHASE3_ONLY),
           f"bench_slice: a kernel was not launched: "
           f"{counts['bench_slice']}")
    _check_sg_launches("bench_slice", counts["bench_slice"])
    _check_sg_system_launches("bench_slice", counts["bench_slice"], calls)
    _check_track_launches("bench_slice", counts["bench_slice"], callers,
                          calls)
    _check_compact_launches("bench_slice", counts["bench_slice"], calls)
    _check_map_launches("bench_slice", counts["bench_slice"], calls)
    _check_place_launches("bench_slice", counts["bench_slice"], calls)
    _check_loop_launches("bench_slice", counts["bench_slice"], calls)
    _check_scan_launches("bench_slice", counts["bench_slice"], calls,
                         pipeline=True)
    _check_ba_launches("bench_slice", counts["bench_slice"], calls, chol)
    _check(calls["gba_iters"] > 0, "bench_slice: no global BA iteration")
    bench_calls = calls
    # K5's NN ratio and K16 on the cell's first loop verification's
    # operands
    _check("operands" in nn_seen and "operands" in guided_seen,
           "bench_slice: no loop verification")
    report([selfcheck.check_match_nn(device, nn_seen["operands"],
                                     name="match_nn_ratio@bench",
                                     **nn_seen["kw"]),
            selfcheck.check_guided(device, guided_seen["operands"],
                                   name="guided_count@bench")])
    # the tracking pass at the four radii on the cell's map and last frame
    gray, depth, _, _, ts = bench_frames[-1]
    report(selfcheck.check_track_pass_radii(
        device, selfcheck.track_pass_map_inputs(system, gray, depth, ts)))
    # K7's observed entry on the cell's map at the tracking table's
    # keyframes; the tracking pass at fuse_observations' 4 px on the
    # reference keyframe, its even keypoints unlinked (every keypoint with
    # depth seeds a point: none is free otherwise)
    report([selfcheck.check_compact_observed(
        device, selfcheck.observed_map_inputs(system),
        name="compact_observed@map"), selfcheck.check_track_pass(
        device, selfcheck.fuse_pass_inputs(system.map, system.ref_kf_host,
                                           system.cam_K),
        selfcheck.FUSE_RADIUS, "track_pass@fuse", want_depth=False)])
    _check(checks["track_pass@fuse"]["n_matched"] > 0,
           "track_pass@fuse: no match on the unlinked keyframe")
    # K23's wall entry on the cell's final scene graph
    report([selfcheck.check_rooms(device, system.scenegraph.state, "walls",
                                  min_votes=bench_cfg.scenegraph
                                  .plane_min_votes)])
    del system

    # 4e. hidden host syncs of the pipeline: frames 64-95 (four batches)
    # under sync-debug mode, across keyframe cycles
    system = main_path.make_system(bench_cfg, device, True)
    with selfcheck.watch_assoc(which=8) as assoc_seen, \
            selfcheck.watch_schur(which=17) as schur_seen, \
            selfcheck.watch_sg_system(which=17) as sg_seen, \
            selfcheck.watch_planes(which=8) as planes_seen, \
            selfcheck.watch_place(which=8) as place_seen, \
            selfcheck.watch_scan(which=40) as scan_seen, \
            selfcheck.watch_ba_solve(which=17) as ba_seen, \
            selfcheck.watch_maintenance(which=8) as maint_seen:
        syncs = _drive(system, bench_frames[:96], warm=64,
                       sync_window=(64, 96))
    _line("bench_sync_debug", frames="64-95", keyframes=syncs["keyframes"],
          syncs_per_frame=syncs["syncs_per_frame"],
          readbacks_per_frame=syncs["readbacks_per_frame"],
          sync_sites=syncs["sync_sites"])
    _check(syncs["keyframes"] >= 1, "bench_sync_debug: no keyframe inside")
    _check(syncs["syncs_per_frame"] == syncs["readbacks_per_frame"],
           f"bench_sync_debug: syncs differ from counted readbacks: {syncs}")
    del system
    # K11's two entries on the recorded keyframe place query's database
    _check("operands" in place_seen, "bench_sync_debug: no place query")
    pq = place_seen["operands"]
    report([selfcheck.check_place_query(device, pq[:7], "place_query@bench",
                                        ratio=pq[7], top_n=pq[8])])
    # K24 on the recorded keyframe's detections and scene graph
    _check("operands" in assoc_seen, "bench_sync_debug: no plane association")
    # K8 on the tables of a scene-graph BA of the same run (8192 rows,
    # most of them empty)
    _check("operands" in schur_seen, "bench_sync_debug: no K8 call")
    report(selfcheck.check_schur(device, args=schur_seen["operands"],
                                 name="schur_reduce@window", back="f64"))
    # K21's plan and system on the operands of a scene-graph BA iteration
    # of the same run (most factor items dead), K13 on one keyframe's
    # detection
    _check("operands" in sg_seen and "operands" in planes_seen,
           "bench_sync_debug: no scene-graph BA or no plane detection")
    report([selfcheck.check_sg_plan(device, sg_seen["operands"],
                                    name="sg_plan@window"),
            selfcheck.check_sg_assemble(device, args=sg_seen["operands"],
                                        name="sg_assemble@window"),
            selfcheck.check_extract_planes(device, planes_seen["operands"])])
    # K25 on a recorded scan frame (its frame entry; the tail entry on its
    # first attempt) and K26 on a recorded scene-graph BA iteration
    _check("operands" in scan_seen and "operands" in ba_seen,
           "bench_sync_debug: no scan frame or no scene-graph BA")
    sc = scan_seen["operands"]
    report([*selfcheck.check_scan_epilogue(device, sc),
            selfcheck.check_inlier_tail(device, (sc[0], sc[2], sc[6]),
                                        "inlier_tail@bench"),
            selfcheck.check_ba_solve(device, ba_seen["operands"],
                                     "ba_solve@bench")])
    # K27-K29 on the eighth keyframe program's insertion, fuse and cull
    # and the eighth cycle's fold
    _check(all(k in maint_seen for k in ("operands", "fuse", "cull",
                                         "fold")),
           "bench_sync_debug: no keyframe program with a cull, or no fold")
    report(selfcheck.check_recorded_maintenance(device, maint_seen))
    sg_cfg_b = bench_cfg.scenegraph
    report([selfcheck.check_plane_assoc(
        device, *assoc_seen["operands"],
        ominus_thresh=sg_cfg_b.plane_assoc_ominus_thresh,
        dist_thresh=sg_cfg_b.plane_assoc_dist_thresh)])

    # 4f. the loop path
    loop_cfg = main_path.loop_config(sg_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system = main_path.make_system(loop_cfg, device, True)
    watch = _watch_loops(system)
    _reset_plain_counts()
    t0 = time.perf_counter()
    with _match_window_callers() as callers, _schur_choleskies() as chol:
        perf = _drive(system, frames)
    total_s = time.perf_counter() - t0
    counts["loop_slice"] = cuda.counts()
    calls = _path_calls(system)
    acc = _accuracy(system, frames)
    loops = _loop_summary(system, frames, watch["closed"])
    _line("loop_slice", frames=n_frames, **acc, fps_16_95=perf["fps"],
          total_s=total_s,
          host_readbacks_per_frame=perf["readbacks_per_frame"],
          keyframes=system.events.count("keyframe"),
          kf_culled=system.events.count("kf_culled"),
          peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
          **_scenegraph_summary(system), **loops)
    _line("loop_slice_stages", **system.timers.summary())
    _line("loop_slice_launches", path_calls=calls, **{
        k: {"launches": v[0], "twin_calls_on_cuda": v[1]}
        for k, v in counts["loop_slice"].items()})
    _check(acc["tracked"] >= 90, f"loop_slice: tracked {acc['tracked']}")
    _check(loops["n_loops_closed"] >= 1, "loop_slice: no loop closed")
    _check(loops["n_global_ba"] >= 1, "loop_slice: no global BA")
    # the reference itself reads 0.285 m here (PERF.md): a guard against
    # a gross fault, not a fidelity gate
    _check(acc["ate_m"] <= 0.35, f"loop_slice: ATE {acc['ate_m']:.4f} m")
    _check_pyramid_launches("loop_slice", counts["loop_slice"])
    _check(all(v[1] == 0 for v in counts["loop_slice"].values()),
           f"loop_slice: a twin ran on CUDA tensors: {counts['loop_slice']}")
    _check(all(v[0] > 0 for k, v in counts["loop_slice"].items()
               if k != "pnp_hypotheses"
               and k not in INERTIAL_ONLY | FREESPACE_ONLY | PHASE3_ONLY
               | PIPELINE_ONLY | FOLD_ONLY),
           f"loop_slice: a kernel was not launched: {counts['loop_slice']}")
    _check_scan_launches("loop_slice", counts["loop_slice"], calls,
                         pipeline=False)
    _check_ba_launches("loop_slice", counts["loop_slice"], calls, chol)
    _check_track_launches("loop_slice", counts["loop_slice"], callers, calls)
    _check_compact_launches("loop_slice", counts["loop_slice"], calls)
    _check_map_launches("loop_slice", counts["loop_slice"], calls)
    _check_sg_system_launches("loop_slice", counts["loop_slice"], calls)
    _check_place_launches("loop_slice", counts["loop_slice"], calls)
    _check_loop_launches("loop_slice", counts["loop_slice"], calls)
    _check(watch["saved"] is not None, "loop_slice: no map saved at a loop")
    loop_system = system

    # 4g. hidden host syncs of the loop path, across a loop closure
    system = main_path.make_system(loop_cfg, device, True)
    syncs = _drive(system, frames[:80], sync_window=(16, 80))
    _line("loop_sync_debug", frames="16-79",
          loops_closed=system.loop_closer.n_loops_closed,
          n_reloc=system.events.count("reloc"),
          syncs_per_frame=syncs["syncs_per_frame"],
          readbacks_per_frame=syncs["readbacks_per_frame"],
          sync_sites=syncs["sync_sites"])
    _check(system.loop_closer.n_loops_closed >= 1,
           "loop_sync_debug: no loop closed inside the window")
    _check(syncs["syncs_per_frame"] <= syncs["readbacks_per_frame"],
           f"hidden host syncs on the loop path: {syncs}")
    del system

    # 4h. the recovery keyframe (the loop path reaches it when a
    # relocalisation fails): frames 0-29, two blank frames (lost, and no
    # relocalisation without features), frame 29 again (the camera held
    # still, so tracking resumes from the held pose: the recovery keyframe,
    # through the joint scene-graph BA on the LM engine), then frames
    # 30-39, every timestamp three frames later
    system = main_path.make_system(loop_cfg, device, True)
    cuda.reset_counts()
    dt = float(frames[1][4] - frames[0][4])
    blank = lambda f: (torch.zeros_like(f[0]), torch.zeros_like(f[1]),  # noqa
                       f[2], f[3])
    seq = [f[:4] for f in frames[:30]] + [blank(frames[29])] * 2 \
        + [f[:4] for f in frames[29:40]]
    for i, (gray, depth, sem, T_wc) in enumerate(seq):
        main_path.feed(system, (gray, depth, sem, T_wc,
                                float(frames[0][4]) + i * dt))
    system.flush()
    rec = system.events.of_kind("recovery_keyframe")
    tracked = system.tracked_mask()
    twin_calls = {k: v[1] for k, v in cuda.counts().items() if v[1]}
    _line("recovery_keyframe", events=rec, tracked=tracked.astype(
        int).tolist(), recovery_lba=system.timers.summary().get(
            "recovery_lba"), twin_calls_on_cuda=twin_calls)
    _check(len(rec) >= 1 and rec[0]["joint_ba"] and tracked[32],
           "recovery keyframe: not taken at the repeated frame, or not "
           "through the joint BA")
    _check(not twin_calls, "recovery keyframe: a twin ran on CUDA tensors")
    del system

    # 4i. inertial_slice: the inertial row of bench.py:178-219, 128 orbit
    # frames with their IMU samples, fps over frames 48-127
    vi_scene, vi_frames = main_path.inertial_frames(device)
    vi_cfg = main_path.inertial_config(vi_scene)
    vi_gt = np.stack([f[2][4:7] for f in vi_frames])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system = main_path.make_system(vi_cfg, device, False)
    init = {}

    def note_init(i):
        if "frame" not in init and system.imu.initialized:
            init.update(frame=i, n_kf=system.n_kf_host)

    from visual_sgraphs_tpu_torch.inertial import preintegration
    from visual_sgraphs_tpu_torch.optim import graph
    _reset_plain_counts()
    graph.linearize_batch.cuda_calls = 0
    t0 = time.perf_counter()
    with _match_window_callers() as callers, _card_packs() as packs, \
            _inertial_solves() as solves:
        perf = _drive(system, vi_frames, warm=main_path.INERTIAL_WARMUP,
                      feed=main_path.feed_inertial, after=note_init)
    total_s = time.perf_counter() - t0
    counts["inertial_slice"] = cuda.counts()
    calls = _path_calls(system)
    generic_lin = graph.linearize_batch.cuda_calls
    acc = _accuracy(system, vi_frames, vi_gt)
    ev = system.events
    vi = ev.of_kind("vi_solve")
    kfs = ev.of_kind("keyframe") + ev.of_kind("recovery_keyframe")
    _line("inertial_slice", frames=len(vi_frames), **acc,
          fps_48_127=perf["fps"], total_s=total_s,
          host_readbacks_per_frame_48_127=perf["readbacks_per_frame"],
          imu_initialized=system.imu.initialized,
          init_frame=init.get("frame"), init_n_kf=init.get("n_kf"),
          scale=system.imu.scale, keyframes=len(kfs),
          vi_local_ba=sum(bool(k["vi_ba"]) for k in kfs),
          vi_solves=len(vi), vi_solves_accepted=sum(e["accepted"] for e in vi),
          recovery_keyframes=ev.count("recovery_keyframe"),
          peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
          vi_lba_ms_per_keyframe=system.timers.summary().get(
              "vi_lba", {}).get("mean_ms"),
          imu_init_ms_per_attempt=perf["warm_stages"].get(
              "imu_init", {}).get("mean_ms"),
          generic_linearizations_on_card=generic_lin)
    _line("inertial_slice_stages", **system.timers.summary())
    _line("inertial_slice_warmup_stages", **perf["warm_stages"])
    _line("inertial_slice_launches", path_calls=calls, **{
        k: {"launches": v[0], "twin_calls_on_cuda": v[1]}
        for k, v in counts["inertial_slice"].items()})
    _check(system.imu.initialized, "inertial_slice: the IMU never initialised")
    _check(acc["tracked"] >= 0.9 * len(vi_frames),
           f"inertial_slice: tracked {acc['tracked']}/{len(vi_frames)}")
    # the reference's visual-inertial gate (tests/test_inertial.py:269)
    _check(acc["ate_m"] <= 0.08,
           f"inertial_slice: ATE {acc['ate_m']:.4f} m")
    _check(acc["n_kf"] >= 8, f"inertial_slice: n_kf {acc['n_kf']}")
    _check(all(counts["inertial_slice"][k][0] > 0 for k in INERTIAL_PATH),
           f"inertial_slice: a kernel was not launched: "
           f"{counts['inertial_slice']}")
    _check_pyramid_launches("inertial_slice", counts["inertial_slice"])
    _check(all(v[1] == 0 for v in counts["inertial_slice"].values()),
           f"inertial_slice: a twin ran on CUDA tensors: "
           f"{counts['inertial_slice']}")
    _check(generic_lin == 0, f"inertial_slice: {generic_lin} generic "
           "linearisations on the card")
    # K18 once a frame with samples, the prediction made in that launch
    # (no predict_state on the card), no pack a frame: K20 takes the
    # frame window K18 wrote; a keyframe packs its fresh window
    # (``on_keyframe``) and binds the last one (``set_kf_imu``)
    n_pred = preintegration.predict_state.cuda_calls
    _line("inertial_slice_k18", launches=counts["inertial_slice"]["preint"][0],
          frames_with_samples=system.imu.windows,
          predict_state_on_card=n_pred, packs_on_card=dict(packs),
          keyframes=len(kfs))
    _check(counts["inertial_slice"]["preint"][0] == system.imu.windows > 0
           and n_pred == 0
           and set(packs) <= {"on_keyframe", "set_kf_imu"}
           and max(packs.values(), default=0) <= len(kfs) + 1,
           f"inertial_slice: K18 {counts['inertial_slice']['preint'][0]} "
           f"launches for {system.imu.windows} frames with samples, "
           f"{n_pred} predict_state calls and packs {dict(packs)} on the "
           f"card for {len(kfs)} keyframes")
    _check_track_launches("inertial_slice", counts["inertial_slice"],
                          callers, calls)
    _check_scan_launches("inertial_slice", counts["inertial_slice"], calls,
                         pipeline=False)
    _check_compact_launches("inertial_slice", counts["inertial_slice"],
                            calls)
    _check_map_launches("inertial_slice", counts["inertial_slice"], calls)
    # K22b's plan once a solve with inertial rows (its whitening and edge
    # index), the rows once an iteration and the cost once a candidate
    k22b = {k: counts["inertial_slice"][k][0] for k in (
        "lm_inertial_plan", "lm_inertial_assemble", "lm_inertial_cost")}
    _line("inertial_slice_k22b", solves_with_inertial_rows=solves["solves"],
          **k22b)
    _check(k22b["lm_inertial_plan"] == solves["solves"] > 0,
           f"inertial_slice: K22b's plan {k22b['lm_inertial_plan']} "
           f"launches for {solves['solves']} solves with inertial rows")
    del system

    # 4j. hidden host syncs of the inertial path: 16 frames after the IMU
    # initialised, across a keyframe (this run, not timed, also records the
    # inputs of its fourth VI local BA and last generic local BA for K22's
    # checks below; the copies sync nothing)
    lo = max(32, init["frame"] + 1)
    system = main_path.make_system(vi_cfg, device, False)
    with selfcheck.watch_lm_windows(system, which=4) as lm_seen:
        syncs = _drive(system, vi_frames[:lo + 16], warm=lo,
                       sync_window=(lo, lo + 16),
                       feed=main_path.feed_inertial)
    _line("inertial_sync_debug", frames=f"{lo}-{lo + 15}",
          imu_initialized=system.imu.initialized,
          keyframes=syncs["keyframes"], vi_solves=syncs["vi_solves"],
          syncs_per_frame=syncs["syncs_per_frame"],
          readbacks_per_frame=syncs["readbacks_per_frame"],
          sync_sites=syncs["sync_sites"])
    _check(syncs["keyframes"] >= 1 and syncs["vi_solves"] >= 1,
           "inertial_sync_debug: no keyframe or no inertial solve inside")
    _check(syncs["syncs_per_frame"] == syncs["readbacks_per_frame"],
           f"inertial_sync_debug: syncs differ from counted readbacks: "
           f"{syncs}")
    del system
    # K22a / K22b / K22c against their twins on the fourth VI local BA's
    # window (10 slots x 1000 keypoints, <= 4096 points, D = 150), the
    # initialisation problem over that map's keyframes and the last generic
    # local BA's window (11 slots, <= 8192 points, D = 66; tiled to 22
    # slots, and to 44, past K22a's shared pair-sum accumulator)
    report(selfcheck.run_lm(device, selfcheck.lm_windows(lm_seen)))

    # 4k. freespace_slice: the scene-graph cell with free-space rooms
    fs_cfg = main_path.freespace_config(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system = main_path.make_system(fs_cfg, device, True)
    from visual_sgraphs_tpu_torch.scenegraph import freespace as fs_mod
    maint_frames, seen = [], {"launches": 0}

    def note_maint(i):
        # the frames whose keyframe ran a clustering pass (K17b)
        n = fs_mod.freespace_components.launches
        if n > seen["launches"]:
            maint_frames.append(i)
        seen["launches"] = n

    _reset_plain_counts()
    t0 = time.perf_counter()
    with _match_window_callers() as callers, _schur_choleskies() as chol:
        perf = _drive(system, frames, after=note_maint)
    total_s = time.perf_counter() - t0
    counts["freespace_slice"] = cnt = cuda.counts()
    calls = _path_calls(system)
    acc = _accuracy(system, frames)
    mgr = system.scenegraph
    ev = system.events
    fused = [e for e in ev.of_kind("keyframe") if "joint_ba" not in e]
    n_lba = sum(bool(e["lba"]) for e in fused)
    rooms = mgr.rooms()
    fs_sum = dict(free_voxels=int(mgr._free_grid.sum()),
                  rooms_4wall=int((~rooms["is_corridor"]).sum()),
                  corridors=int(rooms["is_corridor"].sum()),
                  room_centers=np.round(rooms["center"], 3).tolist(),
                  maintenance_passes=mgr._kf_count
                  // mgr.maintenance_interval, maint_frames=maint_frames)
    sg_sum = _scenegraph_summary(system)
    _line("freespace_slice", frames=n_frames, **acc, fps_16_95=perf["fps"],
          total_s=total_s,
          host_readbacks_per_frame=perf["readbacks_per_frame"],
          keyframes=len(fused), lba_keyframes=n_lba,
          recovery_keyframes=ev.count("recovery_keyframe"),
          peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20, **fs_sum,
          **sg_sum)
    _line("freespace_slice_stages", **system.timers.summary())
    _line("freespace_slice_launches", path_calls=calls, **{
        k: {"launches": v[0], "twin_calls_on_cuda": v[1]}
        for k, v in cnt.items()})
    _check(acc["tracked"] >= 90, f"freespace_slice: tracked {acc['tracked']}")
    _check(acc["n_kf"] >= 2, f"freespace_slice: n_kf {acc['n_kf']}")
    _check(acc["ate_m"] < 0.05, f"freespace_slice: ATE {acc['ate_m']:.4f} m")
    _check(sg_sum["n_planes"] >= 2 and not sg_sum["sign_duplicates"],
           f"freespace_slice: planes {sg_sum['n_planes']}, sign duplicates "
           f"{sg_sum['sign_duplicates']}")
    _check_pyramid_launches("freespace_slice", cnt)
    _check(all(v[1] == 0 for v in cnt.values()),
           f"freespace_slice: a twin ran on CUDA tensors: {cnt}")
    _check(all(v[0] > 0 for k, v in cnt.items()
               if k not in LOOP_ONLY | INERTIAL_ONLY | WALLS_ONLY
               | PHASE3_ONLY | PIPELINE_ONLY | FOLD_ONLY),
           f"freespace_slice: a kernel was not launched: {cnt}")
    _check_scan_launches("freespace_slice", cnt, calls, pipeline=False)
    _check_ba_launches("freespace_slice", cnt, calls, chol)
    _check_track_launches("freespace_slice", cnt, callers, calls)
    _check_compact_launches("freespace_slice", cnt, calls)
    _check_map_launches("freespace_slice", cnt, calls)
    _check_sg_launches("freespace_slice", cnt, freespace=True)
    _check_sg_system_launches("freespace_slice", cnt, calls)
    _check(cnt["freespace_carve"][0] == len(fused),
           f"freespace_slice: K17a {cnt['freespace_carve'][0]} launches for "
           f"{len(fused)} keyframes")
    # a recovery keyframe advances the maintenance cadence without the
    # free-space hook (the reference's too)
    maint = fs_sum["maintenance_passes"]
    _check(cnt["freespace_components"][0] == maint
           or (ev.count("recovery_keyframe")
               and 1 <= cnt["freespace_components"][0] <= maint),
           f"freespace_slice: K17b {cnt['freespace_components'][0]} "
           f"launches for {maint} maintenance passes")
    _check(cnt["sg_assemble"][0] == fs_cfg.mapping.lba_iters * n_lba,
           f"freespace_slice: K21 {cnt['sg_assemble'][0]} launches for "
           f"{n_lba} scene-graph BAs")
    # K17b on the cell's grid; K21 inside a whole scene-graph BA on the
    # cell's final map, with a seeded room, corridor and door
    report([selfcheck.check_freespace_components(
        device, mgr._free_grid, mgr._free_origin, fs_cfg.scenegraph
        .freespace_voxel)])
    # K23's free-space entry on the cell's final scene graph and the
    # cluster centres of its final grid
    fs_centers, fs_valid = fs_mod.freespace_cluster_centers(
        mgr._free_grid, mgr._free_origin, fs_cfg.scenegraph.freespace_voxel)
    report([selfcheck.check_rooms(
        device, mgr.state, "freespace", fs_centers, fs_valid,
        fs_cfg.scenegraph.room_wall_dist_thresh,
        min_votes=fs_cfg.scenegraph.plane_min_votes)])
    sg_ba = selfcheck.check_sg_ba(
        system.map, selfcheck.seed_rooms_and_doors(mgr.state),
        system.ref_kf_host, system.cam_K, system.cam_bf, fs_cfg.scenegraph)
    _line("sg_ba", **sg_ba)
    _check(sg_ba["ok"], f"K21 inside a whole scene-graph BA: {sg_ba}")
    del system, mgr

    # 4l. hidden host syncs of the free-space path: 16 frames that hold a
    # maintenance pass (the clustering and room upsert)
    later = [i for i in maint_frames if i >= 24]
    _check(bool(later), f"freespace_slice: no maintenance pass after frame "
           f"23: {maint_frames}")
    lo = later[0] - 8
    system = main_path.make_system(fs_cfg, device, True)
    n_maint = []
    syncs = _drive(system, frames[:lo + 16], warm=lo,
                   sync_window=(lo, lo + 16),
                   after=lambda i: n_maint.append(
                       fs_mod.freespace_components.launches))
    in_window = n_maint[lo + 15] - n_maint[lo - 1]
    _line("freespace_sync_debug", frames=f"{lo}-{lo + 15}",
          keyframes=syncs["keyframes"], maintenance_passes=in_window,
          syncs_per_frame=syncs["syncs_per_frame"],
          readbacks_per_frame=syncs["readbacks_per_frame"],
          sync_sites=syncs["sync_sites"])
    _check(in_window >= 1, "freespace_sync_debug: no maintenance pass inside")
    _check(syncs["syncs_per_frame"] == syncs["readbacks_per_frame"],
           f"freespace_sync_debug: syncs differ from counted readbacks: "
           f"{syncs}")
    del system

    # ---- 3 (continued). the loop kernels on the saved map
    saved = watch["saved"]
    m_loop, kf, cand = saved["map"], saved["kf"], saved["cand"]
    cam = torch.from_numpy(loop_cfg.camera.K).to(device)
    li = selfcheck.loop_map_inputs(m_loop, kf, cand, cam)
    _line("loop_map", kf=kf, cand=cand, n_inliers=li["n_inliers"],
          drift=li["drift"])
    report([selfcheck.check_match_nn(device, li["nn"]),
            selfcheck.check_guided(device, li["guided"]),
            selfcheck.check_sim3(device, li["sim3"]),
            *selfcheck.check_pgo(device, li["pgo"])])

    # ---- 5. the card's path against the CPU twins on a small input
    small, small_frames = main_path.frames("cpu", 12, 240, 320, "arc")
    small_cfg, small_sg = main_path.configs(small, 300,
                                            CapacityConfig(32, 4096))
    for tag, c, with_sg in (("small_vs_cpu_twins", small_cfg, False),
                            ("small_sg_vs_cpu_twins", small_sg, True)):
        runs = {}
        for dev in ("cuda", "cpu"):
            s = main_path.make_system(c, dev, with_sg)
            for frame in small_frames:
                main_path.feed(s, frame)
            runs[dev] = (s.positions(), int(s.map.n_kf),
                         int(s.scenegraph.state.n_planes) if with_sg else 0)
        diff = float(np.abs(runs["cuda"][0] - runs["cpu"][0]).max())
        _line(tag, max_pos_diff_m=diff,
              n_kf=[runs["cuda"][1], runs["cpu"][1]],
              n_planes=[runs["cuda"][2], runs["cpu"][2]])
        _check(diff < 0.01 and runs["cuda"][1:] == runs["cpu"][1:],
               f"{tag}: card path disagrees with the CPU twin path")

    # 5 (inertial). 72 small arc frames with their IMU samples, rendered on
    # the CPU, through the inertial path on the card and on the CPU
    vi_small, vi_small_frames = main_path.inertial_frames("cpu", 72, 240,
                                                          320, "arc")
    vi_small_cfg = main_path.inertial_config(vi_small, 300,
                                             CapacityConfig(32, 4096))
    runs = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        s = main_path.make_system(vi_small_cfg, dev, False)
        init_frame = None
        for i, frame in enumerate(vi_small_frames):
            main_path.feed_inertial(s, frame)
            if init_frame is None and s.imu.initialized:
                init_frame = i
        runs[dev] = (s.positions(), int(s.map.n_kf), init_frame)
    diff = float(np.abs(runs["cuda"][0] - runs["cpu"][0]).max())
    _line("small_inertial_vs_cpu_twins", max_pos_diff_m=diff,
          n_kf=[runs["cuda"][1], runs["cpu"][1]],
          init_frame=[runs["cuda"][2], runs["cpu"][2]],
          seconds=time.perf_counter() - t0)
    _check(diff < 0.01 and runs["cuda"][1:] == runs["cpu"][1:]
           and runs["cuda"][2] is not None,
           "small_inertial_vs_cpu_twins: card path disagrees with the CPU "
           "twin path")

    # 5 (free space). 24 small arc frames, rendered on the CPU, through
    # the free-space path on the card and on the CPU, clustering every
    # second keyframe.  The two devices' poses differ in the last bits, so
    # a sample at a voxel boundary may land in the neighbouring voxel: the
    # free-voxel counts agree within 1 %, the rooms in count and centre
    # within 0.05 m.
    fs_small, fs_frames = main_path.frames("cpu", 24, 240, 320, "arc")
    _, fs_small_sg = main_path.configs(fs_small, 300,
                                       CapacityConfig(32, 4096))
    fs_small_cfg = dataclasses.replace(fs_small_sg, scenegraph=dataclasses
                                       .replace(fs_small_sg.scenegraph,
                                                room_method="freespace"))
    runs = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        s = main_path.make_system(fs_small_cfg, dev, True)
        s.scenegraph.maintenance_interval = 2
        for frame in fs_frames:
            main_path.feed(s, frame)
        r = s.scenegraph.rooms()
        runs[dev] = (int(s.scenegraph._free_grid.sum()), r["center"],
                     s.positions(), s.scenegraph._kf_count)
    (nk, ck, pk, mk), (nc, cc, pc, mc) = runs["cuda"], runs["cpu"]
    room_err = (float(np.abs(ck - cc).max()) if len(ck) and len(ck) == len(cc)
                else 0.0)
    _line("small_freespace_vs_cpu_twins", free_voxels=[nk, nc],
          n_rooms=[len(ck), len(cc)], room_center_max_diff_m=room_err,
          max_pos_diff_m=float(np.abs(pk - pc).max()),
          maintenance_passes=[mk // 2, mc // 2],
          seconds=time.perf_counter() - t0)
    _check(nc > 0 and abs(nk - nc) <= 0.01 * nc and len(ck) == len(cc)
           and room_err <= 0.05 and mk // 2 >= 1,
           "small_freespace_vs_cpu_twins: card path disagrees with the CPU "
           "twin path")

    # 5b. the loop correction chain on the saved map, card against CPU
    bf = torch.full((), loop_cfg.camera.bf, dtype=torch.float32)
    t0 = time.perf_counter()
    chain = {}
    for dev in ("cuda", "cpu"):
        m_dev = type(m_loop)(*(t.to(dev) for t in m_loop))
        chain[dev] = _loop_chain(m_dev, kf, cand, cam.to(dev), bf.to(dev),
                                 loop_cfg.place)
    (Sk, nik, ngk, ck), (St, nit, ngt, ct) = chain["cuda"], chain["cpu"]
    s_err = float((Sk - St).abs().max())
    c_err = float(np.abs(ck - ct).max())
    _line("loop_chain_vs_cpu_twins", kf=kf, cand=cand, n_inliers=[nik, nit],
          n_guided=[ngk, ngt], S_max_abs_diff=s_err,
          kf_centre_max_diff_m=c_err, seconds=time.perf_counter() - t0)
    _check(nik == nit and ngk == ngt and s_err <= 1e-4 and c_err <= 1e-3,
           "loop chain: the card disagrees with the CPU twins")

    # 5c. relocalisation of a frame rendered 0.3 m off the path in the
    # loop path's final map, card against CPU (launches K15's PnP half)
    from visual_sgraphs_tpu_torch.core import lie as lie_mod
    from visual_sgraphs_tpu_torch.place.loop_closer import (
        _reloc_attempt, default_draw, reloc_in_map)
    from visual_sgraphs_tpu_torch.slam.frame import make_frame_obs
    lc = loop_system.loop_closer
    T_wc = np.array(scene.trajectory(n_frames, "orbit2")[40])
    T_wc[4] += 0.3
    gray, depth, _ = scene.render(T_wc)
    frame = make_frame_obs(gray, depth, 0.0, loop_cfg.camera, loop_cfg.orb)
    reloc = {}
    for dev in ("cuda", "cpu"):
        to = lambda x: x.to(dev)  # noqa: E731
        m_dev = type(loop_system.map)(*map(to, loop_system.map))
        f_dev = type(frame)(*map(to, frame))
        hit = reloc_in_map(m_dev, type(lc.db)(*map(to, lc.db)),
                           lc.vocab.to(dev), f_dev, to(cam), 30,
                           draw=default_draw)
        _check(hit is not None, f"relocalisation failed on {dev}")
        T, n_inl = _reloc_attempt(
            m_dev, f_dev, hit[1], to(cam),
            lambda v: default_draw("pnp", 0, v))
        reloc[dev] = (hit[1], lie_mod.se3_inverse(hit[0].cpu())[4:7],
                      int(n_inl))
    p_err = float((reloc["cuda"][1] - reloc["cpu"][1]).abs().max())
    truth = float(np.abs(reloc["cuda"][1].numpy() - T_wc[4:7]).max())
    _line("reloc_vs_cpu_twins", cand=[reloc["cuda"][0], reloc["cpu"][0]],
          n_inliers=[reloc["cuda"][2], reloc["cpu"][2]],
          centre_max_diff_m=p_err, centre_vs_render_m=truth)
    _check(reloc["cuda"][0] == reloc["cpu"][0]
           and abs(reloc["cuda"][2] - reloc["cpu"][2]) <= 2
           and p_err <= 1e-3, "relocalisation: card disagrees with CPU")
    # K5's NN ratio as the relocalisation calls it (ratio 0.8, no angles)
    m_r, c_r = loop_system.map, reloc["cuda"][0]
    report([selfcheck.check_match_nn(
        device, (frame.desc, frame.valid, m_r.kf_desc[c_r],
                 m_r.kf_kp_valid[c_r] & (m_r.kf_obs_pt[c_r] >= 0), None,
                 None), ratio=0.8, angles=False,
        name="match_nn_ratio@reloc")])
    pnp_map = selfcheck.check_pnp(device, selfcheck.reloc_inputs(
        loop_system.map, frame, reloc["cuda"][0], cam))
    _line("pnp_real_map", **pnp_map)
    _check(pnp_map["ok"], "K15 PnP disagrees with its twin on the map")

    # ---- 6. result lines
    _check({k[0] for k in cuda.KERNELS} <= set(checks),
           "a kernel has no check")
    kernels = []
    for name, _, _, src, replaces in cuda.kernel_functions():
        r = checks[name]
        path = ("inertial_slice" if name in INERTIAL_ONLY
                else "freespace_slice" if name in FREESPACE_ONLY
                else "bench_slice")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[path][name][0],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms"),
            **{k: r[k] for k in ("device_ms", "library_device_ms")
               if k in r}))
    local_k8 = counts["bench_slice"]["schur_reduce"][0] - bench_watch["gba_k8"]
    ref = "visual_sgraphs_tpu/"
    for name, src, replaces, launches in (
            ("schur_reduce@L128", "schur_reduce",
             ref + "parallel/dist_ba.py:395", bench_watch["gba_k8"]),
            ("schur_backsub@L128", "schur_backsub",
             ref + "parallel/dist_ba.py:395", bench_watch["gba_k8"]),
            ("schur_reduce@window", "schur_reduce",
             ref + "parallel/dist_ba.py:148", local_k8),
            ("schur_backsub@window", "schur_backsub",
             ref + "parallel/dist_ba.py:257", local_k8),
            ("ba_solve@gba", "ba_solve", ref + "parallel/dist_ba.py:294",
             bench_calls["gba_iters"]),
            ("ba_solve@lba", "ba_solve", ref + "optim/fast_ba.py:169",
             counts["slice"]["ba_solve"][0])):
        r = checks[name]
        kernels.append(dict(
            name=name, route="cuda", source=kernels[
                [k["name"] for k in kernels].index(src)]["source"],
            replaces=replaces,
            launches=launches, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            **{k: r[k] for k in ("device_ms", "library_device_ms")
               if k in r}))
    print(_card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
