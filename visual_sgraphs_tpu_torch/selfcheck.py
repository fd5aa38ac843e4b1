"""Kernel-against-twin checks at the slice's shapes, on a CUDA device.

Each check builds seeded inputs of the shapes the main path gives the
kernel (a batch of 8 rendered 480x640 frames' pyramids and level scores;
the map's 32768-point masks; the local and global BAs' observation
lists; a rendered 480x640 frame's 8 pyramid levels and 1000 keypoints;
4096 local-map points against 1000 keypoints; 4096 matches with stereo
rows; the 480x640 depth / class images of two keyframes, their
2048-point clouds, 4 x 192 RANSAC samples and 4 detections; an 8192-landmark,
12-observation, 11-keyframe local BA; the inertial row's 64-row IMU
sample windows and a rendered 480x640 frame's 1000 keypoints against a
16384-point map; a rendered 480x640 frame's depth and a 32^3 free-space
grid; the scene-graph BA's five factor types at D = 402; seeded 64-plane,
16-room scene graphs with four detections), runs the hand kernel and its plain
PyTorch twin on the same device, compares them at the stated tolerance
and times both with CUDA events.  Each result also carries the bytes the
function must move (each input read once, each output written once) and
the operations it does on this run's inputs, from which ``chip_smoke.py``
derives the kernel's bound.  ``chip_smoke.py`` and the GPU tests call
these; nothing here runs on import.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import statistics
from typing import Callable, NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch.config import ImuConfig, OrbConfig
from visual_sgraphs_tpu_torch.core import cameras, lie
from visual_sgraphs_tpu_torch.core import plane as plane_mod
from visual_sgraphs_tpu_torch.features import fast, match, orb
from visual_sgraphs_tpu_torch.parallel import dist_ba
from visual_sgraphs_tpu_torch.place import database, pgo, pnp, sim3_ransac
from visual_sgraphs_tpu_torch.place import vocab as vocab_mod
from visual_sgraphs_tpu_torch.place.loop_closer import default_draw
from visual_sgraphs_tpu_torch.scenegraph import epilogue, plane_fit, pointcloud
from visual_sgraphs_tpu_torch.features import pyramid
from visual_sgraphs_tpu_torch.inertial import pipeline, preintegration
from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
from visual_sgraphs_tpu_torch.slam import map_state, tracking
from visual_sgraphs_tpu_torch.slam.frame import FrameObs, make_frame_obs
from visual_sgraphs_tpu_torch.slam.map_state import MapState

# tolerances (the reasons are in the kernels' sources and the CPU tests)
ANGLE_TOL = 1e-5  # rad, IC angle
POSE_TOL = 1e-4  # per pose component, K6
INLIER_AGREE = 0.99  # fraction of equal inlier flags, K6
CLOUD_TOL = 1e-5  # m, K12 centroids (atomic summation order)
PLANE_TOL = 1e-4  # per coefficient, K13 (sign pinned in both)
ASSIGN_AGREE = 0.999  # fraction of equal point assignments, K13
REL_TOL = 1e-4  # relative, K14 sums, K8 back-substitution, K19's H
BOW_TOL = 1e-6  # relative, K10 rows and K11 scores (summation order)
SIM3_TOL = 1e-4  # per Sim3 / pose component, K15 and K19
# K8's reduction against the float64 twin, relative to each output's
# largest entry: its terms span ~8 orders of magnitude and rhs is a
# difference of large sums, so float32 in any summation order is ~1e-4
# off (the float32 twin's own error is reported beside it)
SCHUR_TOL = 1e-3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _rel(a, b) -> float:
    """max |a - b| / max(max |b|, tiny)."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def device_time(fn: Callable[[], object], reps: int = 20) -> float:
    """Median device milliseconds of one call of ``fn``: CUDA events around
    it while a ~1 ms sleep kernel ahead of it keeps the stream busy, so
    that every launch of ``fn`` is queued before the start event runs and
    the host's time to launch them is not counted (``time_cuda`` counts
    it whenever the device would idle).  Only while the host queues all
    of ``fn`` inside the sleep: a sequence of ~200 small torch ops
    outruns it, and the gaps between its launches are counted; for such
    a sequence ``device_ops``' kernel sum is the device time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _timed(fn: Callable[[], object], **kw) -> dict:
    """``ms`` (``time_cuda``, with ``kw``) and ``device_ms``
    (``device_time``) of ``fn``: the CUDA-event ms of a latency-bound
    kernel is mostly its wrapper's host time."""
    return dict(ms=time_cuda(fn, **kw), device_ms=device_time(fn))


def time_cuda(fn: Callable[[], object], warmup: int = 3,
              reps: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events,
    after ``warmup`` runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def front_inputs(grays: torch.Tensor, n_features: int = 1000):
    """An ORB extraction's levels, budgets, concatenated keypoints (rc)
    and blurred levels for a (B, H, W) batch or an (H, W) frame, from the
    plain twins (so that K2 and K4 are checked alone)."""
    params = orb.OrbParams(n_features=n_features)
    levels = pyramid.build_pyramid_torch(grays, params.n_levels,
                                         params.scale)
    budgets = orb.level_budgets(params)
    kp = orb.detect_levels_torch([fast.fast_nms_torch(lv) for lv in levels],
                                 budgets, params)
    return (levels, budgets, kp.rc,
            [pyramid.gaussian_blur_torch(lv) for lv in levels])


# levels smaller than K4's 41x41 patch, and than FAST's 7x7 ring
TINY_LEVELS = ((3, 5), (6, 6), (7, 7), (9, 12), (30, 36), (40, 52))


def tiny_inputs(device, B: int = 2, per_level: int = 8, seed: int = 0):
    """Seeded random (B, h, w) levels of ``TINY_LEVELS`` (also standing
    for their blurred levels), ``per_level`` keypoints anywhere on each,
    as ``front_inputs`` returns them."""
    rng = np.random.default_rng(seed)
    levels = [torch.from_numpy(rng.uniform(0, 255, (B, h, w)).astype(
        np.float32)).to(device) for h, w in TINY_LEVELS]
    rc = np.concatenate([np.stack([rng.integers(0, h, (B, per_level)),
                                   rng.integers(0, w, (B, per_level))], -1)
                         for h, w in TINY_LEVELS], 1).astype(np.int32)
    return (levels, [per_level] * len(levels),
            torch.from_numpy(rc).to(device), levels)


def batch_frames(device, B: int = 8, h: int = 480, w: int = 640,
                 first: int = 10) -> torch.Tensor:
    """(B, h, w) gray images of consecutive rendered ``orbit2`` frames: the
    batch the pipelined path extracts at once."""
    scene = SyntheticScene(h=h, w=w, device=device)
    traj = scene.trajectory(96, "orbit2")
    return torch.stack([scene.render(traj[first + i])[0] for i in range(B)])


def check_pyramid(grays: torch.Tensor, n_levels: int = 8,
                  scale: float = 1.2) -> list[dict]:
    """K1 over a (B, H, W) batch: the resize chain (one launch a call)
    against the twin (expected bitwise; the gate is 1e-4 abs on [0, 255],
    the twin's tolerance against the reference), also on the first frame
    alone as an (H, W) image, the FAST keypoints per level of the kernel's
    pyramid against the twin's; and the blur of the twin's levels
    (``check_blur``).  Library yardstick: the chain's 7
    ``F.interpolate(bilinear, antialias=True)`` calls (each from the
    twin's level before).  Beside the chain's and the interpolations'
    CUDA-event times their device time (``device_time``); the chain also
    timed with clusters of 8 and of 16 CTAs a frame forced."""
    F_ = torch.nn.functional
    levels = pyramid.build_pyramid_torch(grays, n_levels, scale)
    shapes = [tuple(lv.shape[-2:]) for lv in levels]
    n0 = pyramid.build_pyramid.launches
    k_levels = pyramid.build_pyramid(grays, n_levels, scale)
    one = pyramid.build_pyramid(grays[0], n_levels, scale)
    per_call = (pyramid.build_pyramid.launches - n0) / 2
    r_err = max(max(float((k - t).abs().max()), float((o - t[0]).abs().max()))
                for k, o, t in zip(k_levels[1:], one[1:], levels[1:]))
    kp_diff = [int((fast.fast_nms(k) > 0).ne(fast.fast_nms(t) > 0).sum())
               for k, t in zip(k_levels, levels)]
    torch.cuda.synchronize()

    def chain():
        return pyramid.build_pyramid(grays, n_levels, scale)

    def chain_with(cluster):
        return lambda: pyramid._pyramid_chain(grays, n_levels, scale,
                                              cluster)

    def interpolate():
        return [F_.interpolate(levels[i][:, None], size=shapes[i + 1],
                               mode="bilinear", antialias=True,
                               align_corners=False)
                for i in range(n_levels - 1)]

    B = grays.shape[0]
    px_in = sum(B * a * b for a, b in shapes[:-1])
    px_out = sum(B * a * b for a, b in shapes[1:])
    # per output sample of each pass: T = 3 multiplies and adds
    rows_px = sum(B * shapes[i + 1][0] * shapes[i][1]
                  for i in range(n_levels - 1))
    resize = dict(
        name="pyramid_resize", max_abs_err=r_err,
        ok=r_err <= 1e-4 and per_call == 1, launches_per_call=per_call,
        fast_keypoints_differ_per_level=kp_diff,
        ms=time_cuda(chain), device_ms=device_time(chain),
        **{f"{k}_cluster{c}": v for c in (8, 16) for k, v in (
            ("ms", time_cuda(chain_with(c))),
            ("device_ms", device_time(chain_with(c))))},
        plain_ms=time_cuda(lambda: pyramid.build_pyramid_torch(
            grays, n_levels, scale)),
        library_ms=time_cuda(interpolate),
        library_device_ms=device_time(interpolate),
        shapes=[[B, *sh] for sh in shapes],
        bytes=4 * (px_in + px_out), ops=6 * (rows_px + px_out))
    return [resize, check_blur(levels)]


def check_blur(levels, tag: str = "") -> dict:
    """K1's blur over an extraction's levels (``levels[lv]``: (B, h, w) or
    (h, w)): ``gaussian_blur_levels`` bitwise equal to its twin, one
    launch and one device operation (the nodes of a CUDA graph captured
    from the call) a call, bitwise from launch to launch;
    ``gaussian_blur`` (the kernel with one level's descriptor) bitwise on
    each level.  Library yardstick: a replicate pad and a separable
    ``F.conv2d`` pair a level (TF32 off, as ``chip_smoke.py`` sets it)."""
    F_ = torch.nn.functional
    n0 = pyramid.gaussian_blur_levels.launches
    k = pyramid.gaussian_blur_levels(levels)
    per_call = pyramid.gaussian_blur_levels.launches - n0
    t = pyramid.gaussian_blur_levels_torch(levels)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(k, t))
    bitwise = all(_bits_equal(a, b) for a, b in zip(k, t))
    repro = all(_bits_equal(a, b) for _ in range(3)
                for a, b in zip(k, pyramid.gaussian_blur_levels(levels)))
    one_level = all(_bits_equal(pyramid.gaussian_blur(lv), b)
                    for lv, b in zip(levels, t))
    taps = pyramid._blur_taps_on(7, 2.0, levels[0].device)

    def kernel():
        return pyramid.gaussian_blur_levels(levels)

    def library():
        out = []
        for lv in levels:
            x = F_.pad(lv.reshape(-1, 1, *lv.shape[-2:]), (3, 3, 3, 3),
                       mode="replicate")
            x = F_.conv2d(x, taps.reshape(1, 1, 7, 1))
            out.append(F_.conv2d(x, taps.reshape(1, 1, 1, 7)))
        return out

    n_ops = graph_ops(kernel)
    px = sum(lv.numel() for lv in levels)
    return dict(
        name="gaussian_blur" + tag, max_abs_err=err,
        ok=bitwise and repro and one_level and per_call == 1 and n_ops == 1,
        bitwise=bitwise, bitwise_repro=repro, one_level_equal=one_level,
        launches_per_call=per_call, device_ops=n_ops,
        shapes=[list(lv.shape) for lv in levels],
        ms=time_cuda(kernel), device_ms=device_time(kernel),
        plain_ms=time_cuda(lambda: pyramid.gaussian_blur_levels_torch(
            levels)),
        library_ms=time_cuda(library), library_device_ms=device_time(
            library),
        # each level read once, each blurred pixel written once; 7 products
        # and 6 sums a pass, two passes
        bytes=8 * px, ops=26 * px)


def check_blur_cases(device) -> list[dict]:
    """K1's blur over the levels of one 720x1280 frame and over seeded
    levels smaller than the 7 taps and than a 32 x 64 tile
    (``tiny_inputs``)."""
    params = orb.OrbParams()
    hd = pyramid.build_pyramid_torch(
        batch_frames(device, B=1, h=720, w=1280)[0], params.n_levels,
        params.scale)
    return [check_blur(hd, "@720x1280"),
            check_blur(tiny_inputs(device)[0], "@tiny")]


def tie_scores(scores, step: float = 8.0):
    """A tie-heavy score pyramid: each level's scores rounded down to a
    multiple of ``step``, so that many cells and candidates tie."""
    return [torch.floor(s / step) * step for s in scores]


def check_detect(grays: torch.Tensor, n_features: int = 1000,
                 ties: bool = False, cell_size: int = 32) -> dict:
    """K3 over an extraction's levels (scores from the twins) of a
    (B, H, W) batch or an (H, W) frame (``ties``: the scores quantised by
    ``tie_scores``): all five fields (rc, response, valid, uv, level)
    bitwise equal to the twin's, in one launch (one device operation) a
    call, bitwise from launch to launch; ``detect_level`` (the kernel with
    one level's descriptor) equal to its twin on each level.  Library
    yardstick: ``torch.topk`` of each level's cells (k = 2)."""
    params = orb.OrbParams(n_features=n_features, cell_size=cell_size)
    levels = pyramid.build_pyramid_torch(grays, params.n_levels,
                                         params.scale)
    budgets = orb.level_budgets(params)
    scores = [fast.fast_nms_torch(lv) for lv in levels]
    if ties:
        scores = tie_scores(scores)
    n0 = orb.detect_levels.launches
    k = orb.detect_levels(scores, budgets, params)
    per_call = orb.detect_levels.launches - n0
    t = orb.detect_levels_torch(scores, budgets, params)
    torch.cuda.synchronize()
    fields = {f: _bits_equal(a, b)
              for f, a, b in zip(orb.LevelKeypoints._fields, k, t)}
    err = max(float((k.rc - t.rc).abs().max()),
              float((k.response - t.response).abs().max()),
              float((k.uv - t.uv).abs().max()),
              float((k.level - t.level).abs().max()),
              float((k.valid != t.valid).sum()))
    again = [orb.detect_levels(scores, budgets, params) for _ in range(3)]
    repro = all(_bits_equal(x, y) for o in again for x, y in zip(k, o))
    one_level = all(
        all(_bits_equal(x, y) for x, y in zip(
            orb.detect_level(sc, b, params),
            orb.detect_level_torch(sc, b, params)))
        for sc, b in zip(scores, budgets) if b > 0)
    cs = params.cell_size
    cells = []
    for sc in scores:
        x = sc.reshape(-1, *sc.shape[-2:])
        B, h, w = x.shape
        ncy, ncx = -(-h // cs), -(-w // cs)
        p = torch.nn.functional.pad(x, (0, ncx * cs - w, 0, ncy * cs - h))
        cells.append(p.reshape(B, ncy, cs, ncx, cs).permute(
            0, 1, 3, 2, 4).reshape(B, ncy * ncx, cs * cs).contiguous())
    def kernel():
        return orb.detect_levels(scores, budgets, params)

    n_ops = graph_ops(kernel)

    def library():
        return [torch.topk(c, 2, dim=-1) for c in cells]

    # the function reads each level's h * w scores once (the cells' padding
    # is skipped) and writes rc, response, flag, uv and level per budget
    # slot; the selection needs per pixel two comparisons against its
    # cell's best two, per candidate log2(budget) comparisons into a
    # top-budget heap
    px = sum(sc.numel() for sc in scores)
    n_cand = [2 * c.shape[0] * c.shape[1] for c in cells]
    B = cells[0].shape[0]
    return dict(
        name="detect_level", max_abs_err=err,
        ok=(all(fields.values()) and repro and one_level and per_call == 1
            and n_ops == 1),
        fields_bitwise=fields, bitwise_repro=repro,
        one_level_equal=one_level, launches_per_call=per_call,
        device_ops=n_ops, n_valid=int(k.valid.sum()),
        # levels with fewer candidates than their budget (K3 pads them)
        padded_levels=sum(2 * c.shape[1] < b
                          for c, b in zip(cells, budgets)),
        max_candidates=max(n_cand) // B,
        ms=time_cuda(kernel), device_ms=device_time(kernel),
        plain_ms=time_cuda(lambda: orb.detect_levels_torch(
            scores, budgets, params)),
        library_ms=time_cuda(library), library_device_ms=device_time(
            library),
        bytes=4 * px + B * sum(budgets) * 25,
        ops=2 * px + sum(n * math.ceil(math.log2(b))
                         for n, b in zip(n_cand, budgets)))


def check_detect_cases(device) -> list[dict]:
    """K3 on one frame of the headline configuration (480x640, 1000
    features, as the serial path extracts it), on the batch's tie-heavy
    scores, on one 720x1280 frame (1840 candidates on level 0) and on one
    480x640 frame with 48-pixel cells (wider than a warp)."""
    grays = batch_frames(device)
    one = check_detect(grays[0])
    one["name"] += "@B1"
    tie = check_detect(grays, ties=True)
    tie["name"] += "@ties"
    hd = check_detect(batch_frames(device, B=1, h=720, w=1280)[0])
    hd["name"] += "@720x1280"
    wide = check_detect(grays[0], cell_size=48)
    wide["name"] += "@cell48"
    return [one, tie, hd, wide]


def check_front_end_small(device) -> list[dict]:
    """K1 and K3 at the headline configuration cut to 240x320 and 600
    features (a batch of 8 rendered frames), where K3's deepest levels
    hold fewer candidates than their budget."""
    out = check_pyramid(batch_frames(device, h=240, w=320))
    out.append(check_detect(batch_frames(device, h=240, w=320),
                            n_features=600))
    for r in out:
        r["name"] += "@240x320"
    return out


# K7's main-path shapes on the map's 32768-point masks: the tracking
# table's (8 % True, size 4096), the local BA's (20 %, 8192) and the
# keyframe insertion's free ids (90 %, size 1000: more True entries than
# size)
COMPACT_SHAPES = (("track", 0.08, 4096), ("lba", 0.2, 8192),
                  ("free", 0.9, 1000))


def _repeats_bitwise(fn, reps: int = 4) -> bool:
    """Whether ``reps`` more calls of ``fn`` return its first output."""
    first = fn()
    return all(torch.equal(first, fn()) for _ in range(reps))


def check_compact(device, n: int = 32768, seed: int = 0) -> dict:
    """K7's plain entry on bool masks of the map's point capacity at the
    main path's three shapes (``COMPACT_SHAPES``), on an empty one and on
    one that starts off a 16-byte boundary (its scalar loads): bitwise
    equal to the twin, one device operation
    (``graph_ops``), bitwise from launch to launch.  Timed at the tracking
    table's shape (device ms at all three: ``device_ms_shapes``); library
    yardstick ``torch.nonzero`` (which synchronises)."""
    rng = np.random.default_rng(seed)
    masks = {tag: (torch.from_numpy(rng.uniform(size=n) < p).to(device),
                   size) for tag, p, size in COMPACT_SHAPES}
    cases = list(masks.values()) + [
        (torch.zeros(n, dtype=torch.bool, device=device), 64),
        (masks["lba"][0][1:], 8192)]
    err, same = 0.0, True
    for mk, size in cases:
        k = map_state.compact_true(mk, size)
        t = map_state.compact_true_torch(mk, size)
        same = same and torch.equal(k, t)
        err = max(err, float((k - t).abs().max()))
    mask, size = masks["track"]

    def kernel():
        return map_state.compact_true(mask, size)

    ops = graph_ops(kernel)
    repeat = _repeats_bitwise(kernel)
    return dict(
        name="compact_true", max_abs_err=err, ok=same and ops == 1 and repeat,
        graph_ops=ops, bitwise_repeat=repeat, **_timed(kernel),
        device_ms_shapes={tag: device_time(
            lambda m=m, s=s: map_state.compact_true(m, s))
            for tag, (m, s) in masks.items()},
        plain_ms=time_cuda(lambda: map_state.compact_true_torch(mask, size)),
        library_ms=time_cuda(lambda: torch.nonzero(mask)),
        bytes=n + 8 * size, ops=2 * n)


def observed_inputs(device, K: int = 128, F: int = 1000, N: int = 32768,
                    L: int = 11, seed: int = 0) -> tuple:
    """Seeded operands of K7's observed entry at the tracking table's
    shape: a (K, F) observation table (40 % -1, the rest ids below N), 5 %
    of the keypoints invalid, 15 % of the points invalid, L keyframe ids
    with one repeated, a fifth of them masked.  Returns (map, kf_ids,
    kf_mask)."""
    from visual_sgraphs_tpu_torch.config import CapacityConfig
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, N, (K, F)).astype(np.int32)
    obs[rng.uniform(size=(K, F)) < 0.4] = -1
    ids = rng.choice(K, L - 1, replace=False)
    kf_ids = np.concatenate([ids, ids[:1]]).astype(np.int64)
    kf_mask = rng.uniform(size=L) > 0.2
    kf_mask[0] = True
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    m = map_state.empty_map(CapacityConfig(K, N), OrbConfig(n_features=F),
                            device)._replace(
        kf_obs_pt=t(obs), kf_kp_valid=t(rng.uniform(size=(K, F)) > 0.05),
        pt_valid=t(rng.uniform(size=N) > 0.15))
    return m, t(kf_ids), t(kf_mask)


def observed_map_inputs(system) -> tuple:
    """K7's observed entry's operands on a system's map: the tracking
    table's keyframes at the reference keyframe (``mapping.lba_slots``,
    as ``tracking._local_point_table`` picks them)."""
    from visual_sgraphs_tpu_torch.slam import mapping
    m = system.map
    return (m, *mapping.lba_slots(m, system.ref_kf_host,
                                  system.cfg.mapping.local_window))


def check_compact_observed(device, inputs: tuple | None = None,
                           name: str = "compact_observed") -> dict:
    """K7's observed entry (``map_state.compact_observed``) against its
    twin (``observed_mask`` & ``pt_valid``, then ``compact_true_torch``)
    on ``inputs`` (``observed_inputs`` / ``observed_map_inputs``): int64
    and int32 ids at the tracking table's size (4096) and at 1024 (below
    the seeded count), all bitwise; one device operation (``graph_ops``;
    the twin's beside it), bitwise from launch to launch.  Timed at size
    4096 with int32 ids, as tracking calls it."""
    m, kf_ids, kf_mask = observed_inputs(device) if inputs is None \
        else inputs
    same = True
    err = 0.0
    for size in (1024, 4096):
        for dt in (torch.int64, torch.int32):
            k = map_state.compact_observed(m, kf_ids, kf_mask, size, dt)
            t = map_state.compact_observed_torch(m, kf_ids, kf_mask, size, dt)
            same = same and k.dtype == dt and torch.equal(k, t)
            err = max(err, float((k.long() - t.long()).abs().max()))

    def kernel():
        return map_state.compact_observed(m, kf_ids, kf_mask, 4096,
                                          torch.int32)

    def twin():
        return map_state.compact_observed_torch(m, kf_ids, kf_mask, 4096,
                                                torch.int32)

    ops = graph_ops(kernel)
    repeat = _repeats_bitwise(kernel)
    out = twin()
    # the rows of the unmasked keyframes (each read once), the keyframe
    # ids and mask, pt_valid; the ids written
    rows = len({int(i) for i, ok in zip(kf_ids.tolist(), kf_mask.tolist())
                if ok})
    F = m.kf_obs_pt.shape[1]
    return dict(
        name=name, max_abs_err=err, ok=same and ops == 1 and repeat,
        graph_ops=ops, plain_graph_ops=graph_ops(twin),
        bitwise_repeat=repeat, n_ids=int((out >= 0).sum()),
        L=kf_ids.shape[0], rows=rows, **_timed(kernel),
        plain_ms=time_cuda(twin), plain_device_ms=device_time(twin),
        library_ms=None, bytes=5 * F * rows + 9 * kf_ids.shape[0] + m.N
        + 4 * 4096, ops=F * rows + 2 * m.N)


def fuse_pass_inputs(m, kf_id: int, cam_K) -> tuple:
    """``fuse_observations``' tracking pass operands on map ``m`` at
    keyframe ``kf_id`` (``mapping.fuse_candidates``) with the keyframe's
    even keypoints unassociated first (their points stay in the covisible
    keyframes: on the synthetic scenes every keypoint with depth seeds a
    point, so a keyframe has no free keypoint to match otherwise), in
    ``track_pass_inputs``' layout, without the image gate: (pt_pos,
    pt_desc, ids, T, cam_K, None, keypoints)."""
    from visual_sgraphs_tpu_torch.slam import mapping
    obs = m.kf_obs_pt.clone()
    obs[kf_id, ::2] = -1
    m = m._replace(kf_obs_pt=obs)
    ids, keypoints = mapping.fuse_candidates(m, kf_id)
    return (m.pt_pos, m.pt_desc, ids, m.kf_pose[kf_id], cam_K, None,
            keypoints)


def group_inputs(device, L: int, F: int, n_pt: int, seed: int = 0,
                 overflow: int = 0, p_valid: float = 0.85,
                 out_of_range: tuple = ()):
    """Seeded observation lists of a BA over L keyframes x F keypoints:
    ``p_valid`` of them valid, landmark ids in [0, n_pt) with each
    landmark seen by a few keyframes; ``overflow`` landmarks are seen by
    every keyframe (more than ``max_obs``, so entries are dropped); each id
    of ``out_of_range`` replaces ~2 % of the ids (valid or not)."""
    rng = np.random.default_rng(seed)
    pt = rng.integers(0, n_pt, (L, F)).astype(np.int32)
    if overflow:
        pt[:, :overflow] = np.arange(overflow, dtype=np.int32)
    for bad in out_of_range:
        pt[rng.uniform(size=(L, F)) < 0.02] = bad
    valid = rng.uniform(size=(L, F)) < p_valid
    kf = np.broadcast_to(np.arange(L, dtype=np.int32)[:, None], (L, F))
    uvr = rng.uniform(0, 640, (L * F, 3)).astype(np.float32)
    uvr[rng.uniform(size=L * F) < 0.2, 2] = -1.0
    t = lambda x: torch.from_numpy(np.array(x)).to(device)  # noqa: E731
    return (t(kf.reshape(-1)), t(pt.reshape(-1)), t(uvr),
            t(valid.reshape(-1)))


# K9's cases: name -> (group_inputs arguments, n_pt, max_obs).  "local" and
# "global" are the local / scene-graph BA's and the global BA's shapes
# (optim/fast_ba.py:99, parallel/dist_ba.py::global_ba_sharded);
# "out_of_range" mixes valid ids -1, n_pt, n_pt + 1 and 10^6 into the
# global shape: each is ranked among the entries of its own bucket (n_pt's
# shared with the invalid entries), so n_dropped counts them as the twin
# does; "many_slots" takes max_obs = 20, past the kernel's byte sums that
# cannot overflow (max_obs <= 15), onto its saturating path.
GROUP_CASES = {
    "local": (dict(L=11, F=1000, n_pt=8192, overflow=20), 8192, 12),
    "global": (dict(L=128, F=1000, n_pt=32768, overflow=20), 32768, 8),
    "empty": (dict(L=0, F=1000, n_pt=8192), 8192, 12),
    "all_invalid": (dict(L=11, F=1000, n_pt=8192, p_valid=0.0), 8192, 12),
    "heavy_overflow": (dict(L=128, F=1000, n_pt=512), 32768, 8),
    "out_of_range": (dict(L=128, F=1000, n_pt=32768, overflow=20,
                          out_of_range=(-1, 32768, 32769, 10**6)),
                     32768, 8),
    "many_slots": (dict(L=128, F=1000, n_pt=4096), 8192, 20),
}


def check_group_case(device, name: str) -> dict:
    """K9 on one of ``GROUP_CASES``: kf / valid tables and n_dropped
    exactly equal to the twin's, uvr bitwise, one launch a call."""
    kw, n_pt, O = GROUP_CASES[name]
    args = group_inputs(device, **kw)
    before = dist_ba.group_observations.launches
    k = dist_ba.group_observations(*args, n_pt, O)
    launches = dist_ba.group_observations.launches - before
    t = dist_ba.group_observations_torch(*args, n_pt, O)
    torch.cuda.synchronize()
    err = max(float((k[0] != t[0]).sum()),
              float((k[1].view(torch.int32)
                     != t[1].view(torch.int32)).sum()),
              float((k[2] != t[2]).sum()), float((k[3] - t[3]).abs()))
    return dict(name=f"group_observations@{name}", max_abs_err=err,
                ok=err == 0.0 and launches == 1, launches_per_call=launches,
                n_dropped=[int(k[3]), int(t[3])], m=int(args[0].shape[0]))


def check_group(device) -> dict:
    """K9 on every case of ``GROUP_CASES`` (see ``check_group_case``).
    Timed at the global BA's shape, with its device time (``device_time``);
    library yardstick ``torch.sort(stable=True)`` of the landmark ids (the
    sort half only), also with its device time."""
    cases = [check_group_case(device, name) for name in GROUP_CASES]
    dropped = {r["name"].split("@")[1]: r["n_dropped"] for r in cases}
    kw, n_pt, O = GROUP_CASES["global"]
    args = group_inputs(device, **kw)
    pt = torch.where(args[3], args[1], n_pt)
    m = args[0].shape[0]

    def kernel():
        return dist_ba.group_observations(*args, n_pt, O)

    def library():
        return torch.sort(pt, stable=True)

    return dict(
        name="group_observations",
        max_abs_err=max(r["max_abs_err"] for r in cases),
        ok=(all(r["ok"] for r in cases) and min(dropped["local"]) > 0
            and min(dropped["global"]) > 0),
        n_dropped=dropped,
        launches_per_call=max(r["launches_per_call"] for r in cases),
        failed=[r["name"] for r in cases if not r["ok"]],
        ms=time_cuda(kernel), device_ms=device_time(kernel),
        plain_ms=time_cuda(
            lambda: dist_ba.group_observations_torch(*args, n_pt, O)),
        library_ms=time_cuda(library), library_device_ms=device_time(library),
        bytes=21 * m + n_pt * O * 17,
        # per entry: bucket, match, rank, offset and the scatter (~8)
        ops=8 * m)


def check_fast_nms(levels, tag: str = "") -> dict:
    """K2 over an extraction's levels (``levels[lv]``: (B, h, w) or (h,
    w)): ``fast_levels`` bitwise (by value) equal to its twin, one launch
    and one device operation (the nodes of a CUDA graph captured from the
    call) a call, bitwise from launch to launch; ``fast_nms`` (the kernel
    with one level's descriptor) equal to the twin on each level."""
    n0 = fast.fast_levels.launches
    k = fast.fast_levels(levels)
    per_call = fast.fast_levels.launches - n0
    t = fast.fast_levels_torch(levels)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(k, t))
    repro = all(torch.equal(a, b) for _ in range(3)
                for a, b in zip(k, fast.fast_levels(levels)))
    one_level = all(torch.equal(fast.fast_nms(lv), b)
                    for lv, b in zip(levels, t))

    def kernel():
        return fast.fast_levels(levels)

    n_ops = graph_ops(kernel)
    pixels = sum(lv.numel() for lv in levels)
    return dict(
        name="fast_nms" + tag, max_abs_err=err,
        ok=err == 0.0 and repro and one_level and per_call == 1
        and n_ops == 1, bitwise_repro=repro, one_level_equal=one_level,
        launches_per_call=per_call, device_ops=n_ops,
        shapes=[list(lv.shape) for lv in levels],
        ms=time_cuda(kernel), device_ms=device_time(kernel),
        plain_ms=time_cuda(lambda: fast.fast_levels_torch(levels)),
        # each level read once, each score written once; per pixel (the
        # scores of a 32x32 tile's 34x34 ring, 1.13 a pixel): 2 x 47 arc
        # minima / maxima, 2 subtractions, 2 maxima; the NMS's ~5 maxima
        bytes=2 * 4 * pixels, ops=116 * pixels)


def _patch_pixels(blurred, rc, budgets) -> int:
    """The blurred pixels the keypoints' 41x41 patches cover (their
    union, per level and frame): the bytes K4 must read are 4 a pixel."""
    n, off = 0, 0
    size = 2 * orb.GATHER_RADIUS + 1
    for bl, b in zip(blurred, budgets):
        if b <= 0:
            continue
        x = bl.reshape(-1, *bl.shape[-2:])
        B, h, w = x.shape
        r = rc.reshape(B, -1, 2)[:, off:off + b].long()
        r0 = (r[..., 0] - orb.GATHER_RADIUS).clamp(0, max(h, size) - size)
        c0 = (r[..., 1] - orb.GATHER_RADIUS).clamp(0, max(w, size) - size)
        r1, c1 = (r0 + size).clamp(max=h), (c0 + size).clamp(max=w)
        f = torch.arange(B, device=rc.device)[:, None].expand_as(r0)
        diff = torch.zeros((B, h + 1, w + 1), dtype=torch.int32,
                           device=rc.device)
        one = torch.ones_like(r0, dtype=torch.int32)
        for rr, cc, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1),
                             (r1, c1, 1)):
            diff.index_put_((f, rr, cc), sign * one, accumulate=True)
        n += int((diff.cumsum(1).cumsum(2)[:, :h, :w] > 0).sum())
        off += b
    return n


def check_orb_desc(blurred, rc, budgets, tag: str = "") -> dict:
    """K4 over an extraction's keypoints (``rc`` (B, N, 2) or (N, 2), the
    budgeted levels' rows concatenated; ``blurred[lv]`` the level's
    blurred image): ``orb_describe_levels``' angles within ANGLE_TOL of
    its twin's and its descriptors bitwise equal given the twin's angles,
    one launch and one device operation a call, bitwise from launch to
    launch; ``orb_describe`` (one level's descriptor) on each level's rows
    likewise.  The bytes count the union of the keypoints' patches."""
    pattern = orb.brief_pattern_tensor(42, rc.device)
    n0 = orb.orb_describe_levels.launches
    ka, kd = orb.orb_describe_levels(blurred, rc, budgets, pattern)
    per_call = orb.orb_describe_levels.launches - n0
    ta, td = orb.orb_describe_levels_torch(blurred, rc, budgets, pattern)
    _, kd_t = orb.orb_describe_levels(blurred, rc, budgets, pattern,
                                      angle=ta)
    torch.cuda.synchronize()
    err = float((ka - ta).abs().max())
    bits = int((kd_t != td).sum())
    repro = all(_bits_equal(x, y) for _ in range(3) for x, y in zip(
        (ka, kd), orb.orb_describe_levels(blurred, rc, budgets, pattern)))
    # one level's rows at a time, as views of the extraction's arrays
    la, ld = torch.empty_like(ta), torch.empty_like(td)
    spare_a, spare_d = torch.empty_like(ta), torch.empty_like(td)
    off = 0
    for bl, b in zip(blurred, budgets):
        rows = slice(off, off + b)
        orb.orb_describe(bl, rc[..., rows, :], pattern,
                         out=(la[..., rows], spare_d[..., rows, :]))
        orb.orb_describe(bl, rc[..., rows, :], pattern, angle=ta[..., rows],
                         out=(spare_a[..., rows], ld[..., rows, :]))
        off += b
    torch.cuda.synchronize()
    one_level = (float((la - ta).abs().max()) <= ANGLE_TOL
                 and torch.equal(ld, td))

    def kernel():
        return orb.orb_describe_levels(blurred, rc, budgets, pattern)

    n_ops = graph_ops(kernel)
    n_kp = int(rc.numel() // 2)
    return dict(
        name="orb_desc" + tag, max_abs_err=err,
        ok=(err <= ANGLE_TOL and bits == 0 and repro and one_level
            and per_call == 1 and n_ops == 1),
        desc_bytes_differ=bits, bitwise_repro=repro,
        one_level_equal=one_level, launches_per_call=per_call,
        device_ops=n_ops, n_keypoints=n_kp,
        ms=time_cuda(kernel), device_ms=device_time(kernel),
        plain_ms=time_cuda(lambda: orb.orb_describe_levels_torch(
            blurred, rc, budgets, pattern), warmup=1, reps=5),
        bytes=4 * _patch_pixels(blurred, rc, budgets)
        + nbytes(rc, pattern) + n_kp * (32 + 4),
        # per keypoint: the moments' 2 x 678 multiply-adds, 256 rotated
        # pair tests (~14 operations each)
        ops=5700 * n_kp)


def check_front_k2_k4(device) -> list[dict]:
    """K2 and K4 over an extraction of a batch of 8 rendered 480x640
    frames (1000 features), of its first frame (as the serial path
    extracts it), of 8 frames at 240x320 (600 features), of one 720x1280
    frame, and over seeded levels smaller than the 41x41 patch and than
    FAST's ring (``tiny_inputs``)."""
    grays = batch_frames(device)
    cases = (("", front_inputs(grays)), ("@B1", front_inputs(grays[0])),
             ("@240x320", front_inputs(batch_frames(device, h=240, w=320),
                                       n_features=600)),
             ("@720x1280", front_inputs(batch_frames(
                 device, B=1, h=720, w=1280)[0])),
             ("@tiny", tiny_inputs(device)))
    return ([check_fast_nms(c[0], tag) for tag, c in cases]
            + [check_orb_desc(c[3], c[2], c[1], tag) for tag, c in cases])


def match_inputs(device, n_a: int = 4096, n_b: int = 1000, seed: int = 0):
    """Seeded window-match problem: 1000 targets, 4096 queries of which a
    quarter are perturbed copies (a few flipped bits, jittered pixels) and
    the rest random, with planted ties and duplicate claimants."""
    rng = np.random.default_rng(seed)
    desc_b = rng.integers(0, 256, (n_b, 32), dtype=np.uint8)
    uv_b = rng.uniform((0, 0), (640, 480), (n_b, 2)).astype(np.float32)
    desc_a = rng.integers(0, 256, (n_a, 32), dtype=np.uint8)
    uv_a = rng.uniform((0, 0), (640, 480), (n_a, 2)).astype(np.float32)
    src = rng.integers(0, n_b, n_a // 4)
    flips = (rng.uniform(size=(n_a // 4, 32)) < 0.15) * \
        rng.integers(1, 256, (n_a // 4, 32))
    desc_a[: n_a // 4] = desc_b[src] ^ flips.astype(np.uint8)
    uv_a[: n_a // 4] = uv_b[src] + rng.normal(size=(n_a // 4, 2)) * 4
    desc_b[1], uv_b[1] = desc_b[0], uv_b[0] + 1.0  # tie: lower index wins
    desc_a[:3], uv_a[:3] = desc_b[0], uv_b[0]  # duplicate claimants
    valid_a = rng.uniform(size=n_a) > 0.1
    valid_b = rng.uniform(size=n_b) > 0.05
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return (t(desc_a), t(uv_a), t(valid_a), t(desc_b), t(uv_b), t(valid_b))


def check_match_window(device, radius: float = 15.0) -> dict:
    """K5 at 4096 x 1000: matches and distances exactly equal."""
    args = match_inputs(device)
    km, kd = match.match_window(*args, radius=radius)
    tm, td = match.match_window_torch(*args, radius=radius)
    torch.cuda.synchronize()
    err = float(max((km - tm).abs().max(), (kd - td).abs().max()))

    def kernel():
        return match.match_window(*args, radius=radius)

    plain = time_cuda(lambda: match.match_window_torch(*args, radius=radius))
    # per pair: window test (6), 8 XOR + 8 popcount + 7 adds, best-2 (4)
    return dict(name="match_window", max_abs_err=err, ms=time_cuda(kernel),
                device_ms=device_time(kernel), plain_ms=plain,
                ok=err == 0.0, n_matched=int((km >= 0).sum()),
                bytes=nbytes(*args, km, kd),
                ops=35 * args[0].shape[0] * args[3].shape[0])


# the tracking pass's radii on the main path: the first attempt's coarse
# and fine windows, the retry's 4x and 2x (TrackingConfig); and
# fuse_observations' window
TRACK_RADII = (15.0, 7.0, 60.0, 14.0)
FUSE_RADIUS = 4.0


def track_pass_inputs(device, n: int = 4096, F: int = 1000,
                      n_pts: int = 32768, seed: int = 0) -> tuple:
    """Seeded tracking-pass operands at the main path's shapes: an
    ``n_pts`` map whose first ~0.9 n points fill the local table (-1
    padded), in front of a 640x480 camera (fx = fy = 260) at a seeded
    pose; F keypoints, a third the projections of visible points
    (jittered up to 3 px, a few bits flipped), the rest random, with a
    keypoint duplicated (a tie) and three points on one keypoint
    (duplicate claimants), 5 % invalid, depths for most.  Returns
    (pt_pos, pt_desc, ids, T, cam_K, img_wh, frame)."""
    rng = np.random.default_rng(seed)
    cam = np.array([260.0, 260.0, 320.0, 240.0], np.float32)
    q = rng.normal(size=4) * [1.0, 0.05, 0.05, 0.05] + [4.0, 0, 0, 0]
    T = np.concatenate([q / np.linalg.norm(q), rng.normal(size=3) * 0.2]
                       ).astype(np.float32)
    # points in the camera frame, then into the world
    z = rng.uniform(0.5, 8.0, n_pts)
    pc = np.stack([(rng.uniform(-40, 680, n_pts) - 320) * z / 260,
                   (rng.uniform(-40, 520, n_pts) - 240) * z / 260, z], 1)
    Tt = torch.from_numpy(T).double()
    pt_pos = lie.se3_apply(lie.se3_inverse(Tt), torch.from_numpy(pc)
                           ).float().numpy()
    pt_desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    n_valid = int(0.9 * n)
    ids = np.full(n, -1, np.int32)
    ids[:n_valid] = np.sort(rng.choice(n_pts, n_valid, replace=False))
    uv = rng.uniform((0, 0), (640, 480), (F, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    proj = pc[:, :2] / pc[:, 2:] * 260 + [320, 240]
    seen = ids[:n_valid][(proj[ids[:n_valid], 0] >= 0)
                         & (proj[ids[:n_valid], 0] < 640)
                         & (proj[ids[:n_valid], 1] >= 0)
                         & (proj[ids[:n_valid], 1] < 480)]
    src = rng.choice(seen, F // 3, replace=False)
    uv[:F // 3] = proj[src] + rng.uniform(-3, 3, (F // 3, 2))
    flips = (rng.uniform(size=(F // 3, 32)) < 0.1) * \
        rng.integers(1, 256, (F // 3, 32))
    desc[:F // 3] = pt_desc[src] ^ flips.astype(np.uint8)
    desc[F // 3], uv[F // 3] = desc[0], uv[0] + 0.5  # a tie
    pt_desc[seen[-3:]] = desc[1]  # three claimants of keypoint 1
    pt_pos[seen[-3:]] = pt_pos[src[1]]
    valid = rng.uniform(size=F) > 0.05
    depth = np.where(rng.uniform(size=F) > 0.1,
                     rng.uniform(0.5, 8.0, F), 0.0).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    frame = FrameObs(*([None] * len(FrameObs._fields)))._replace(
        uv=t(uv), depth=t(depth), desc=t(desc), valid=t(valid))
    return (t(pt_pos), t(pt_desc), t(ids), t(T), t(cam), (640, 480), frame)


def track_pass_map_inputs(system, gray, depth, ts) -> tuple:
    """The tracking pass's operands on a system's map: its local table at
    the reference keyframe, the frame (gray, depth, ts) through ORB, at
    the system's last pose."""
    cfg = system.cfg
    frame = make_frame_obs(gray, depth, ts, cfg.camera, cfg.orb)
    ids = tracking._local_point_table(
        system.map, system.ref_kf_host, cfg.mapping.local_window, 4096).ids
    return (system.map.pt_pos, system.map.pt_desc, ids, system.last_pose,
            system.cam_K, (cfg.camera.width, cfg.camera.height), frame)


def _bits_equal(a, b) -> bool:
    """Equal shapes and every element's bits equal (float32 compared as
    its bits, so -0.0 != 0.0 and NaNs of one payload agree)."""
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    return bool((a.contiguous().view(torch.int32)
                 == b.contiguous().view(torch.int32)).all())


TRACK_PASS_FIELDS = ("uv_pred", "vis", "vis_pt", "match", "dist", "ok",
                     "slot", "uv_m", "depth_m", "n_match")


def check_track_pass(device, args: tuple, radius: float,
                     name: str = "track_pass",
                     want_depth: bool = True) -> dict:
    """The tracking pass (``match.track_pass``) against its twin on
    ``args`` (``track_pass_inputs`` / ``track_pass_map_inputs`` /
    ``fuse_pass_inputs``, the last without depths: ``want_depth=False``)
    at ``radius``: every integer and bool output equal, ``uv_pred`` and
    the gathered pixels and depths bitwise; the main path's call (without
    ``full``) bitwise the full call's in the fields it returns."""
    wd = dict(want_depth=want_depth)
    k = match.track_pass(*args[:6], radius, args[6], full=True, **wd)
    hot = match.track_pass(*args[:6], radius, args[6], **wd)
    t = match.track_pass_torch(*args[:6], radius, args[6], **wd)
    torch.cuda.synchronize()
    same = {f: bool(torch.equal(getattr(k, f), getattr(t, f)))
            for f in ("vis", "vis_pt", "match", "dist", "ok", "slot",
                      "n_match")}
    same.update({f: _bits_equal(getattr(k, f), getattr(t, f))
                 for f in ("uv_pred", "uv_m", "depth_m")})
    same["main_path_call"] = all(
        _bits_equal(a, b) if a.is_floating_point() else torch.equal(a, b)
        for a, b in zip(hot, k) if a is not None)
    err = max(float((getattr(k, f).double() - getattr(t, f).double()
                     ).abs().nan_to_num(nan=float("inf")).max())
              if getattr(k, f) is not None and getattr(k, f).numel()
              else 0.0 for f in TRACK_PASS_FIELDS)
    ids, frame = args[2], args[6]
    n, F = ids.shape[0], frame.uv.shape[0]
    # the pairs the window admits: the work this run's data needs (their
    # Hamming distances and best two)
    du = t.uv_pred[:, None, 0] - frame.uv[None, :, 0]
    dv = t.uv_pred[:, None, 1] - frame.uv[None, :, 1]
    pairs = int((((du * du + dv * dv) <= float(np.float32(radius * radius)))
                 & t.vis[:, None] & frame.valid[None, :]).sum())
    # the bytes this run's data needs: a point's row only for a real id,
    # its descriptor only where it is visible, a keypoint's pixel and
    # descriptor only where it is valid, its depth only where matched
    n_ids, n_vis = int((ids >= 0).sum()), int(t.vis.sum())
    n_kp = int(frame.valid.sum())

    def kernel():
        return match.track_pass(*args[:6], radius, args[6], **wd)

    return dict(
        name=name, radius=radius, max_abs_err=err, ok=all(same.values()),
        equal=same, n_visible=int(t.vis.sum()), n_matched=int(t.n_match),
        window_pairs=pairs, ms=time_cuda(kernel),
        device_ms=device_time(kernel),
        plain_ms=time_cuda(lambda: match.track_pass_torch(
            *args[:6], radius, args[6], **wd), reps=5),
        launches_per_call=1,
        # ids, the points' positions and descriptors, pose and camera, the
        # keypoints' flags, pixels, descriptors and matched depths; the
        # timed (main-path) call's outputs vis_pt, ok, slot, uv_m, depth_m
        # (with want_depth), n_match
        bytes=4 * n + 12 * n_ids + 32 * n_vis + 4 * 11 + F + 40 * n_kp
        + (4 * int(t.n_match) + 4 * n if want_depth else 0)
        + n * (4 + 1 + 8 + 8) + 4,
        # a real id's projection and gates (~40); a pair in the window:
        # its test (6), 8 XOR + 8 popcount + 7 adds, best-2 (4)
        ops=40 * n_ids + 33 * pairs, library_ms=None)


def check_track_pass_radii(device, args: tuple | None = None,
                           tag: str = "") -> list[dict]:
    """``check_track_pass`` at the main path's four radii (the first on
    its own name, the others suffixed by radius), on ``args`` or the
    seeded operands."""
    args = track_pass_inputs(device) if args is None else args
    return [check_track_pass(device, args, r, "track_pass" + tag + (
        "" if i == 0 else f"@r{r:g}")) for i, r in enumerate(TRACK_RADII)]


def check_track_pass_seeded(device) -> dict:
    """``check_track_pass`` on the seeded operands at the coarse radius
    (``profile_slice --kernel-times``)."""
    return check_track_pass(device, track_pass_inputs(device), TRACK_RADII[0],
                            "track_pass@seeded")


def pose_inputs(device, n: int = 4096, seed: int = 0):
    """Seeded motion-only problem: 4096 matches, 20% outliers, 90% with
    depth (stereo rows), a perturbed initial pose."""
    rng = np.random.default_rng(seed)
    K = np.array([260.0, 260.0, 319.5, 239.5], np.float32)
    xi = (rng.normal(size=6) * [0.2, 0.1, 0.2, 0.05, 0.1, 0.05])
    T_true = lie.se3_exp(torch.tensor(xi, dtype=torch.float32))
    p_cam = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(1.0, 7.0, n)], -1).astype(np.float32)
    xw = lie.se3_apply(lie.se3_inverse(T_true), torch.from_numpy(p_cam))
    uv = np.stack([K[0] * p_cam[:, 0] / p_cam[:, 2] + K[2],
                   K[1] * p_cam[:, 1] / p_cam[:, 2] + K[3]], -1)
    uv = uv + rng.normal(size=uv.shape) * 0.5
    out = rng.uniform(size=n) < 0.2
    uv[out] += rng.uniform(-40, 40, (int(out.sum()), 2))
    depth = p_cam[:, 2] * (1 + rng.normal(size=n) * 0.005)
    depth[rng.uniform(size=n) < 0.1] = -1.0
    valid = rng.uniform(size=n) > 0.05
    T_init = lie.se3_boxplus(T_true, torch.tensor(
        rng.normal(size=6) * 0.02, dtype=torch.float32))
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32  # noqa
                                  ).to(device)
    return (f(T_init), f(xw), f(uv), torch.from_numpy(valid).to(device),
            f(K), f(depth), torch.full((), 20.8, device=device))


# K6's card cases: matches (a few hundred take one CTA, 4096 a cluster)
POSE_GN_SIZES = (1, 31, 257, 1000, 4096)
PRIOR_WEIGHT = 10.0  # the main path's (inertial_slice)


def pose_gn_case(device, M: int, stereo: bool, prior: bool) -> tuple:
    """(call of the kernel, call of the twin) on ``pose_prior_inputs(M)``:
    12 iterations with the wide first gate, the stereo row if ``stereo``,
    the prior branch at PRIOR_WEIGHT if ``prior``."""
    T0, xw, uv, valid, K, depth, bf, T_prior = pose_prior_inputs(device, M)
    kw = dict(iters=12, gate0=(2.0 * 15.0) ** 2)
    if stereo:
        kw.update(depth=depth, bf=bf)
    if prior:
        return (lambda: tracking.pose_only_gn_prior(
                    T0, xw, uv, valid, K, T_prior, PRIOR_WEIGHT, **kw),
                lambda: tracking.pose_only_gn_prior_torch(
                    T0, xw, uv, valid, K, T_prior, PRIOR_WEIGHT, **kw))
    return (lambda: tracking.pose_only_gn(T0, xw, uv, valid, K, **kw),
            lambda: tracking.pose_only_gn_torch(T0, xw, uv, valid, K, **kw))


def check_pose_gn_case(device, M: int, stereo: bool = True,
                       prior: bool = False) -> dict:
    """K6 (or its prior branch) on M seeded matches: pose within
    POSE_TOL of the twin, inlier flags equal on >= INLIER_AGREE of rows,
    two launches bitwise equal (fixed-order sums), one launch a call."""
    kernel, twin = pose_gn_case(device, M, stereo, prior)
    wrapper = tracking.pose_only_gn_prior if prior else tracking.pose_only_gn
    before = wrapper.launches
    kT, kin = kernel()
    launches = wrapper.launches - before
    kT2, kin2 = kernel()
    tT, tin = twin()
    torch.cuda.synchronize()
    err = float((kT - tT).abs().max())
    agree = float((kin == tin).float().mean()) if M else 1.0
    repro = bool(torch.equal(kT, kT2) and torch.equal(kin, kin2))
    tag = ("stereo" if stereo else "mono") + ("_prior" if prior else "")
    return dict(name=f"pose_gn@{M}_{tag}", max_abs_err=err,
                inlier_agreement=agree, bitwise_repro=repro,
                launches_per_call=launches,
                ok=(err <= POSE_TOL and agree >= INLIER_AGREE and repro
                    and launches == 1))


def pose_gn_sweep(device) -> list[dict]:
    """``check_pose_gn_case`` over POSE_GN_SIZES, mono and stereo, with and
    without the prior."""
    return [check_pose_gn_case(device, M, stereo, prior)
            for M in POSE_GN_SIZES for stereo in (False, True)
            for prior in (False, True)]


def check_pose_gn(device) -> dict:
    """K6 at 4096 matches with stereo rows and the wide first gate: pose
    within POSE_TOL, inlier flags equal on >= INLIER_AGREE of rows; and
    every case of ``pose_gn_sweep``.  Timed with CUDA events and by its
    device time (``device_time``)."""
    T0, xw, uv, valid, K, depth, bf = pose_inputs(device)
    kw = dict(iters=12, gate0=(2.0 * 15.0) ** 2, depth=depth, bf=bf)
    kT, kin = tracking.pose_only_gn(T0, xw, uv, valid, K, **kw)
    tT, tin = tracking.pose_only_gn_torch(T0, xw, uv, valid, K, **kw)
    torch.cuda.synchronize()
    err = float((kT - tT).abs().max())
    agree = float((kin == tin).float().mean())
    sweep = pose_gn_sweep(device)

    def kernel():
        return tracking.pose_only_gn(T0, xw, uv, valid, K, **kw)

    plain = time_cuda(
        lambda: tracking.pose_only_gn_torch(T0, xw, uv, valid, K, **kw))
    # per match and iteration: transform, projection, stereo row,
    # Jacobian, robust weight and the 27 normal-equation sums (~135)
    return dict(name="pose_gn", max_abs_err=err, ms=time_cuda(kernel),
                device_ms=device_time(kernel), plain_ms=plain,
                library_ms=None,
                ok=(err <= POSE_TOL and agree >= INLIER_AGREE
                    and all(r["ok"] for r in sweep)),
                inlier_agreement=agree, n_inliers=int(kin.sum()),
                sweep_max_abs_err=max(r["max_abs_err"] for r in sweep),
                sweep_min_agreement=min(r["inlier_agreement"]
                                        for r in sweep),
                failed=[r["name"] for r in sweep if not r["ok"]],
                bytes=nbytes(T0, xw, uv, valid, K, depth, kT, kin),
                ops=135 * xw.shape[0] * kw["iters"])


def schur_inputs(device, n: int = 8192, O: int = 12, L: int = 11,
                 seed: int = 0):
    """Seeded local-BA problem at the keyframe path's shapes: L keyframe
    poses (T_cw), n points 2-7 m ahead, each seen by 2..L distinct window
    rows (-1 padded to O), 80% with a stereo coordinate, noisy pixels."""
    rng = np.random.default_rng(seed)
    K = np.array([260.0, 260.0, 319.5, 239.5], np.float32)
    bf = 20.8
    xi = rng.normal(size=(L, 6)) * [0.3, 0.1, 0.3, 0.03, 0.1, 0.03]
    T = lie.se3_exp(torch.tensor(xi, dtype=torch.float32))
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(2.0, 7.0, n)], -1).astype(np.float32)
    kf_tab = np.full((n, O), -1, np.int32)
    for i in range(n):
        m = int(rng.integers(2, min(L, O) + 1))
        kf_tab[i, :m] = rng.choice(L, m, replace=False)
    Tk = T[torch.from_numpy(np.maximum(kf_tab, 0)).long()]
    p = lie.se3_apply(Tk, torch.from_numpy(X)[:, None, :]).numpy()
    z = np.maximum(p[..., 2], 1e-3)
    u = K[0] * p[..., 0] / z + K[2] + rng.normal(size=z.shape)
    v = K[1] * p[..., 1] / z + K[3] + rng.normal(size=z.shape)
    ur = np.where(rng.uniform(size=z.shape) < 0.8, u - bf / z, -1.0)
    uvr = np.stack([u, v, ur], -1).astype(np.float32)
    val = (kf_tab >= 0) & (rng.uniform(size=kf_tab.shape) > 0.05)
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.02
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    return (T.to(device), f(X0), f(kf_tab), f(uvr), f(val), f(K),
            torch.full((), bf, dtype=torch.float32, device=device))


def _schur_work(args) -> tuple[int, int]:
    """(bytes, operations) K8's reduction needs on ``args``, counted from
    the data: the observed landmarks' table rows, points and outputs
    (Hinv, bx, W), the poses and S, rhs; per valid observation its terms
    (~620 flops), per ordered pair of a landmark's valid observations a 6x6
    block (216), per observed landmark the 3x3 inverse and factor (~60)."""
    T, X, kf_tab, uvr, val = args[:5]
    n, O = kf_tab.shape
    L = T.shape[0]
    n_obs = val.sum(dim=1).to(torch.float64)
    seen = int((n_obs > 0).sum())
    row = 12 + O * (4 + 12 + 1) + 36 + 12 + O * 72
    nbytes_ = (seen * row + nbytes(T, *args[5:])
               + 4 * (36 * L * L + 6 * L + 1))
    ops = int(620 * float(n_obs.sum()) + 216 * float((n_obs * n_obs).sum())
              + 60 * seen)
    return nbytes_, ops


def _backsub_work(kf_tab, val, L: int, pt_ok) -> tuple[int, int]:
    """(bytes, operations) K8's back-substitution with the points' update
    needs, counted from the data as ``_schur_work`` counts the
    reduction's: the observed landmarks' Hinv, bx, W and kf_tab rows,
    every row's val (to find them), the pose steps, every point, its
    mask and its moved copy; per valid observation W^T dxi (36 flops),
    per observed landmark the 3x3 product (18), per moved point 3 adds."""
    n, O = kf_tab.shape
    n_obs = val.sum(dim=1)
    seen = int((n_obs > 0).sum())
    row = 4 * (9 + 3 + O * 18) + 4 * O
    return (seen * row + n * O + 4 * 6 * L + (12 + 1 + 12) * n,
            36 * int(n_obs.sum()) + 18 * seen + 3 * int(pt_ok.sum()))


def backsub_points(device, X, seed: int = 1):
    """Seeded operands of the back-substitution's points' update for the
    points ``X`` (n, 3): the points and a mask with ~1/8 of them False."""
    rng = np.random.default_rng(seed)
    ok = torch.from_numpy(rng.uniform(size=X.shape[0]) >= 0.125)
    return X.contiguous(), ok.to(device)


def check_schur(device, n: int = 8192, O: int = 12, L: int = 11,
                args=None, name: str = "schur_reduce",
                back: str | None = "f32") -> list[dict]:
    """K8 at n x O x L (the local BA's 8192 x 12 x 11 by default; L > ~52
    takes the kernel's cooperative branch) on ``schur_inputs`` or the
    given operands ``args`` (a real window's tables, with empty rows).
    Reduction: every output within SCHUR_TOL of the float64 twin's,
    relative to the output's largest entry; S and rhs bitwise equal over
    repeated launches, S exactly symmetric; the device operations of a
    call reported (``device_ops``).
    Back-substitution with the points' update (given the reduction's
    factors, seeded pose steps and a seeded point mask with some entries
    False, as the BAs launch it): the masked points bitwise unmoved, and
    with ``back`` "f32" the moved points within REL_TOL of the float32
    twin's; with "f64" (a real window, where single-observation
    landmarks' Hinv amplify the summation order) within SCHUR_TOL of the
    float64 twin's on the same operands, as the reduction is held; both
    relative to the largest point step."""
    if args is None:
        args = schur_inputs(device, n, O, L)
    kw = dict(lam=1e-4, huber=2.45)
    kout = dist_ba.local_reduced_system(*args, **kw)
    tout = dist_ba.local_reduced_system_torch(*args, **kw)
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    t64 = dist_ba.local_reduced_system_torch(*f64, **kw)
    torch.cuda.synchronize()
    names = ("S", "rhs", "Hinv", "bx", "W", "cost")
    errs = {nm: _rel(k.double(), t) for nm, k, t in zip(names, kout, t64)}
    twin_errs = {nm: _rel(k.double(), t)
                 for nm, k, t in zip(names, tout, t64)}
    again = [dist_ba.local_reduced_system(*args, **kw) for _ in range(3)]
    repro = all(torch.equal(x, y) for o in again for x, y in zip(kout, o))
    symmetric = bool(torch.equal(kout[0], kout[0].T))
    prof = device_ops(lambda: dist_ba.local_reduced_system(*args, **kw))
    ms = time_cuda(lambda: dist_ba.local_reduced_system(*args, **kw))
    dev_ms = device_time(lambda: dist_ba.local_reduced_system(*args, **kw))
    plain = time_cuda(lambda: dist_ba.local_reduced_system_torch(*args, **kw))
    T, X, kf_tab, uvr, val = args[:5]
    n, O = kf_tab.shape
    L = T.shape[0]
    work_bytes, ops = _schur_work(args)
    reduce = dict(name=name, max_abs_err=max(errs.values()),
                  rel_errs_vs_f64=errs, twin_rel_errs_vs_f64=twin_errs,
                  n=n, O=O, L=L,
                  observed_landmarks=int(val.any(dim=1).sum()),
                  bitwise_repro=repro, symmetric=symmetric,
                  device_ops=prof["ops"], device_ms=dev_ms,
                  ms=ms, plain_ms=plain,
                  # the profiler's count is reported, not gated: in a long
                  # process it can lose the launches of ctypes kernels
                  ok=max(errs.values()) <= SCHUR_TOL and repro and symmetric,
                  bytes=work_bytes, ops=ops)
    if not back:
        return [reduce]

    Hinv, bx, W = (kout if back == "f64" else tout)[2:5]
    dx6 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(L, 6)).astype(np.float32) * 1e-3).to(device)
    pts, pt_ok = backsub_points(device, X)
    sub = (Hinv, bx, W, kf_tab, val, dx6, pts, pt_ok)
    kd = dist_ba.back_substitute(*sub)
    td = dist_ba.back_substitute_torch(*sub)
    t64 = dist_ba.back_substitute_torch(Hinv.double(), bx.double(),
                                        W.double(), kf_tab, val,
                                        dx6.double(), pts.double(), pt_ok)
    torch.cuda.synchronize()
    p64 = pts.double()
    # the moved points' errors relative to the largest point step
    err_f32 = float((kd.double() - td.double()).abs().max()
                    / (td.double() - p64).abs().max().clamp(min=1e-30))
    err_f64 = float((kd.double() - t64).abs().max()
                    / (t64 - p64).abs().max().clamp(min=1e-30))
    err = err_f64 if back == "f64" else err_f32
    unmoved = bool(torch.equal(kd[~pt_ok], pts[~pt_ok]))
    ms = time_cuda(lambda: dist_ba.back_substitute(*sub))
    plain = time_cuda(lambda: dist_ba.back_substitute_torch(*sub))
    back = dict(name=name.replace("schur_reduce", "schur_backsub"),
                max_abs_err=err, rel_err_vs_f64=err_f64,
                rel_err_vs_f32_twin=err_f32, ms=ms, plain_ms=plain,
                masked_unmoved=unmoved, masked=int((~pt_ok).sum()),
                device_ms=device_time(lambda: dist_ba.back_substitute(*sub)),
                ok=unmoved and int((~pt_ok).sum()) > 0
                and err <= (SCHUR_TOL if back == "f64" else REL_TOL))
    back["bytes"], back["ops"] = _backsub_work(kf_tab, val, L, pt_ok)
    return [reduce, back]


@contextlib.contextmanager
def watch_schur(which: int = 17):
    """Inside the block, record the operands of the ``which``-th call of
    K8's reduction from the windowed BAs (``optim/fast_ba.py``; the last
    one if fewer ran) as copies: (poses, points, kf_tab, uvr_tab, val_tab,
    cam_K, bf).  The copies cost device time: watch a run that is not
    timed."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    out = {"calls": 0}
    orig = fast_ba.local_reduced_system

    def spy(*args, **kw):
        out["calls"] += 1
        if out["calls"] <= which:
            out["operands"] = tuple(t.clone() for t in args[:7])
        return orig(*args, **kw)

    fast_ba.local_reduced_system = spy
    try:
        yield out
    finally:
        fast_ba.local_reduced_system = orig


def keyframe_inputs(device, frame: int, h: int = 480, w: int = 640,
                    seed: int = 0):
    """One rendered ``orbit2`` keyframe at the slice's size: depth, class
    image, T_cw, cam_K and 4 x 192 seeded RANSAC samples."""
    scene = SyntheticScene(h=h, w=w, device=device)
    T_wc = scene.trajectory(96, "orbit2")[frame]
    _, depth, sem = scene.render(T_wc)
    T_cw = lie.se3_inverse(torch.from_numpy(T_wc).to(device))
    gen = torch.Generator().manual_seed(seed)
    hyp = torch.randint(0, 2048, (4, 192, 3), generator=gen).to(
        torch.int32).to(device)
    return depth, sem.to(torch.int32), T_cw, scene.cam_K, hyp


# keyframes whose four RANSAC rounds (with the seed-0 samples) find at
# least three planes, so every round's refit, sign pin and
# extract-and-remove is compared, not just zeroed outputs: frame 21 a room
# corner (floor, two walls, ceiling: four planes), frame 48 one whose first
# round fails and whose three later rounds succeed
SG_FRAMES = (21, 48)
MIN_PLANES = 3


def check_scenegraph(device, frames=SG_FRAMES) -> list[dict]:
    """K12, K13 and K14 on keyframes at 480x640: K12's integer outputs
    and backprojected points exactly equal, centroids within CLOUD_TOL;
    K13's planes within PLANE_TOL (signs pinned in both) and point
    assignments equal on >= ASSIGN_AGREE, with >= MIN_PLANES planes found
    on every frame, one device operation a call and bitwise equal over
    four launches; K14's counts and voxel rows exactly equal, centroids /
    votes / quadrics within REL_TOL.  Each kernel gets the twin's upstream
    outputs, so each is checked alone.  Errors are the worst over
    ``frames``; times, bytes and operations are those of the first."""
    res = {}

    def merge(name, ok, err, timed, **info):
        r = res.setdefault(name, dict(name=name, max_abs_err=0.0, ok=True,
                                      per_frame={}))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ok"] = r["ok"] and ok
        r["per_frame"][frame] = info
        if "ms" not in r:
            r.update(timed())

    for frame in frames:
        depth, sem, T_cw, cam_K, hyp = keyframe_inputs(device, frame)

        dc_args = (depth, sem, None, cam_K, 0.08, 2048)
        k = pointcloud.depth_cloud(*dc_args)
        t = pointcloud.depth_cloud_torch(*dc_args)
        torch.cuda.synchronize()
        exact = all(bool(torch.equal(k[i], t[i])) for i in (0, 1, 2, 3, 5))
        err = float(max((k[4] - t[4]).abs().max(),
                        (k[6] - t[6]).abs().max()))
        M = t[0].shape[0]
        merge("depth_cloud", exact and err <= CLOUD_TOL, err, lambda: dict(
            **_timed(lambda: pointcloud.depth_cloud(*dc_args)),
            plain_ms=time_cuda(lambda: pointcloud.depth_cloud_torch(
                *dc_args)),
            # the function reads only the M strided samples of the depth
            # and class images (4 B each; at 32-byte sectors, with two
            # samples per sector, the images' traffic would be 4x this)
            bytes=M * (depth.element_size() + sem.element_size())
            + nbytes(cam_K, *t),
            # per point: backprojection (5), hash (9), 5 table adds; per
            # table slot: compaction and a 4-way divide (~8)
            ops=19 * M + 8 * 4 * 2048),
            ints_exact=exact, n_voxels=int(t[5].sum()))
        pts, valid, labels, conf, cloud, cvalid, cweight = t

        ep_args = (cloud, cvalid, cweight, hyp, 0.04, 150.0)
        k = plane_fit.extract_planes(*ep_args)
        repro = all(all(torch.equal(a, b) for a, b in zip(
            k, plane_fit.extract_planes(*ep_args))) for _ in range(3))
        n_ops = graph_ops(lambda: plane_fit.extract_planes(*ep_args))
        t = plane_fit.extract_planes_torch(*ep_args)
        torch.cuda.synchronize()
        err = float((k[0] - t[0]).abs().max())
        agree = float((k[2] == t[2]).float().mean())
        same_valid = bool(torch.equal(k[1], t[1]))
        n_planes = int(t[1].sum())
        N, H = cloud.shape[0], hyp.shape[1]
        merge("extract_planes",
              same_valid and err <= PLANE_TOL and agree >= ASSIGN_AGREE
              and n_planes >= MIN_PLANES and repro and n_ops == 1, err,
              lambda: dict(
                  **_timed(lambda: plane_fit.extract_planes(*ep_args)),
                  plain_ms=time_cuda(
                      lambda: plane_fit.extract_planes_torch(*ep_args)),
                  bytes=nbytes(cloud, cvalid, cweight, hyp, *t),
                  # per round: H x N distances (7) and compares / adds
                  # (2), four refit passes over N (~12 each), the 3x3
                  # eigensolve (~2000)
                  ops=hyp.shape[0] * (9 * H * N + 48 * N + 2000)),
              assign_agreement=agree, planes_valid=t[1].tolist(),
              bitwise_repro=repro, device_ops=n_ops)
        coeffs_c = t[0]

        T_wc = lie.se3_inverse(T_cw)
        coeffs_w = plane_mod.transform(T_wc, coeffs_c)
        thr = epilogue.member_threshold(0.04)
        pe_args = (pts, valid, labels, conf, coeffs_c, coeffs_w, T_wc, thr,
                   512)
        k = epilogue.plane_epilogue(*pe_args)
        t = epilogue.plane_epilogue_torch(*pe_args)
        torch.cuda.synchronize()
        exact = (bool(torch.equal(k[0], t[0]))
                 and bool(torch.equal(k[4], t[4])))
        err = max(_rel(k[i], t[i]) for i in (1, 2, 3))
        D = coeffs_c.shape[0]
        merge("plane_epilogue", exact and err <= REL_TOL, err, lambda: dict(
            **_timed(lambda: epilogue.plane_epilogue(*pe_args)),
            plain_ms=time_cuda(
                lambda: epilogue.plane_epilogue_torch(*pe_args)),
            bytes=nbytes(pts, valid, labels, conf, coeffs_c, coeffs_w, T_wc,
                         *t),
            # per point: world transform (27); per point and detection:
            # distance (7), 17 member sums, projection + key + hash (~25)
            ops=27 * M + 49 * M * D),
            ints_exact=exact, npts=t[0].tolist())
    return list(res.values())


# ---------------------------------------------------------------------------
# loop closing and relocalisation (K5's NN ratio, K10, K11, K15, K16, K19)
# ---------------------------------------------------------------------------


def _clustered_descriptors(rng, n: int, n_base: int = 600,
                           flip: float = 0.08):
    """(n, 32) uint8 descriptors: perturbed copies of ``n_base`` random
    prototypes (a few bits flipped), as a scene's features repeat."""
    base = rng.integers(0, 256, (n_base, 32), dtype=np.uint8)
    src = rng.integers(0, n_base, n)
    bits = (rng.uniform(size=(n, 256)) < flip).astype(np.uint8)
    return base[src] ^ np.packbits(bits, axis=1)


def place_inputs(device, R: int = 128, F: int = 1000, seed: int = 0):
    """A vocabulary trained as the loop closer trains it (4000 clustered
    descriptors: L = 3, W = 512) and R keyframes' descriptor sets."""
    rng = np.random.default_rng(seed)
    train = _clustered_descriptors(rng, 4000)
    tree = vocab_mod.fit_vocab(train, branching=8, levels=3, seed=0,
                               device=device)
    desc = _clustered_descriptors(rng, R * F).reshape(R, F, 32)
    valid = rng.uniform(size=(R, F)) > 0.1
    return (tree, torch.from_numpy(desc).to(device),
            torch.from_numpy(valid).to(device))


def check_bow(device, inputs=None) -> dict:
    """K10 at R = 128 (the backfill) x 1000 descriptors: words exactly
    equal to the twin's descent, rows within BOW_TOL relative; times are
    of one keyframe's call (R = 1), the backfill's in ``backfill_ms``."""
    tree, desc, valid = inputs or place_inputs(device)
    kw = torch.empty(valid.shape, dtype=torch.int32, device=desc.device)
    kb = vocab_mod.bow_vectors(tree, desc, valid, words_out=kw)
    tb = vocab_mod.bow_vectors_torch(tree, desc, valid)
    tw = vocab_mod.descend(tree, desc.reshape(-1, 32)).reshape(
        valid.shape)
    torch.cuda.synchronize()
    words_equal = bool(torch.equal(kw, tw))
    err = _rel(kb, tb)
    d1, v1 = desc[:1].contiguous(), valid[:1].contiguous()
    R, F = valid.shape
    L, K, W = len(tree.centers), tree.branching, tree.n_words
    return dict(name="bow_vectors", max_abs_err=err, ok=words_equal
                and err <= BOW_TOL, words_equal=words_equal, n_words=W,
                **_timed(lambda: vocab_mod.bow_vectors(tree, d1, v1)),
                plain_ms=time_cuda(
                    lambda: vocab_mod.bow_vectors_torch(tree, d1, v1)),
                backfill_ms=time_cuda(
                    lambda: vocab_mod.bow_vectors(tree, desc, valid)),
                # one keyframe: its descriptors, the tree, the row; per
                # descriptor and level K x (8 XOR + 8 popcount + 8 adds)
                # and the argmin
                bytes=F * 33 + sum(nbytes(c) for c in tree.centers)
                + nbytes(tree.idf) + 4 * W,
                ops=F * L * K * 25 + 3 * W)


def place_query_inputs(device, seed: int = 1):
    """K11's operands on a (128, 512) database of ``place_inputs``' rows:
    (db, query, exclude, covis, kf_valid, kf, extra); row kf (a slot
    being reused) still holds another keyframe's row, valid."""
    tree, desc, valid = place_inputs(device)
    bows = vocab_mod.bow_vectors_torch(tree, desc, valid)
    rng = np.random.default_rng(seed)
    K = bows.shape[0]
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    db_valid = rng.uniform(size=K) > 0.1
    kf = 40
    db_valid[kf] = True
    db = database.build_db(bows, t(db_valid))
    q = bows[7].clone()
    exclude = rng.uniform(size=K) < 0.3
    exclude[kf] = True
    covis = rng.uniform(size=K) < 0.2
    covis[kf] = False
    kf_valid = rng.uniform(size=K) > 0.05
    kf_valid[kf] = True
    extra = torch.tensor([1234], dtype=torch.int32, device=device)
    return (db, q, t(exclude), t(covis), t(kf_valid), kf, extra)


def _db_copy(db):
    return type(db)(*(t.clone() for t in db))


def check_place_query(device, inputs=None, name: str = "place_query",
                      ratio: float = 0.8, top_n: int = 3) -> dict:
    """K11's two entries on one database: the query (relocalisation's) and
    the keyframe program's insertion entry (validity sync, query,
    insertion, packed vector with the extra scalars), each from a fresh
    copy of the database.  Candidate ids, valid count, extra and the
    database after the insertion exactly equal to the twins', scores
    within BOW_TOL relative; each entry one device operation a call
    (``graph_ops``) and bitwise equal from launch to launch.  Times are
    the insertion entry's (the main path's); ``query_*`` the query's."""
    db, q, exclude, covis, kf_valid, kf, extra = (
        inputs or place_query_inputs(device))
    qargs = (q, exclude, covis, ratio, top_n)
    iargs = (q, exclude, covis, kf_valid, kf, extra, ratio, top_n)
    k = database.place_query(db, *qargs)
    tw = database.place_query_torch(db, *qargs)
    k_db, ki = database.place_query_insert(_db_copy(db), *iargs)
    t_db, ti = database.place_query_insert_torch(_db_copy(db), *iargs)
    again = [database.place_query_insert(_db_copy(db), *iargs)
             for _ in range(2)]
    torch.cuda.synchronize()
    n = 1 + 2 * top_n

    def exact(a, b):  # ids, valid count (and extra)
        return (bool(torch.equal(a[1:1 + top_n], b[1:1 + top_n]))
                and bool(torch.equal(a[n:], b[n:])))

    def scores(x):
        return torch.cat([x[:1], x[1 + top_n:n]])

    ids_equal = exact(k, tw) and exact(ki, ti)
    db_equal = all(bool(torch.equal(x, y)) for x, y in zip(k_db, t_db))
    repro = all(bool(torch.equal(ki, p)) and all(
        bool(torch.equal(x, y)) for x, y in zip(k_db, d))
        for d, p in again) and bool(torch.equal(
            k, database.place_query(db, *qargs)))
    err = max(_rel(scores(k), scores(tw)), _rel(scores(ki), scores(ti)))
    work = _db_copy(db)
    ops = graph_ops(lambda: database.place_query_insert(work, *iargs))
    q_ops = graph_ops(lambda: database.place_query(db, *qargs))
    K, W = db.bow.shape
    return dict(name=name, max_abs_err=err,
                ok=ids_equal and db_equal and repro and err <= BOW_TOL
                and ops == 1 and q_ops == 1,
                ids_equal=ids_equal, db_equal=db_equal, bitwise_repro=repro,
                device_ops=ops, query_device_ops=q_ops, K=K, W=W, kf=kf,
                packed=ki.tolist(),
                **_timed(lambda: database.place_query_insert(work, *iargs)),
                query_ms=time_cuda(lambda: database.place_query(db, *qargs)),
                query_device_ms=device_time(
                    lambda: database.place_query(db, *qargs)),
                plain_ms=time_cuda(lambda: database.place_query_insert_torch(
                    _db_copy(db), *iargs)),
                # the rows and occupancy read once, the query, the masks;
                # row kf and its occupancy written, the valid bits
                bytes=K * W * 5 + 4 * W + 4 * K + 5 * W + K
                + 4 * (2 * top_n + 3),
                # per row and word: min, add, compare, add; per row the
                # gates and the top-n rounds
                ops=4 * K * W + (20 + 2 * top_n) * K)


def place_cases(K: int = 32, W: int = 64, seed: int = 3) -> list[dict]:
    """Seeded numpy cases of K11's insertion entry (the CPU tests hold the
    twin against the reference's steps on them; the card tests the kernel
    against the twin): ties at the top score (the lower index first),
    every row excluded (no candidate), top_n 1 and 8, a reused slot whose
    row still holds an old keyframe's BoW and valid bit, covisible rows at
    the top score, and a width that is not a multiple of 4 (the kernel's
    scalar loads)."""
    rng = np.random.default_rng(seed)

    def base(w=W):
        bows = rng.uniform(size=(K, w)) * (rng.uniform(size=(K, w)) < 0.3)
        bows = (bows / np.maximum(bows.sum(1, keepdims=True), 1e-12)
                ).astype(np.float32)
        q = (bows[5] * rng.uniform(0.5, 1.5, w)).astype(np.float32)
        q = (q / q.sum()).astype(np.float32)
        return dict(bows=bows, db_valid=rng.uniform(size=K) > 0.2, q=q,
                    exclude=rng.uniform(size=K) < 0.25,
                    covis=rng.uniform(size=K) < 0.3,
                    kf_valid=rng.uniform(size=K) > 0.1, kf=11, top_n=3,
                    ratio=0.8, extra=np.array([7], np.int32))

    def finish(c, name):
        # the program's own masks: kf excluded from its own query (its
        # recency), not covisible with itself, a valid keyframe
        c["exclude"][c["kf"]] = True
        c["covis"][c["kf"]] = False
        c["kf_valid"][c["kf"]] = True
        c["name"] = name
        return c

    cases = []
    c = base()
    for r in (3, 9, 20, 26):  # the same row four times: equal scores
        c["bows"][r] = c["bows"][5]
        c["db_valid"][r] = c["kf_valid"][r] = True
        c["exclude"][r] = c["covis"][r] = False
    c["exclude"][5] = True
    cases.append(finish(c, "ties"))
    c = base()
    c["exclude"][:] = True
    cases.append(finish(c, "all_excluded"))
    for n in (1, 8):
        c = base()
        c["top_n"] = n
        c["ratio"] = 0.5
        cases.append(finish(c, f"top{n}"))
    c = base()
    c["db_valid"][c["kf"]] = True  # the old keyframe's row, still valid
    c["bows"][c["kf"]] = c["bows"][5]  # ... that would score at the top
    c["extra"] = np.array([3, -2], np.int32)
    cases.append(finish(c, "reused_slot"))
    c = base()
    for r in (5, 6):
        c["bows"][r] = c["q"]
        c["db_valid"][r] = c["kf_valid"][r] = True
        c["covis"][r] = c["exclude"][r] = True
    c["extra"] = None
    cases.append(finish(c, "covis_top"))
    c = base(W - 3)
    cases.append(finish(c, "odd_width"))
    return cases


def place_case_operands(c: dict, device):
    """A ``place_cases`` entry as the insertion entry's operands: (db,
    query, exclude, covis, kf_valid, kf, extra)."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    db = database.build_db(t(c["bows"]), t(c["db_valid"]))
    return (db, t(c["q"]), t(c["exclude"]), t(c["covis"]), t(c["kf_valid"]),
            c["kf"], None if c["extra"] is None else t(c["extra"]))


def run_place_cases(device) -> list[dict]:
    """K11's two entries on every ``place_cases`` case."""
    return [check_place_query(device, place_case_operands(c, device),
                              name=f"place_query@{c['name']}",
                              ratio=c["ratio"], top_n=c["top_n"])
            for c in place_cases()]


@contextlib.contextmanager
def watch_place(which: int = 8):
    """Inside the block, record the operands of the ``which``-th place
    query of the keyframe program (K11's insertion entry; the last one if
    fewer ran) as copies: (db, query, exclude, covis, kf_valid, kf, extra,
    min_common_ratio, top_n), the database as it was before the call."""
    out = {"calls": 0}
    orig = database.place_query_insert

    def spy(db, q, exclude, covis, kf_valid, kf, extra=None,
            min_common_ratio=0.8, top_n=3):
        out["calls"] += 1
        if out["calls"] <= which:
            out["operands"] = (_db_copy(db), q.clone(), exclude.clone(),
                               covis.clone(), kf_valid.clone(), kf,
                               None if extra is None else extra.clone(),
                               min_common_ratio, top_n)
        return orig(db, q, exclude, covis, kf_valid, kf, extra,
                    min_common_ratio, top_n)

    database.place_query_insert = spy
    try:
        yield out
    finally:
        database.place_query_insert = orig


@contextlib.contextmanager
def watch_nn(which: int = 1):
    """Inside the block, record the operands of the ``which``-th NN-ratio
    match of the loop closer (a loop verification's or a relocalisation
    attempt's; the last one if fewer ran) as copies: (desc_a, valid_a,
    desc_b, valid_b, angle_a, angle_b) and the call's ratio, max_dist,
    whether it had angles and mutual."""
    from visual_sgraphs_tpu_torch.place import loop_closer
    out = {"calls": 0}
    orig = loop_closer.match_nn_ratio

    def spy(desc_a, valid_a, desc_b, valid_b, ratio=0.75,
            max_dist=match.TH_LOW, angle_a=None, angle_b=None, mutual=True):
        out["calls"] += 1
        if out["calls"] <= which:
            angles = angle_a is not None and angle_b is not None
            out["operands"] = tuple(
                None if x is None else x.clone()
                for x in (desc_a, valid_a, desc_b, valid_b, angle_a,
                          angle_b))
            out["kw"] = dict(ratio=ratio, max_dist=max_dist, angles=angles,
                             mutual=mutual)
        return orig(desc_a, valid_a, desc_b, valid_b, ratio, max_dist,
                    angle_a, angle_b, mutual)

    loop_closer.match_nn_ratio = spy
    try:
        yield out
    finally:
        loop_closer.match_nn_ratio = orig


def nn_inputs(device, n: int = 1000, seed: int = 0, n_b: int | None = None):
    """Two keyframes' descriptor sets (a third of b's rows are perturbed
    copies of a's, with a common rotation), validity and angles."""
    rng = np.random.default_rng(seed)
    n_b = n if n_b is None else n_b
    desc_a = _clustered_descriptors(rng, n, n_base=n)
    desc_b = _clustered_descriptors(rng, n_b, n_base=n_b)
    m = min(n, n_b) // 3
    src = rng.permutation(n)[:m]
    bits = (rng.uniform(size=(m, 256)) < 0.05).astype(np.uint8)
    desc_b[:m] = desc_a[src] ^ np.packbits(bits, axis=1)
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, n_b).astype(np.float32)
    ang_b[:m] = (ang_a[src] + 0.3
                 + rng.normal(size=m) * 0.05).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return (t(desc_a), t(rng.uniform(size=n) > 0.1), t(desc_b),
            t(rng.uniform(size=n_b) > 0.1), t(ang_a), t(ang_b))


def check_match_nn(device, inputs=None, ratio: float = 0.85,
                   angles: bool = True, mutual: bool = True,
                   max_dist: int = match.TH_LOW,
                   name: str = "match_nn_ratio") -> dict:
    """K5's NN-ratio entry (by default the loop verification's: ratio
    0.85, angles, mutual) on 1000 x 1000 seeded descriptors or ``inputs``
    (desc_a, valid_a, desc_b, valid_b, angle_a, angle_b): matches and
    distances exactly equal to the twin's, one device operation a call
    (``graph_ops``), bitwise equal from launch to launch."""
    da, va, db_, vb, aa, ab = inputs or nn_inputs(device)
    kw = dict(ratio=ratio, max_dist=max_dist, mutual=mutual)
    if angles:
        kw.update(angle_a=aa, angle_b=ab)
    km, kd = match.match_nn_ratio(da, va, db_, vb, **kw)
    tm, td = match.match_nn_ratio_torch(da, va, db_, vb, **kw)
    again = [match.match_nn_ratio(da, va, db_, vb, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    err = float(max((km - tm).abs().max(), (kd - td).abs().max()))
    repro = all(bool(torch.equal(km, m_)) and bool(torch.equal(kd, d_))
                for m_, d_ in again)
    ops = graph_ops(lambda: match.match_nn_ratio(da, va, db_, vb, **kw))
    n_pairs = int(va.sum()) * int(vb.sum())
    return dict(name=name, max_abs_err=err,
                ok=err == 0.0 and repro and ops == 1, bitwise_repro=repro,
                device_ops=ops, n_a=int(da.shape[0]), n_b=int(db_.shape[0]),
                n_matched=int((km >= 0).sum()), ratio=ratio, angles=angles,
                mutual=mutual,
                **_timed(lambda: match.match_nn_ratio(da, va, db_, vb,
                                                          **kw)),
                plain_ms=time_cuda(lambda: match.match_nn_ratio_torch(
                    da, va, db_, vb, **kw)),
                bytes=nbytes(da, va, db_, vb, *((aa, ab) if angles else ()),
                             km, kd),
                # per pair of valid rows, once: the distance (8 XOR + 8
                # popcount + 7 adds), the row's best-2 update (4) and the
                # column's argmin update (2)
                ops=29 * n_pairs)


def nn_cases(n: int = 200, seed: int = 5) -> list[dict]:
    """Seeded numpy cases of K5's NN ratio (the CPU tests hold the twin
    against the reference, the card tests the kernel against the twin): a
    best tied at two columns, one target (n_b = 1), every row of a
    invalid, n_a != n_b, no mutual check, no angles, and angle differences
    of exactly 0 and just below 2 pi."""
    rng = np.random.default_rng(seed)

    def case(name, n_a=n, n_b=n, **kw):
        da = _clustered_descriptors(rng, n_a, n_base=max(n_a // 2, 1),
                                    flip=0.03)
        db_ = _clustered_descriptors(rng, n_b, n_base=max(n_b // 2, 1),
                                     flip=0.03)
        m = min(n_a, n_b) // 2
        db_[:m] = da[:m] ^ np.packbits(
            (rng.uniform(size=(m, 256)) < 0.04).astype(np.uint8), axis=1)
        c = dict(name=name, desc_a=da, valid_a=rng.uniform(size=n_a) > 0.1,
                 desc_b=db_, valid_b=rng.uniform(size=n_b) > 0.1,
                 angle_a=rng.uniform(0, 2 * np.pi, n_a).astype(np.float32),
                 angle_b=rng.uniform(0, 2 * np.pi, n_b).astype(np.float32),
                 ratio=0.85, mutual=True, angles=True)
        c["angle_b"][:m] = (c["angle_a"][:m] + 0.5).astype(np.float32)
        c.update(kw)
        return c

    cases = []
    c = case("tie")
    c["desc_b"][7] = c["desc_b"][3] = c["desc_a"][2]  # the best at two
    c["valid_a"][2] = c["valid_b"][3] = c["valid_b"][7] = True
    c["ratio"] = 1.0  # a tied best passes the ratio test only at 1
    cases.append(c)
    cases.append(case("nb1", n_b=1))
    c = case("all_a_invalid")
    c["valid_a"][:] = False
    cases.append(c)
    cases.append(case("na_ne_nb", n_b=n + 77))
    cases.append(case("no_mutual", mutual=False))
    cases.append(case("no_angles", angles=False, ratio=0.8))
    c = case("angle_wrap")
    # the first half's differences exactly 0, every other one the largest
    # float32 below 2 pi: the two bins at the wrap
    m = n // 2
    below = np.nextafter(np.float32(2 * np.pi), np.float32(0))
    c["angle_a"][:m] = np.float32(0.25)
    c["angle_b"][:m] = np.float32(0.25)
    c["angle_a"][:m:2] = below
    c["angle_b"][:m:2] = np.float32(0.0)
    cases.append(c)
    return cases


def nn_case_operands(c: dict, device):
    """An ``nn_cases`` entry as (desc_a, valid_a, desc_b, valid_b,
    angle_a, angle_b) tensors."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    return tuple(t(c[k]) for k in ("desc_a", "valid_a", "desc_b", "valid_b",
                                   "angle_a", "angle_b"))


def run_nn_cases(device) -> list[dict]:
    """K5's NN ratio on every ``nn_cases`` case."""
    return [check_match_nn(device, nn_case_operands(c, device),
                           ratio=c["ratio"], angles=c["angles"],
                           mutual=c["mutual"],
                           name=f"match_nn_ratio@{c['name']}")
            for c in nn_cases()]


GUIDED_KEYS = ("S", "p_a", "obs_a", "kp_valid_a", "pt_valid", "desc_a",
               "uv_b", "kp_valid_b", "desc_b", "cam")


def _quat(rng, angle: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _sim3_np(S: np.ndarray, p: np.ndarray) -> np.ndarray:
    """lie.sim3_apply in float64 numpy, S = (q (w, x, y, z), t, s)."""
    q0, qv = S[0], S[1:4]
    u = 2.0 * np.cross(qv, p)
    return S[7] * (p + q0 * u + np.cross(qv, u)) + S[4:7]


def _sim3_inv_np(S: np.ndarray, p: np.ndarray) -> np.ndarray:
    q_inv = np.concatenate([S[:1], -S[1:4]])
    return _sim3_np(np.concatenate([q_inv, np.zeros(3), [1.0]]),
                    (p - S[4:7]) / S[7])


def guided_case(rng, name: str, n_a: int = 1000, n_b: int = 1000,
                scale: float = 1.0) -> dict:
    """One K16 case as numpy (``GUIDED_KEYS``): the refined Sim3 S (8,),
    ``cur``'s points in its camera frame (their images under S in front of
    ``cand``'s 640x480 camera), point ids (10 % -1) and validity, half of
    ``cand``'s keypoints within ~4 px of an image of a point of ``cur``
    with its descriptor ~51 bits off, the rest anywhere; 90 % valid."""
    cam = np.array([260.0, 260.0, 319.5, 239.5])
    S = np.concatenate([_quat(rng, 0.2), rng.normal(size=3) * 0.2, [scale]])
    p_cam = np.stack([rng.uniform(-2.0, 2.0, n_a),
                      rng.uniform(-1.5, 1.5, n_a),
                      rng.uniform(1.5, 6.0, n_a)], -1)
    p_a = _sim3_inv_np(S, p_cam)
    uv_a = cam[:2] * p_cam[:, :2] / p_cam[:, 2:] + cam[2:]
    uv_b = rng.uniform((0, 0), (640, 480), (n_b, 2))
    m = n_b // 2
    src = rng.integers(0, n_a, m)
    uv_b[:m] = uv_a[src] + rng.normal(size=(m, 2)) * 4.0
    desc_a = _clustered_descriptors(rng, n_a, n_base=n_a)
    desc_b = _clustered_descriptors(rng, n_b, n_base=n_b)
    desc_b[:m] = desc_a[src] ^ np.packbits(
        (rng.uniform(size=(m, 256)) < 0.2).astype(np.uint8), axis=1)
    n_pts = 4 * n_a
    obs = rng.permutation(n_pts)[:n_a].astype(np.int32)
    obs[rng.uniform(size=n_a) < 0.1] = -1
    return dict(name=name, S=S.astype(np.float32),
                p_a=p_a.astype(np.float32), obs_a=obs,
                kp_valid_a=rng.uniform(size=n_a) > 0.1,
                pt_valid=rng.uniform(size=n_pts) > 0.1, desc_a=desc_a,
                uv_b=uv_b.astype(np.float32),
                kp_valid_b=rng.uniform(size=n_b) > 0.1, desc_b=desc_b,
                cam=cam.astype(np.float32), src=src)


def guided_cases(n: int = 200, seed: int = 11) -> list[dict]:
    """Seeded numpy cases of K16 (the CPU tests hold the twin against the
    reference, the card tests the kernel against the twin): points moved
    behind the camera or to z <= 0.05 whose images still land on keypoints
    (the in-front gate decides), no valid keypoint of ``cand``, pairs at
    exactly 64 and 65 bits inside the window, one keypoint of ``cand``,
    and a scaled Sim3 with n_a != n_b."""
    rng = np.random.default_rng(seed)
    cases = []
    c = guided_case(rng, "behind", n, n)
    S = c["S"].astype(np.float64)
    p_cam = _sim3_np(S, c["p_a"].astype(np.float64))
    # the first quarter mirrored through the camera centre (the same
    # image, z < 0), the next eighth moved along their rays to z = 0.04
    # (gated) or 0.0625 (not): the same images
    q, e = n // 4, n // 8
    p_cam[:q] = -p_cam[:q]
    z = np.where(np.arange(e) % 2 == 0, 0.04, 0.0625)
    p_cam[q:q + e] *= (z / p_cam[q:q + e, 2])[:, None]
    c["p_a"] = _sim3_inv_np(S, p_cam).astype(np.float32)
    cases.append(c)
    c = guided_case(rng, "no_valid_b", n, n)
    c["kp_valid_b"][:] = False
    cases.append(c)
    c = guided_case(rng, "hamming_64", n, n)
    # every matched keypoint 1 px from its point's image, its descriptor
    # exactly 64 (even rows) or 65 bits off
    S = c["S"].astype(np.float64)
    p_cam = _sim3_np(S, c["p_a"].astype(np.float64))
    uv = c["cam"][:2] * p_cam[:, :2] / p_cam[:, 2:] + c["cam"][2:]
    m = n // 2
    for j, i in enumerate(c["src"]):
        c["uv_b"][j] = (uv[i] + [1.0, 0.0]).astype(np.float32)
        bits = np.zeros(256, np.uint8)
        bits[rng.permutation(256)[:64 + (j % 2)]] = 1
        c["desc_b"][j] = c["desc_a"][i] ^ np.packbits(bits)
    c["uv_b"][m:] = rng.uniform((0, 0), (640, 480), (n - m, 2))
    cases.append(c)
    c = guided_case(rng, "one_b", n, 1)
    S = c["S"].astype(np.float64)
    i = int(np.flatnonzero(c["kp_valid_a"] & (c["obs_a"] >= 0))[0])
    c["pt_valid"][c["obs_a"][i]] = True
    p = _sim3_np(S, c["p_a"][i].astype(np.float64))
    c["uv_b"][0] = (c["cam"][:2] * p[:2] / p[2] + c["cam"][2:]).astype(
        np.float32)
    c["desc_b"][0] = c["desc_a"][i]
    c["kp_valid_b"][0] = True
    cases.append(c)
    cases.append(guided_case(rng, "scaled", n, n + 37, scale=1.3))
    return cases


def guided_operands(c: dict, device) -> tuple:
    """A ``guided_case`` as the K16 entry's operands (S_ab, p_a, obs_a,
    kp_valid_a, pt_valid, desc_a, uv_b, kp_valid_b, desc_b, cam_K)."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    return tuple(t(c[k]) for k in GUIDED_KEYS)


def guided_inputs(device, n: int = 1000, seed: int = 0) -> tuple:
    """K16's operands at the loop verification's shape (1000 x 1000)."""
    return guided_operands(guided_case(np.random.default_rng(seed),
                                       "seeded", n, n), device)


def _guided_pairs(args) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows that pass the validity and in-front gates, (n_a, n_b) pairs
    inside the window among them and the valid keypoints), by the twin's
    steps."""
    S, p_a, obs_a, kva, ptv, _, uv_b, kvb, _, cam = args
    pt = torch.clamp(obs_a, min=0).long()
    p_cam = lie.sim3_apply(S, p_a)
    rows = kva & (obs_a >= 0) & ptv[pt] & (p_cam[:, 2] > 0.05)
    uv = cameras.project_pinhole(cam, p_cam)
    d2 = torch.sum((uv[:, None, :] - uv_b[None, :, :]) ** 2, dim=-1)
    return rows, (d2 < 64.0) & rows[:, None] & kvb[None, :]


def check_guided(device, inputs=None, name: str = "guided_count") -> dict:
    """K16 (``guided_count_sim3``, 1000 x 1000 seeded or ``inputs``): the
    count exactly the twin's, one device operation a call (``graph_ops``),
    bitwise equal from launch to launch."""
    args = inputs or guided_inputs(device)
    k = match.guided_count_sim3(*args)
    tw = match.guided_count_sim3_torch(*args)
    again = [match.guided_count_sim3(*args) for _ in range(2)]
    torch.cuda.synchronize()
    err = float(abs(int(k) - int(tw)))
    repro = all(bool(torch.equal(k, a)) for a in again)
    ops = graph_ops(lambda: match.guided_count_sim3(*args))
    rows, near = _guided_pairs(args)
    n_b_valid = int(args[7].sum())
    n_a = int(args[1].shape[0])
    return dict(name=name, max_abs_err=err,
                ok=err == 0.0 and repro and ops == 1, bitwise_repro=repro,
                device_ops=ops, count=int(k), n_a=n_a,
                n_b=int(args[6].shape[0]), rows_in_front=int(rows.sum()),
                n_in_window=int(near.sum()),
                **_timed(lambda: match.guided_count_sim3(*args)),
                plain_ms=time_cuda(lambda: match.guided_count_sim3_torch(
                    *args)),
                # the operands read once (the point validity gathered a
                # row), the count written
                bytes=nbytes(*args[:4], *args[5:]) + n_a + 4,
                # per row the validity, the Sim3 and the projection (~60);
                # per gated row and valid keypoint the window test (5); per
                # pair inside the window the distance (8 XOR + 8 popcount
                # + 7 adds)
                ops=60 * n_a + 5 * int(rows.sum()) * n_b_valid
                + 23 * int(near.sum()))


def run_guided_cases(device) -> list[dict]:
    """K16 on every ``guided_cases`` case."""
    return [check_guided(device, guided_operands(c, device),
                         name=f"guided_count@{c['name']}")
            for c in guided_cases()]


@contextlib.contextmanager
def watch_guided(which: int = 1):
    """Inside the block, record the operands of the ``which``-th guided
    re-match count of the loop closer (K16; the last one if fewer ran) as
    copies, in ``guided_count_sim3``'s order."""
    from visual_sgraphs_tpu_torch.place import loop_closer
    out = {"calls": 0}
    orig = loop_closer.guided_count_sim3

    def spy(*args, **kw):
        out["calls"] += 1
        if out["calls"] <= which:
            out["operands"] = tuple(t.clone() for t in args[:10])
        return orig(*args, **kw)

    loop_closer.guided_count_sim3 = spy
    try:
        yield out
    finally:
        loop_closer.guided_count_sim3 = orig


def sim3_inputs(device, n: int = 1000, seed: int = 0):
    """Matched camera-frame points of two keyframes: p_b = S p_a (+ 1 cm
    noise) for 60% of the rows, the rest outliers; 90% valid; RANSAC
    samples drawn as the loop closer draws them."""
    rng = np.random.default_rng(seed)
    p_a = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(1, 6, n)], -1).astype(np.float32)
    xi = rng.normal(size=7) * [0.3, 0.1, 0.3, 0.1, 0.3, 0.05, 0.0]
    S = lie.sim3_exp(torch.tensor(xi, dtype=torch.float32))
    p_b = lie.sim3_apply(S, torch.from_numpy(p_a)).numpy()
    p_b = p_b + rng.normal(size=p_b.shape).astype(np.float32) * 0.01
    out = rng.uniform(size=n) < 0.4
    p_b[out] += rng.uniform(-1, 1, (int(out.sum()), 3)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    valid = t(rng.uniform(size=n) > 0.1)
    return (t(p_a), t(p_b.astype(np.float32)), valid,
            default_draw("sim3", 12345, valid))


def check_sim3(device, inputs=None, thresh: float = 0.12) -> dict:
    """K15's Sim3 half (RANSAC 256 x 1000, polish, five refinement steps,
    scale fixed): S within SIM3_TOL, inlier count exactly equal."""
    p_a, p_b, valid, samples = inputs or sim3_inputs(device)
    kw = dict(inlier_thresh=thresh, fix_scale=True)
    k = sim3_ransac.verify_sim3(p_a, p_b, valid, samples, **kw)
    tw = sim3_ransac.verify_sim3_torch(p_a, p_b, valid, samples, **kw)
    torch.cuda.synchronize()
    err = float((k.S_ab - tw.S_ab).abs().max())
    same_n = int(k.n_inliers) == int(tw.n_inliers)
    H, M = samples.shape[0], p_a.shape[0]
    return dict(name="verify_sim3", max_abs_err=err,
                ok=err <= SIM3_TOL and same_n,
                n_inliers=[int(k.n_inliers), int(tw.n_inliers)],
                **_timed(lambda: sim3_ransac.verify_sim3(
                    p_a, p_b, valid, samples, **kw)),
                plain_ms=time_cuda(lambda: sim3_ransac.verify_sim3_torch(
                    p_a, p_b, valid, samples, **kw)),
                bytes=nbytes(p_a, p_b, valid, samples) + 4 * 9 + M,
                # per hypothesis: Horn (~1500) and M Sim3 distances (~35);
                # the polish (2 x 30 M) and five refinement passes (~110 M)
                ops=H * (1500 + 35 * M) + 60 * M + 5 * 110 * M)


def pnp_inputs(device, n: int = 1000, seed: int = 0):
    """World points seen by a camera: pixels with 0.5 px noise for 60%,
    the rest random; 90% valid; 192 picks of six distinct valid matches
    each (the loop closer draws with replacement; a repeated pick leaves
    the DLT under-determined, which ``check_pnp`` does not compare)."""
    rng = np.random.default_rng(seed)
    K = torch.tensor([260.0, 260.0, 319.5, 239.5])
    T = lie.se3_exp(torch.tensor(rng.normal(size=6) * [0.3, 0.1, 0.3, 0.1,
                                                       0.3, 0.05],
                                 dtype=torch.float32))
    p_cam = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(1.5, 7, n)], -1).astype(np.float32)
    xw = lie.se3_apply(lie.se3_inverse(T), torch.from_numpy(p_cam))
    uv = cameras.project_pinhole(K, torch.from_numpy(p_cam)).numpy()
    uv = uv + rng.normal(size=uv.shape).astype(np.float32) * 0.5
    out = rng.uniform(size=n) < 0.4
    uv[out] = rng.uniform((0, 0), (640, 480), (int(out.sum()), 2))
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device)  # noqa
    valid = rng.uniform(size=n) > 0.1
    picks = np.stack([rng.choice(np.flatnonzero(valid), 6, replace=False)
                      for _ in range(192)]).astype(np.int32)
    return (xw.contiguous().to(device), t(uv.astype(np.float32)), t(valid),
            K.to(device), t(picks))


def check_pnp(device, inputs=None) -> dict:
    """K15's PnP half (192 six-point DLTs scored on 1000 matches) against
    the twin at the kernel's precision (float64 eigensolves): on every
    hypothesis whose six picks are distinct, the inlier count exactly
    equal; the winner the same and its pose T0 within SIM3_TOL.  A pick
    row with a repeated match leaves A with a null space of more than one
    dimension, in which either eigensolver may return any vector, so those
    rows are counted, not compared; if one wins, its pose is not compared
    either (``winner_well_posed``).  Besides, the K6 refinement from each
    T0: refined poses within SIM3_TOL, inlier counts within 2."""
    xw, uv, valid, K, picks = inputs or pnp_inputs(device)
    T0k, ck = pnp.pnp_hypotheses(xw, uv, valid, K, picks)
    T0t, ct = pnp.pnp_hypotheses_torch(xw, uv, valid, K, picks,
                                       eig_dtype=torch.float64)
    _, ct32 = pnp.pnp_hypotheses_torch(xw, uv, valid, K, picks)
    gn = dict(iters=10, gate0=20.0 ** 2)
    from visual_sgraphs_tpu_torch.slam import tracking
    Tk, ik = tracking.pose_only_gn(T0k, xw, uv, valid, K, **gn)
    Tt, it = tracking.pose_only_gn_torch(T0t, xw, uv, valid, K, **gn)
    torch.cuda.synchronize()
    srt = torch.sort(picks.long(), dim=1).values
    well = torch.all(srt[:, 1:] != srt[:, :-1], dim=1)
    counts_equal = bool(torch.equal(ck[well], ct[well]))
    bk, bt = int(torch.argmax(ck)), int(torch.argmax(ct))
    winner_well = bool(well[bk]) and bool(well[bt])
    err = float((T0k - T0t).abs().max())
    refined_err = float((Tk - Tt).abs().max())
    dn = abs(int(ik.sum()) - int(it.sum()))
    ok = counts_equal and refined_err <= SIM3_TOL and dn <= 2 and (
        not winner_well or (bk == bt and err <= SIM3_TOL))
    H, M = picks.shape[0], xw.shape[0]
    return dict(name="pnp_hypotheses", max_abs_err=err, ok=ok,
                counts_equal_well_posed=counts_equal,
                n_well_posed=int(well.sum()), winner=[bk, bt],
                winner_well_posed=winner_well,
                best_counts=[int(ck.max()), int(ct.max())],
                best_count_f32_twin=int(ct32.max()),
                refined_pose_err=refined_err,
                refined_inliers=[int(ik.sum()), int(it.sum())],
                **_timed(lambda: pnp.pnp_hypotheses(xw, uv, valid, K,
                                                        picks)),
                plain_ms=time_cuda(lambda: pnp.pnp_hypotheses_torch(
                    xw, uv, valid, K, picks, eig_dtype=torch.float64)),
                bytes=nbytes(xw, uv, valid, K, picks) + 4 * 7,
                # per hypothesis: A^T A (12 x 12 x 12 x 2), ~10 Jacobi
                # sweeps of 66 rotations x 4 x 12 x 6, the procrustes
                # (~1500); per hypothesis and match the projection (~30)
                ops=H * (3456 + 10 * 66 * 288 + 1500 + 30 * M))


def pgo_inputs(device, K: int = 128, E: int = 512, seed: int = 0):
    """A Sim3 pose graph: K keyframe poses along a path, consecutive and
    covisibility edges measuring perturbed relative poses, and one loop
    edge (information 100) closing 0.3 m of drift."""
    rng = np.random.default_rng(seed)
    xi = np.cumsum(rng.normal(size=(K, 6)) * [0.05, 0.01, 0.05, 0.01, 0.05,
                                              0.01], axis=0)
    T = lie.se3_exp(torch.tensor(xi, dtype=torch.float32))
    pairs = [(i, i + 1) for i in range(K - 1)]
    while len(pairs) < E:
        i = int(rng.integers(0, K - 3))
        pairs.append((i, min(i + int(rng.integers(2, 6)), K - 1)))
    idx = torch.tensor(pairs[:E], dtype=torch.int32)
    valid = torch.from_numpy(rng.uniform(size=E) > 0.02)
    edges = pgo.EssentialEdges(idx, valid)
    S_loop = lie.sim3_exp(torch.tensor(
        np.r_[rng.normal(size=3) * 0.1, rng.normal(size=3) * 0.02, 0.0],
        dtype=torch.float32))
    S_loop = lie.sim3_multiply(S_loop, lie.sim3_multiply(
        lie.sim3_from_se3(T[0]), lie.sim3_inverse(lie.sim3_from_se3(
            T[K - 1]))))
    S_old, var_idx, S_meas, info, e_valid = pgo.essential_graph(
        T, torch.ones(K, dtype=torch.bool), edges, 0, K - 1, S_loop)
    S_meas = S_meas.clone()
    S_meas[:-1] = lie.sim3_boxplus(S_meas[:-1], torch.from_numpy(
        (rng.normal(size=(E, 7)) * 0.003 * [1, 1, 1, 1, 1, 1, 0]).astype(
            np.float32)))
    to = lambda x: x.contiguous().to(device)  # noqa: E731
    return (to(S_old), to(var_idx), to(S_meas), to(info), to(e_valid),
            to(T), to(torch.arange(K) == 0))


def check_pgo(device, inputs=None, iters: int = 20) -> list[dict]:
    """K19 on a 128-keyframe, 513-edge Sim3 pose graph (scale fixed):
    H and g within REL_TOL of the generic linearisation (relative to each
    one's largest entry), the cost within REL_TOL; and the whole
    ``iters``-iteration solve with the kernels against the solve with the
    twins: poses within SIM3_TOL."""
    S, var_idx, S_meas, info, valid, T, fixed = inputs or pgo_inputs(device)
    kH, kg = pgo.pgo_assemble(S, var_idx, S_meas, info, valid, True)
    tH, tg = pgo.pgo_assemble_torch(S, var_idx, S_meas, info, valid, True)
    kc = pgo.pgo_cost(S, var_idx, S_meas, info, valid)
    tc = pgo.pgo_cost_torch(S, var_idx, S_meas, info, valid)
    solve = {}
    for tag, fns in (("kernel", (pgo.pgo_assemble, pgo.pgo_cost)),
                     ("plain", (pgo.pgo_assemble_torch, pgo.pgo_cost_torch))):
        problem = pgo.pgo_problem(S, var_idx, S_meas, info, valid,
                                  fixed=fixed, fix_scale=True)
        solve[tag] = pgo.optimize(
            problem, iters=iters,
            assemble=lambda v, f=fns[0]: f(v["kf"].contiguous(), var_idx,
                                           S_meas, info, valid, True),
            cost=lambda v, f=fns[1]: f(v["kf"].contiguous(), var_idx,
                                       S_meas, info, valid))
    torch.cuda.synchronize()
    errH, errg = _rel(kH, tH), _rel(kg, tg)
    errc = float(abs(kc - tc) / max(abs(float(tc)), 1e-30))
    errS = float((solve["kernel"].values["kf"]
                  - solve["plain"].values["kf"]).abs().max())
    E, K = var_idx.shape[0], S.shape[0]
    asm = dict(name="pgo_assemble", max_abs_err=max(errH, errg),
               ok=max(errH, errg) <= REL_TOL and errS <= SIM3_TOL,
               rel_err_H=errH, rel_err_g=errg, solve_pose_err=errS,
               cost=[float(solve["kernel"].cost), float(solve["plain"].cost)],
               **_timed(lambda: pgo.pgo_assemble(S, var_idx, S_meas,
                                                     info, valid, True)),
               plain_ms=time_cuda(lambda: pgo.pgo_assemble_torch(
                   S, var_idx, S_meas, info, valid, True), warmup=1, reps=5),
               # the (7K)^2 system written once, the edges read once;
               # per edge 14 directions x ~2000 flops of Sim3 algebra and
               # 196 x 14 products
               bytes=4 * (49 * K * K + 7 * K) + nbytes(S, var_idx, S_meas,
                                                       info, valid),
               ops=E * (14 * 2000 + 196 * 14 + 14 * 14))
    cost = dict(name="pgo_cost", max_abs_err=errc, ok=errc <= REL_TOL,
                **_timed(lambda: pgo.pgo_cost(S, var_idx, S_meas, info,
                                                  valid)),
                plain_ms=time_cuda(lambda: pgo.pgo_cost_torch(
                    S, var_idx, S_meas, info, valid)),
                bytes=4 + nbytes(S, var_idx, S_meas, info, valid),
                ops=E * 2000)
    return [asm, cost]


def check_schur_gba(device) -> list[dict]:
    """K8 at the global BA's shape (L = 128 keyframes, n = 32768 points,
    O = 8: the kernel's cooperative branch), reported under its own
    names."""
    out = check_schur(device, n=32768, O=8, L=128)
    for r in out:
        r["name"] += "@L128"
    return out


def loop_map_inputs(m, cur: int, cand: int, cam_K, thresh: float = 0.12,
                    key: int = 0) -> dict:
    """The loop path's kernel inputs on a real map (keyframes ``cur`` and
    ``cand``), each built from the plain twins upstream so every kernel is
    checked alone: K5's NN ratio, K15's Sim3 half, K16 and K19."""
    from visual_sgraphs_tpu_torch.place.loop_closer import _loop_drift
    desc_a, desc_b = m.kf_desc[cur], m.kf_desc[cand]
    obs_a, obs_b = m.kf_obs_pt[cur], m.kf_obs_pt[cand]
    va = m.kf_kp_valid[cur] & (obs_a >= 0)
    vb = m.kf_kp_valid[cand] & (obs_b >= 0)
    nn = (desc_a, va, desc_b, vb, m.kf_angle[cur], m.kf_angle[cand])
    match_, _ = match.match_nn_ratio_torch(desc_a, va, desc_b, vb, 0.85,
                                           angle_a=nn[4], angle_b=nn[5])
    ok = match_ >= 0
    pt_a = torch.clamp(obs_a, min=0).long()
    pt_b = torch.clamp(obs_b[torch.clamp(match_, min=0).long()],
                       min=0).long()
    ok = ok & m.pt_valid[pt_a] & m.pt_valid[pt_b]
    p_a = lie.se3_apply(m.kf_pose[cur], m.pt_pos[pt_a]).contiguous()
    p_b = lie.se3_apply(m.kf_pose[cand], m.pt_pos[pt_b]).contiguous()
    sim3 = (p_a, p_b, ok, default_draw("sim3", key, ok))
    res = sim3_ransac.verify_sim3_torch(*sim3, thresh, True)
    guided = (res.S_ab, p_a, obs_a, m.kf_kp_valid[cur], m.pt_valid, desc_a,
              m.kf_uv[cand], m.kf_kp_valid[cand], desc_b, cam_K)
    edges = pgo.build_covis_edges(m, 30, 512)
    S, var_idx, S_meas, info, valid = pgo.essential_graph(
        m.kf_pose, m.kf_valid, edges, cand, cur, lie.sim3_inverse(res.S_ab))
    graph = (S, var_idx, S_meas, info, valid, m.kf_pose,
             torch.arange(m.K, device=S.device) == cand)
    return dict(nn=nn, sim3=sim3, guided=guided, pgo=graph,
                n_inliers=int(res.n_inliers),
                drift=float(_loop_drift(m.kf_pose, cur, cand, res.S_ab)))


def reloc_inputs(m, frame, cand: int, cam_K, key: int = 0):
    """K15's PnP-half inputs of relocalising ``frame`` against keyframe
    ``cand`` (the twin's NN-ratio matches upstream)."""
    obs_b = m.kf_obs_pt[cand]
    vb = m.kf_kp_valid[cand] & (obs_b >= 0)
    match_, _ = match.match_nn_ratio_torch(frame.desc, frame.valid,
                                           m.kf_desc[cand], vb, 0.8)
    ok = match_ >= 0
    pt = torch.clamp(obs_b[torch.clamp(match_, min=0).long()],
                     min=0).long()
    ok = ok & m.pt_valid[pt]
    return (m.pt_pos[pt].contiguous(), frame.uv, ok, cam_K,
            default_draw("pnp", key, ok))


# ---------------------------------------------------------------------------
# the inertial path: K18, K20 and K6's pose prior
# ---------------------------------------------------------------------------

PREINT_TOL = 1e-5  # relative to each field's largest entry, K18
PREINT_COV_TOL = 1e-4  # relative to the covariance's largest entry, K18
VI_POSE_TOL = 1e-4  # pose components and biases, K20
VI_VEL_TOL = 1e-3  # m/s, K20


def _inertial_stream(device, h: int = 480, w: int = 640):
    """The inertial row's scene and its ``orbit`` IMU samples (the
    trajectory of ``main_path.inertial_frames``, 128 frames)."""
    scene = SyntheticScene(h=h, w=w, device=device)
    traj, samples = scene.imu_samples(128, "orbit")
    return scene, traj, samples


def _window_table(samples, t_prev: float, device):
    """One frame's sample table on ``device`` and its integration time."""
    tab, dt = pipeline.sample_window(list(zip(*samples)), t_prev)
    return torch.from_numpy(tab).to(device), float(dt)


def preint_inputs(device, frame: int = 30, n_kf_frames: int = 3):
    """Frame ``frame``'s 64-row sample table of the inertial row (7 valid
    samples at 200 Hz and 30 fps), non-zero biases, and a keyframe window
    of the ``n_kf_frames`` frames before it to fold into."""
    _, _, samples = _inertial_stream(device)
    bg = torch.tensor([0.002, -0.001, 0.0015], device=device)
    ba = torch.tensor([0.03, -0.02, 0.01], device=device)
    since = preintegration.identity_preint(bg, ba)
    for k in range(frame - n_kf_frames, frame):
        tab, _ = _window_table(samples[k], float(samples[k - 1][2][-1]),
                               device)
        _, since = preintegration.preintegrate_merge_torch(since, tab, bg, ba)
    tab, _ = _window_table(samples[frame],
                           float(samples[frame - 1][2][-1]), device)
    return since, tab, bg, ba


PRED_TOL = 1e-5  # predicted pose components and velocity, K18


def preint_pose(device, frame: int = 30):
    """The inertial row's pose and velocity at the frame before ``frame``
    (T_cw, v: the true trajectory's) and the body-camera transform: K18's
    prediction operands."""
    _, traj, _ = _inertial_stream(device)
    T_wc = torch.from_numpy(np.asarray(traj, np.float32)).to(device)
    T_cw = lie.se3_inverse(T_wc[frame - 1])
    v = (T_wc[frame, 4:7] - T_wc[frame - 2, 4:7]) * 15.0  # 30 fps
    T_bc = torch.tensor(ImuConfig().T_bc, dtype=torch.float32, device=device)
    return T_cw.contiguous(), v.contiguous(), T_bc


def check_preint(device) -> dict:
    """K18 on one frame window of the inertial row folded into a keyframe
    window, without and with the pose prediction: ΔR, ΔV, ΔP and the bias
    Jacobians within PREINT_TOL of each field's largest entry, the
    covariances within PREINT_COV_TOL of theirs, the integration times
    exactly, the predicted pose components and velocity within PRED_TOL
    of the twin's (``predict_state``); one launch (one device operation)
    a call, bitwise from launch to launch."""
    since, tab, bg, ba = preint_inputs(device)
    vec = preintegration.pack(since).contiguous()
    pose = preint_pose(device)
    n0 = preintegration.preint_frame.launches
    kw, km, kp = preintegration.preint_frame(vec, tab, bg, ba, pose=pose)
    kw0, km0, none = preintegration.preint_frame(vec, tab, bg, ba)
    per_call = (preintegration.preint_frame.launches - n0) / 2
    tw, tm, tp_ = preintegration.preint_frame_torch(vec, tab, bg, ba,
                                                    pose=pose)
    torch.cuda.synchronize()
    errs, ok, abs_err = {}, True, 0.0
    for tag, k_vec, t_vec in (("window", kw, tw), ("merged", km, tm)):
        k_pre = preintegration.unpack(k_vec)
        t_pre = preintegration.unpack(t_vec)
        for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa",
                  "cov"):
            a, b = getattr(k_pre, f), getattr(t_pre, f)
            errs[f"{tag}.{f}"] = e = _rel(a, b)
            abs_err = max(abs_err, float((a - b).abs().max()))
            ok = ok and e <= (PREINT_COV_TOL if f == "cov" else PREINT_TOL)
        ok = ok and bool(k_pre.dt == t_pre.dt)
    pred_err = max(float((kp[0] - tp_[0]).abs().max()),
                   float((kp[1] - tp_[1]).abs().max()))
    same = (none is None and _bits_equal(kw0, kw) and _bits_equal(km0, km))
    again = [preintegration.preint_frame(vec, tab, bg, ba, pose=pose)
             for _ in range(3)]
    repro = all(_bits_equal(x, y) for o in again
                for x, y in zip((kw, km, *kp), (o[0], o[1], *o[2])))

    def kernel(p=pose):
        return preintegration.preint_frame(vec, tab, bg, ba, pose=p)

    n_ops = graph_ops(kernel)
    n_valid = int((tab[:, 7] != 0).sum())
    # per valid sample: the step's 3x3 algebra (~400), Σ's block update
    # (27 lanes x ~120) and the Jacobians (45 x ~8); the merge ~1500; the
    # prediction ~200
    return dict(name="preint", max_abs_err=max(abs_err, pred_err),
                ok=ok and pred_err <= PRED_TOL and same and repro
                and per_call == 1 and n_ops == 1,
                rel_errs=errs, pred_max_abs_err=pred_err,
                window_without_prediction_equal=same, bitwise_repro=repro,
                launches_per_call=per_call, device_ops=n_ops,
                n_valid=n_valid,
                ms=time_cuda(kernel), device_ms=device_time(kernel),
                ms_without_prediction=time_cuda(lambda: kernel(None)),
                device_ms_without_prediction=device_time(
                    lambda: kernel(None)),
                plain_ms=time_cuda(lambda: preintegration.preint_frame_torch(
                    vec, tab, bg, ba, pose=pose), reps=5),
                bytes=nbytes(vec, tab, bg, ba, *pose)
                + 4 * preintegration.FRAME_OUT,
                ops=(400 + 27 * 120 + 45 * 8) * n_valid + 1500 + 200,
                library_ms=None)


def vi_pose_inputs(device, frame: int = 30, n_pts: int = 16384,
                   seed: int = 0):
    """A per-frame visual-inertial solve at the inertial row's shapes:
    frame ``frame`` of the 640x480 ``orbit`` sequence through ORB (1000
    keypoints), map points at the depth-valid keypoints' true positions
    plus 1 cm noise (16384-point table), 10% of them unmatched, the
    frame's preintegration from its IMU samples, the previous frame's
    true pose and velocity as (T_i, v_i), and the true pose perturbed as
    the start."""
    rng = np.random.default_rng(seed)
    scene, traj, samples = _inertial_stream(device)
    # the scene's world has gravity along +y; the solve's, after the
    # initialisation, along -z: express the map, poses and velocities in
    # the gravity-aligned world (x' = R_gw x)
    q_gw = lie.so3_exp(torch.tensor([-math.pi / 2, 0.0, 0.0]))
    G = lie.se3_from_rt(q_gw, torch.zeros(3)).to(device)
    R_gw = lie.quat_to_matrix(q_gw).to(device)
    T_wc = torch.from_numpy(traj[frame]).to(device)
    gray, depth, _ = scene.render(traj[frame])
    fr = make_frame_obs(gray, depth, 0.0, scene.cam, OrbConfig(
        n_features=1000))
    cam_K = torch.from_numpy(scene.cam.K).to(device)
    F = fr.uv.shape[0]
    rays = cameras.unproject_pinhole(cam_K, fr.uv, fr.depth)
    X = lie.se3_apply(lie.se3_multiply(G, T_wc), rays) + torch.from_numpy(
        rng.normal(size=(F, 3)) * 0.01).float().to(device)
    pt_pos = torch.zeros((n_pts, 3), device=device)
    pt_pos[:F] = X
    pt_valid = torch.zeros((n_pts,), dtype=torch.bool, device=device)
    pt_valid[:F] = True
    keep = torch.from_numpy(rng.uniform(size=F) > 0.1).to(device)
    slot_pt = torch.where(fr.valid & (fr.depth > 0) & keep,
                          torch.arange(F, device=device), -1).to(torch.int32)
    m = MapState(*([None] * len(MapState._fields)))._replace(
        pt_pos=pt_pos, pt_valid=pt_valid)
    tab, dt = _window_table(samples[frame],
                            float(samples[frame - 1][2][-1]), device)
    z3 = torch.zeros((3,), device=device)
    pre, _ = preintegration.preintegrate_merge_torch(
        preintegration.identity_preint(z3, z3), tab, z3, z3)
    T_cw = lambda i: lie.se3_inverse(lie.se3_multiply(  # noqa: E731
        G, torch.from_numpy(traj[i]).to(device)))
    v_i = R_gw @ torch.from_numpy(
        (traj[frame] - traj[frame - 1])[4:7] * 30.0).to(device)
    T_j0 = lie.se3_boxplus(T_cw(frame), torch.tensor(
        [0.01, -0.005, 0.01, 0.002, -0.003, 0.001], device=device))
    bf = torch.full((), scene.cam.bf, dtype=torch.float32, device=device)
    walk = pipeline.walk_info(ImuConfig(), dt)
    return (m, fr, slot_pt, T_j0, v_i.clone(), T_cw(frame - 1), v_i, pre,
            lie.se3_identity(device=device), cam_K, bf, walk)


def check_vi_pose(device) -> dict:
    """K20 at the inertial row's shapes (F = 1000, 6 iterations): inlier
    count equal, pose and biases within VI_POSE_TOL, velocity within
    VI_VEL_TOL of the twin."""
    args = vi_pose_inputs(device)
    k = pipeline.pose_inertial_gn(*args)
    t = pipeline.pose_inertial_gn_torch(*args)
    torch.cuda.synchronize()
    e_pose = float((k[0] - t[0]).abs().max())
    e_vel = float((k[1] - t[1]).abs().max())
    e_bias = max(float((k[2] - t[2]).abs().max()),
                 float((k[3] - t[3]).abs().max()))
    ms = time_cuda(lambda: pipeline.pose_inertial_gn(*args))
    device_ms = device_time(lambda: pipeline.pose_inertial_gn(*args))
    plain = time_cuda(lambda: pipeline.pose_inertial_gn_torch(*args), reps=5)
    m, fr, slot_pt = args[0], args[1], args[2]
    F = slot_pt.shape[0]
    n_obs = int((slot_pt >= 0).sum())
    # per iteration: ~80 operations a matched feature's three rows (weight,
    # projection, Jacobian) plus 3 x 27 normal-equation sums, 15 forward-
    # mode passes of the preintegration residual (~1500 each), the 15x15
    # assembly (~4000) and solve (~2300); the final inlier count
    ops = 6 * (n_obs * (80 + 3 * 2 * 27) + 15 * 1500 + 4000 + 2300) \
        + 20 * n_obs
    return dict(name="vi_pose", max_abs_err=max(e_pose, e_vel, e_bias),
                ms=ms, device_ms=device_ms, plain_ms=plain,
                ok=(int(k[4]) == int(t[4]) and e_pose <= VI_POSE_TOL
                    and e_bias <= VI_POSE_TOL and e_vel <= VI_VEL_TOL),
                n_inliers=[int(k[4]), int(t[4])], pose_err=e_pose,
                vel_err=e_vel, bias_err=e_bias, n_obs=n_obs,
                bytes=nbytes(fr.uv, fr.depth, fr.valid, slot_pt)
                + n_obs * 13 + 4 * (7 + 3 + 7 + 3 + 143 + 7 + 4 + 1)
                + 4 * 17, ops=ops, library_ms=None)


# K20's sections between thread 0's clock stamps (csrc/vi_pose.cu): once
# a solve, then each iteration's, then the inlier count
VI_POSE_ONCE = ("sqrt_info",)
VI_POSE_SECTIONS = ("imu_columns", "walk_wait", "assembly", "elimination",
                    "retraction")


def vi_pose_sections(device, iters: int = 6) -> dict:
    """Where K20's time goes: thread 0's SM clock (``clock64``) at the
    kernel's section boundaries on ``vi_pose_inputs``, in cycles (each
    iteration's section a mean over the iterations) and the share of the
    whole launch."""
    args = vi_pose_inputs(device)
    pipeline.pose_inertial_gn_sections(*args, iters=iters)
    c = pipeline.pose_inertial_gn_sections(*args, iters=iters).cpu().numpy()
    k = len(VI_POSE_ONCE)
    once = dict(zip(VI_POSE_ONCE, np.diff(c[:k + 1]).tolist()))
    per_it = np.diff(c[k + 1:k + 1 + len(VI_POSE_SECTIONS) * iters + 1]
                     ).reshape(iters, len(VI_POSE_SECTIONS))
    total = int(c[-1] - c[0])
    sections = {name: float(per_it[:, i].mean())
                for i, name in enumerate(VI_POSE_SECTIONS)}
    return dict(name="vi_pose_sections", total_cycles=total, **once,
                iteration_cycles=float(per_it.sum(1).mean()),
                per_iteration_cycles=sections,
                share={name: iters * v / total
                       for name, v in sections.items()},
                inlier_count=int(c[-1] - c[-2]))


PRIOR_WEIGHTS = (10.0, 1e5, 1e9)  # the main path's, a middling, dominant
PRIOR_SHIFT_MIN = 100 * POSE_TOL  # the dominant prior's least pose shift


def pose_prior_inputs(device, n: int = 4096):
    """``pose_inputs`` and a prior pose offset from the start by ~0.02."""
    T0, xw, uv, valid, K, depth, bf = pose_inputs(device, n)
    T_prior = lie.se3_boxplus(T0, torch.tensor(
        [0.01, -0.02, 0.01, 0.005, 0.0, -0.004], device=device))
    return T0, xw, uv, valid, K, depth, bf, T_prior


def check_pose_gn_prior(device) -> dict:
    """K6's prior branch at 4096 matches with stereo rows, at the main
    path's weight 10, at 1e5 and at 1e9: pose within POSE_TOL and inlier
    flags equal on >= INLIER_AGREE of rows at each.  At weight 10 the
    prior moves the pose by ~5e-8, far inside POSE_TOL, so a kernel that
    dropped it would pass there; at 1e9 (above every eigenvalue of JᵀJ,
    1e7 to 9e8 on these matches) the prior pulls the solve onto T_prior,
    a shift of ~0.04 from the solve without it.  The kernel's shift (prior minus K6 without it) must
    exceed PRIOR_SHIFT_MIN and match the twin's within 2 POSE_TOL (each
    shift is the difference of two poses held to POSE_TOL)."""
    T0, xw, uv, valid, K, depth, bf, T_prior = pose_prior_inputs(device)
    kw = dict(iters=12, gate0=(2.0 * 15.0) ** 2, depth=depth, bf=bf)
    kF, _ = tracking.pose_only_gn(T0, xw, uv, valid, K, **kw)
    tF, _ = tracking.pose_only_gn_torch(T0, xw, uv, valid, K, **kw)
    errs, agree, k_shift, t_shift, shift_err = [], [], [], [], []
    for w in PRIOR_WEIGHTS:
        kT, kin = tracking.pose_only_gn_prior(T0, xw, uv, valid, K, T_prior,
                                              w, **kw)
        tT, tin = tracking.pose_only_gn_prior_torch(T0, xw, uv, valid, K,
                                                    T_prior, w, **kw)
        torch.cuda.synchronize()
        errs.append(float((kT - tT).abs().max()))
        agree.append(float((kin == tin).float().mean()))
        k_shift.append(float((kT - kF).abs().max()))
        t_shift.append(float((tT - tF).abs().max()))
        shift_err.append(float(((kT - kF) - (tT - tF)).abs().max()))

    def kernel():
        return tracking.pose_only_gn_prior(T0, xw, uv, valid, K, T_prior,
                                           PRIOR_WEIGHT, **kw)

    before = tracking.pose_only_gn_prior.launches
    kT, kin = kernel()
    launches = tracking.pose_only_gn_prior.launches - before
    kT2, kin2 = kernel()
    repro = bool(torch.equal(kT, kT2) and torch.equal(kin, kin2))
    plain = time_cuda(lambda: tracking.pose_only_gn_prior_torch(
        T0, xw, uv, valid, K, T_prior, PRIOR_WEIGHT, **kw))
    # K6's ~135 a match and iteration, plus the prior's log (~300) a
    # iteration
    return dict(name="pose_gn_prior", max_abs_err=max(errs),
                ms=time_cuda(kernel), device_ms=device_time(kernel),
                plain_ms=plain,
                ok=(max(errs) <= POSE_TOL and min(agree) >= INLIER_AGREE
                    and k_shift[-1] >= PRIOR_SHIFT_MIN
                    and shift_err[-1] <= 2 * POSE_TOL and repro
                    and launches == 1),
                bitwise_repro=repro, launches_per_call=launches,
                weights=list(PRIOR_WEIGHTS), pose_errs=errs,
                inlier_agreement=agree, prior_shift=k_shift,
                twin_prior_shift=t_shift, prior_shift_err=shift_err,
                bytes=nbytes(T0, xw, uv, valid, K, depth, T_prior)
                + 7 * 4 + xw.shape[0],
                ops=(135 * xw.shape[0] + 300) * kw["iters"], library_ms=None)


# ---------------------------------------------------------------------------
# free-space rooms (K17a, K17b) and the scene-graph BA's assembly (K21)
# ---------------------------------------------------------------------------

FREESPACE_FRAME = 30  # a rendered orbit2 frame away from the start pose
SG_BA_TOL = 1e-4  # per component: a whole scene-graph BA, kernel vs twin


def freespace_inputs(device, frame: int = FREESPACE_FRAME, h: int = 480,
                     w: int = 640, G: int = 32, voxel: float = 0.35):
    """A rendered ``orbit2`` frame's depth, its T_cw (not the identity),
    cam_K, and the origin of a (G, G, G) grid centred on frame 0's camera,
    as the manager places it."""
    scene = SyntheticScene(h=h, w=w, device=device)
    traj = scene.trajectory(96, "orbit2")
    _, depth, _ = scene.render(traj[frame])
    T_cw = lie.se3_inverse(torch.from_numpy(traj[frame]).to(device))
    C0 = torch.from_numpy(traj[0][4:7]).to(device)
    return depth, T_cw, scene.cam_K, C0 - 0.5 * G * voxel


def snake_grid(G: int = 32) -> np.ndarray:
    """(G, G, G) bool: one 6-connected serpentine path (rows along x at
    every other y, joined at alternating ends, in the plane z = G / 2),
    ~500 voxel steps long.  48 synchronous sweeps cannot carry a label
    along it, so its labels, sizes and centres differ from those of an
    in-place (Gauss-Seidel) sweep."""
    g = np.zeros((G, G, G), bool)
    z = G // 2
    for k, y in enumerate(range(0, G - 1, 2)):
        g[1:G - 1, y, z] = True
        if y + 2 < G - 1:
            g[G - 2 if k % 2 == 0 else 1, y + 1, z] = True
    return g


def check_freespace_carve(device, frame: int = FREESPACE_FRAME,
                          G: int = 32, voxel: float = 0.35) -> dict:
    """K17a on a rendered 480x640 frame with a non-identity pose: the grid
    exactly equal to the twin's, from an empty grid and carved again into
    a grid the twin carved from another frame."""
    depth, T_cw, cam_K, origin = freespace_inputs(device, frame, G=G,
                                                  voxel=voxel)
    from visual_sgraphs_tpu_torch.scenegraph import freespace as fs

    def carve(fn, grid):
        return fn(grid, origin, voxel, depth, T_cw, cam_K)

    empty = torch.zeros((G, G, G), dtype=torch.bool, device=device)
    k = carve(fs.accumulate_freespace, empty.clone())
    t = carve(fs.accumulate_freespace_torch, empty.clone())
    d0, T0, _, _ = freespace_inputs(device, 0, G=G, voxel=voxel)
    prior = fs.accumulate_freespace_torch(empty.clone(), origin, voxel, d0,
                                          T0, cam_K)
    k2 = carve(fs.accumulate_freespace, prior.clone())
    t2 = carve(fs.accumulate_freespace_torch, prior.clone())
    torch.cuda.synchronize()
    n_diff = int((k != t).sum()) + int((k2 != t2).sum())
    hs, ws = -(-depth.shape[0] // 8), -(-depth.shape[1] // 8)
    grid = empty.clone()
    return dict(name="freespace_carve", max_abs_err=float(n_diff),
                ok=n_diff == 0 and int(t.sum()) > 0, n_free=int(t.sum()),
                n_free_two_frames=int(t2.sum()), voxels_differ=n_diff,
                **_timed(lambda: carve(fs.accumulate_freespace, grid)),
                plain_ms=time_cuda(lambda: carve(
                    fs.accumulate_freespace_torch, grid)),
                # the hs x ws strided depth samples read, the grid written;
                # per sample and fraction ~20 flops
                bytes=4 * hs * ws + G ** 3 + nbytes(T_cw, cam_K, origin),
                ops=5 * hs * ws * 20, library_ms=None)


def check_freespace_components(device, grid, origin, voxel: float = 0.35,
                               name: str = "freespace_components") -> dict:
    """K17b on ``grid``: labels, sizes, top labels, validity and centres
    exactly equal to the twin's."""
    from visual_sgraphs_tpu_torch.scenegraph import freespace as fs
    grid = torch.as_tensor(grid).to(device)
    k = fs.freespace_components(grid, origin, voxel)
    t = fs.freespace_components_torch(grid, origin, voxel)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(k, t)]
    err = float((k[0] - t[0]).abs().max())
    G = grid.shape[0]
    return dict(name=name, max_abs_err=err, ok=all(same),
                exact=dict(zip(("centers", "valid", "top_sizes",
                                "top_labels", "labels"), same)),
                n_free=int(grid.sum()), top_sizes=t[2].tolist(),
                valid=t[1].tolist(),
                **_timed(lambda: fs.freespace_components(
                    grid, origin, voxel, with_labels=False)),
                plain_ms=time_cuda(lambda: fs.freespace_components_torch(
                    grid, origin, voxel), reps=5),
                # the grid read, 4 centres / flags out; 48 sweeps of 7
                # compares a voxel, the histogram and 4 top-k passes
                bytes=G ** 3 + nbytes(origin) + 4 * (12 + 1 + 8),
                ops=G ** 3 * (48 * 7 + 2 + 4 * 2 + 4 * 5), library_ms=None)


def sg_assemble_inputs(seed: int = 0, L: int = 11, P: int = 64, R: int = 16,
                       Dn: int = 16, Q: int = 1024) -> dict:
    """Seeded numpy operands of K21 at the main path's shapes (D = 6L + 3P
    + 3R + 6Dn = 402) with live items of every factor type: plane
    observations near their planes (some invalid, some pointing at a -1
    plane), point quadrics of noisy plane samples, 4-wall rooms (one with
    two wall slots on one plane), 2-wall corridors (one on a single
    plane), invalid rooms with -1 walls, and doors (some invalid)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def poses(n):
        xi = np.concatenate([rng.normal(size=(n, 3)),
                             rng.normal(size=(n, 3)) * 0.3], axis=1)
        return lie.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()

    T = poses(L)
    n = rng.normal(size=(P, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    planes = np.concatenate([n, rng.uniform(-4, 4, size=(P, 1))], 1)
    planes = planes.astype(f32)
    kf = rng.integers(0, L, Q)
    pl = rng.integers(0, P, Q)
    local = plane_mod.transform(torch.from_numpy(T[kf]),
                                torch.from_numpy(planes[pl])).numpy()
    obs = plane_mod.normalize(torch.from_numpy(
        (local + rng.normal(size=(Q, 4)) * 0.01).astype(f32))).numpy()
    ob_valid = rng.uniform(size=Q) > 0.1
    ob_plane = np.where(rng.uniform(size=Q) < 0.03, -1, pl)
    ob_valid &= ob_plane >= 0
    # quadrics of 20 points scattered about each observed local plane
    pts = rng.normal(size=(Q, 20, 3)) * 2.0
    nl, cl = local[:, None, :3], local[:, None, 3:]
    pts = pts - (np.sum(pts * nl, -1, keepdims=True) + cl) * nl
    pts += rng.normal(size=pts.shape) * 0.02
    hom = np.concatenate([pts, np.ones((Q, 20, 1))], -1)
    quad = np.einsum("qni,qnj->qij", hom, hom) / 20.0
    walls = np.full((R, 4), -1)
    room4, room2 = np.zeros(R, bool), np.zeros(R, bool)
    for r in range(R):
        w = rng.choice(P, 4, replace=False)
        if r < R // 2:
            walls[r], room4[r] = w, True
            if r == 0:
                walls[r, 1] = walls[r, 0]  # two wall slots on one plane
        elif r < R - max(1, R // 8):
            walls[r, :2], room2[r] = w[:2], True
            if r == R // 2:
                walls[r, 1] = walls[r, 0]
        else:
            walls[r, :2] = w[:2]  # invalid rooms: weight 0
    rooms = rng.normal(size=(R, 3)) * 2.0
    doors = poses(Dn)
    door_room = rng.integers(0, R, Dn)
    door_rel = doors[:, 4:7] - rooms[door_room] + rng.normal(
        size=(Dn, 3)) * 0.05
    return dict(
        poses=T, planes=planes, rooms=rooms.astype(f32), doors=doors,
        ob_idx=np.stack([kf, np.maximum(ob_plane, 0)], 1).astype(np.int32),
        ob_coeffs=obs.astype(f32),
        ob_info=np.maximum(rng.uniform(0.02, 1.0, Q), 0.1).astype(f32),
        ob_valid=ob_valid, ob_quadric=quad.astype(f32),
        quad_info=np.full(Q, 5.0, f32), quad_valid=ob_valid.copy(),
        room_idx=np.concatenate([np.arange(R)[:, None],
                                 np.maximum(walls, 0)], 1).astype(np.int32),
        room_info=np.ones(R, f32), room4_valid=room4, room2_valid=room2,
        door_idx=np.stack([np.arange(Dn), door_room], 1).astype(np.int32),
        door_rel=door_rel.astype(f32), door_info=np.ones(Dn, f32),
        door_valid=rng.uniform(size=Dn) > 0.2)


def sg_assemble_operands(d: dict, device, dtype=torch.float32):
    """(poses, planes, rooms, doors, SgFactors) of ``sg_assemble_inputs``
    on ``device``, floats in ``dtype``."""
    from visual_sgraphs_tpu_torch.optim.fast_ba import SgFactors

    def to(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return (t.to(dtype) if t.is_floating_point() else t).to(device)

    return (to(d["poses"]), to(d["planes"]), to(d["rooms"]), to(d["doors"]),
            SgFactors(**{k: to(d[k]) for k in SgFactors._fields}))


SG_LIVE = ("ob_valid", "quad_valid", "room4_valid", "room2_valid",
           "door_valid")


def sg_system_args(d: dict, device, seed: int = 1) -> tuple:
    """K21's operands for ``sg_assemble_inputs`` ``d``: (poses, planes,
    rooms, doors, SgFactors, S_kf, rhs_kf), the keyframe block a seeded
    symmetric positive matrix and vector scaled to the largest entries of
    the scene-graph H and g (so that neither part hides the other)."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    ops = sg_assemble_operands(d, device)
    H, g = fast_ba.sg_assemble_torch(*sg_assemble_operands(
        d, device, torch.float64))
    kd = 6 * ops[0].shape[0]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(kd, kd))
    S_kf = A @ A.T
    S_kf *= float(H.abs().max()) / np.abs(S_kf).max()
    rhs_kf = rng.normal(size=kd)
    rhs_kf *= float(g.abs().max()) / np.abs(rhs_kf).max()
    return (*ops, torch.from_numpy(S_kf.astype(np.float32)).to(device),
            torch.from_numpy(rhs_kf.astype(np.float32)).to(device))


def _sg_work(fac) -> int:
    """Operations of K21's system on ``fac``'s live items: directions x
    flops a direction (the residual in dual numbers), then directions^2 x
    rows multiply-adds of w J^T J, then one add a contributor."""
    per_item = {"ob_valid": 9 * 600 + 81 * 6, "quad_valid": 9 * 650 + 81 * 2,
                "room4_valid": 15 * 450 + 225 * 6,
                "room2_valid": 9 * 250 + 81 * 6,
                "door_valid": 9 * 400 + 81 * 6}
    return sum(int(getattr(fac, k).sum()) * v for k, v in per_item.items())


def check_sg_assemble(device, inputs=None, args=None,
                      name: str = "sg_assemble") -> dict:
    """K21's system (``fast_ba.sg_system``: the scene-graph factors' H and
    g with the landmarks' keyframe block, S = H + S_kf, rhs = [rhs_kf - g_kf
    | -g_rest]) over the call's plan against the float64 twin: S and rhs
    within REL_TOL of each one's largest entry; S exactly symmetric; one
    device operation a call (the nodes of a captured CUDA graph); S and
    rhs bitwise equal over four launches.  ``args`` (poses, planes, rooms,
    doors, SgFactors, S_kf, rhs_kf), else seeded ones from ``inputs``
    (``sg_assemble_inputs``, every factor type live); the float32 twin's
    own error is reported beside."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    if args is None:
        args = sg_system_args(inputs or sg_assemble_inputs(), device)
    poses, planes, rooms, doors, fac, S_kf, rhs_kf = args
    plan = fast_ba.sg_plan(fac, poses.shape[0], planes.shape[0])

    def fn():
        return fast_ba.sg_system(poses, planes, rooms, doors, fac, plan,
                                 S_kf, rhs_kf)

    kS, krhs = fn()
    repro = all(torch.equal(kS, S2) and torch.equal(krhs, r2)
                for S2, r2 in (fn() for _ in range(3)))

    def f64(t):
        return t.double() if t.is_floating_point() else t

    dS, drhs = fast_ba.sg_system_torch(
        *map(f64, (poses, planes, rooms, doors)), type(fac)(*map(f64, fac)),
        None, S_kf.double(), rhs_kf.double())
    tS, trhs = fast_ba.sg_system_torch(poses, planes, rooms, doors, fac,
                                       None, S_kf, rhs_kf)
    torch.cuda.synchronize()
    errS, errr = _rel(kS.double(), dS), _rel(krhs.double(), drhs)
    live = {k: int(getattr(fac, k).sum()) for k in SG_LIVE}
    n_ops = graph_ops(fn)
    symmetric = bool(torch.equal(kS, kS.T))
    D = kS.shape[0]
    return dict(name=name, max_abs_err=max(errS, errr),
                ok=(max(errS, errr) <= REL_TOL and repro and n_ops == 1
                    and symmetric),
                rel_err_S=errS, rel_err_rhs=errr,
                twin32_rel_err_S=_rel(tS.double(), dS),
                twin32_rel_err_rhs=_rel(trhs.double(), drhs),
                live_items=live, n_pairs=int(plan.meta[1]), D=D,
                device_ops=n_ops, bitwise_repro=repro, symmetric=symmetric,
                **_timed(fn),
                plain_ms=time_cuda(lambda: fast_ba.sg_system_torch(
                    poses, planes, rooms, doors, fac, None, S_kf, rhs_kf),
                    warmup=1, reps=5),
                bytes=4 * (D * D + D) + nbytes(poses, planes, rooms, doors,
                                               *fac, S_kf, rhs_kf),
                ops=_sg_work(fac), library_ms=None)


def check_sg_plan(device, args=None, name: str = "sg_plan") -> dict:
    """K21's plan against its twin: the live items, the coupled pairs,
    their contributor lists and offsets, the pair map and the counts
    exactly, the observations' chart rotations within 1e-12; one device
    operation a call, bitwise equal over two launches.  ``args`` as
    ``check_sg_assemble``'s."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    if args is None:
        args = sg_system_args(sg_assemble_inputs(), device)
    fac, L, P = args[4], args[0].shape[0], args[1].shape[0]
    fields = ("live", "pairs", "pptr", "pent", "epos", "pmap", "meta")

    def fn():
        return fast_ba.sg_plan(fac, L, P)

    k, k2 = fn(), fn()
    t = fast_ba.sg_plan_torch(fac, L, P)
    torch.cuda.synchronize()
    exact = all(torch.equal(getattr(k, f), getattr(t, f)) for f in fields)
    repro = all(torch.equal(getattr(k, f), getattr(k2, f))
                for f in fields + ("rot",))
    err = float((k.rot - t.rot).abs().max()) if k.rot.numel() else 0.0
    n_ops = graph_ops(fn)
    n_live, n_pairs = (int(x) for x in t.meta)
    n_ent = int(t.pptr[n_pairs])
    V = k.pmap.shape[0]
    return dict(name=name, max_abs_err=err,
                ok=exact and repro and err <= 1e-12 and n_ops == 1,
                exact=exact, bitwise_repro=repro, device_ops=n_ops,
                n_live=n_live, n_pairs=n_pairs, contributors=n_ent,
                **_timed(fn),
                plain_ms=time_cuda(lambda: fast_ba.sg_plan_torch(fac, L, P),
                                   warmup=1, reps=5),
                bytes=nbytes(*fac[:2], fac.ob_valid, fac.quad_valid,
                             fac.room_idx, fac.room4_valid, fac.room2_valid,
                             fac.door_idx, fac.door_valid,
                             *(getattr(k, f) for f in fields + ("rot",))),
                # the rotations (~60 float64 flops a plane observation),
                # 5 slot tests an item, the ranks (~10 an entry), the pair
                # map, the walks (~6 a visited entry, twice)
                ops=60 * fac.ob_idx.shape[0] + 5 * k.live.shape[0]
                + 10 * 5 * n_live + V * V + 12 * n_ent, library_ms=None)


@contextlib.contextmanager
def watch_sg_system(which: int = 17):
    """Inside the block, record the operands of the ``which``-th call of
    K21's system from ``fast_scenegraph_ba`` (the last one if fewer ran)
    as copies: (poses, planes, rooms, doors, SgFactors, S_kf, rhs_kf).  The
    copies cost device time: watch a run that is not timed."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    out = {"calls": 0}
    orig = fast_ba.sg_system

    def spy(poses, planes, rooms, doors, fac, plan, S_kf, rhs_kf):
        out["calls"] += 1
        if out["calls"] <= which:
            out["operands"] = tuple(t.clone() for t in (
                poses, planes, rooms, doors)) + (
                type(fac)(*(t.clone() for t in fac)), S_kf.clone(),
                rhs_kf.clone())
        return orig(poses, planes, rooms, doors, fac, plan, S_kf, rhs_kf)

    spy.launches = orig.launches
    fast_ba.sg_system = spy
    try:
        yield out
    finally:
        fast_ba.sg_system = orig


@contextlib.contextmanager
def watch_planes(which: int = 8):
    """Inside the block, record the operands of the ``which``-th plane
    extraction (K13) of a scene-graph keyframe (the last one if fewer ran)
    as copies: (points, valid, weights, hyp_idx, dist_thresh,
    min_inliers)."""
    from visual_sgraphs_tpu_torch.scenegraph import manager as sgm
    out = {"calls": 0}
    orig = sgm.extract_planes

    def spy(points, valid, weights, hyp_idx, dist_thresh=0.04,
            min_inliers=50.0):
        out["calls"] += 1
        if out["calls"] <= which:
            out["operands"] = (points.clone(), valid.clone(),
                               weights.clone(), hyp_idx.clone(),
                               dist_thresh, min_inliers)
        return orig(points, valid, weights, hyp_idx, dist_thresh,
                    min_inliers)

    sgm.extract_planes = spy
    try:
        yield out
    finally:
        sgm.extract_planes = orig


def check_extract_planes(device, args, name: str = "extract_planes@bench"
                         ) -> dict:
    """K13 on recorded operands (``watch_planes``) against its twin: the
    same planes found, coefficients within PLANE_TOL, assignments equal on
    >= ASSIGN_AGREE; one device operation a call; bitwise equal over four
    launches."""
    def fn():
        return plane_fit.extract_planes(*args)

    k = fn()
    repro = all(all(torch.equal(a, b) for a, b in zip(k, fn()))
                for _ in range(3))
    t = plane_fit.extract_planes_torch(*args)
    torch.cuda.synchronize()
    err = float((k[0] - t[0]).abs().max())
    agree = float((k[2] == t[2]).float().mean())
    same_valid = bool(torch.equal(k[1], t[1]))
    n_ops = graph_ops(fn)
    cloud, cvalid, cweight, hyp = args[:4]
    N, H = cloud.shape[0], hyp.shape[1]
    return dict(name=name, max_abs_err=err,
                ok=(same_valid and err <= PLANE_TOL and agree >= ASSIGN_AGREE
                    and repro and n_ops == 1),
                planes_valid=k[1].tolist(), assign_agreement=agree,
                bitwise_repro=repro, device_ops=n_ops,
                **_timed(fn), plain_ms=time_cuda(
                    lambda: plane_fit.extract_planes_torch(*args)),
                bytes=nbytes(cloud, cvalid, cweight, hyp, *t),
                ops=hyp.shape[0] * (9 * H * N + 48 * N + 2000),
                library_ms=None)


def seed_rooms_and_doors(sg):
    """``sg`` with a 4-wall room, a 2-wall corridor and a door made from
    its valid planes (repeating planes when it has fewer than four), so
    that a whole scene-graph BA on a real map runs all five factor types.
    Each room centre starts 0.05 m off its walls' anchor, as a detection
    places it, and the door 0.5 m from the room: a door's rotation is a
    null space of its factor, so a room far off its walls (metres) leaves
    the damped float32 solve a ~1e-4 spread in the door's pose whatever
    assembles H.  Reads the device (a check's set-up)."""
    from visual_sgraphs_tpu_torch.optim.factors import _room_pair_vec
    ids = torch.nonzero(sg.pl_valid).flatten().tolist()
    if not ids:
        raise ValueError("seed_rooms_and_doors: no valid plane")
    pick = [ids[i % len(ids)] for i in range(4)]
    pl = sg.pl_coeffs
    anchor2 = _room_pair_vec(pl[pick[0]], pl[pick[1]])
    anchor4 = anchor2 + _room_pair_vec(pl[pick[2]], pl[pick[3]])
    rw = sg.room_walls.clone()
    rw[0] = torch.tensor(pick, dtype=rw.dtype)
    rw[1] = torch.tensor(pick[:2] + [-1, -1], dtype=rw.dtype)
    rc = sg.room_center.clone()
    rc[0], rc[1] = anchor4 + 0.05, anchor2 - 0.05
    rv = sg.room_valid.clone()
    rv[:2] = True
    dp = sg.door_pose.clone()
    dp[0, 4:7] = rc[0] + torch.tensor([0.5, 0.0, 0.2], device=dp.device)
    dv = sg.door_valid.clone()
    dv[0] = True
    return sg._replace(room_walls=rw, room_center=rc, room_valid=rv,
                       door_pose=dp, door_valid=dv,
                       n_rooms=torch.full_like(sg.n_rooms, 2),
                       n_doors=torch.full_like(sg.n_doors, 1))


def _sg_system_f64(poses, planes, rooms, doors, fac, plan, S_kf, rhs_kf):
    """K21's twin evaluated in float64, its S and rhs rounded to
    float32."""
    from visual_sgraphs_tpu_torch.optim import fast_ba

    def f64(t):
        return t.double() if t.is_floating_point() else t

    S, rhs = fast_ba.sg_system_torch(
        *map(f64, (poses, planes, rooms, doors)), type(fac)(*map(f64, fac)),
        plan, S_kf.double(), rhs_kf.double())
    return S.float(), rhs.float()


def check_sg_ba(m, sg, kf: int, cam_K, cam_bf, config,
                name: str = "sg_ba") -> dict:
    """A whole ``fast_scenegraph_ba`` call with K21 against the same call
    with its twin (every other kernel the same): keyframe poses, planes,
    room centres and door poses within SG_BA_TOL of the call whose twin
    runs in float64.  The float32 twin's H is ~4e-4 off the float64 one
    (the Gij quadric's cancellation, see ``sg_assemble.cu``), and a room
    centre amplifies plane errors by the walls' distances, so its call is
    reported beside, not gated."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    out = {}
    for tag, fn in (("kernel", fast_ba.sg_system),
                    ("plain64", _sg_system_f64),
                    ("plain32", fast_ba.sg_system_torch)):
        out[tag] = fast_ba.fast_scenegraph_ba(
            m, sg, kf, cam_K, cam_bf, iters=6, config=config, system=fn)
    torch.cuda.synchronize()

    def errs(a, b):
        (ma, sa, _), (mb, sb, _) = a, b
        return dict(
            kf_pose=float((ma.kf_pose - mb.kf_pose).abs().max()),
            pl_coeffs=float((sa.pl_coeffs - sb.pl_coeffs).abs().max()),
            room_center=float((sa.room_center - sb.room_center).abs().max()),
            door_pose=float((sa.door_pose - sb.door_pose).abs().max()))

    e64 = errs(out["kernel"], out["plain64"])
    moved = float((out["kernel"][1].room_center
                   - sg.room_center).abs().max())
    return dict(name=name, max_abs_err=max(e64.values()),
                ok=max(e64.values()) <= SG_BA_TOL, errs=e64,
                errs_vs_twin32=errs(out["kernel"], out["plain32"]),
                room_moved=moved,
                cost=[float(out[k][2]) for k in ("kernel", "plain64",
                                                 "plain32")],
                n_rooms=int(sg.room_valid.sum()),
                n_doors=int(sg.door_valid.sum()))


def run_freespace(device) -> list[dict]:
    """K17a on a rendered frame, K17b on the snake grid, K21's plan and
    system on seeded operands (K17b on a slice's accumulated grid is
    ``chip_smoke.py``'s)."""
    _, _, _, origin = freespace_inputs(device)
    args = sg_system_args(sg_assemble_inputs(), device)
    return [check_freespace_carve(device),
            check_freespace_components(device, snake_grid(), origin,
                                       name="freespace_components@snake"),
            check_sg_plan(device, args), check_sg_assemble(device,
                                                           args=args)]


def run_inertial(device) -> list[dict]:
    """The inertial path's kernels against their twins."""
    return [check_preint(device), check_vi_pose(device),
            check_pose_gn_prior(device)]


# ---------------------------------------------------------------------------
# K22: the LM engine's kernel route (optim/lm_kernels.py)
# ---------------------------------------------------------------------------

# K22a's reduced pose block S and rhs, K22b's H and g, against the float64
# twin, each entry scaled by sqrt(H_ii H_jj) (g_i by sqrt(H_ii) and the
# largest scaled |g|): the system spans ~17 orders of magnitude, so an
# error relative to its largest entry would not see the small blocks.
# Float32 rows summed in another order are off by 3e-6 - 1.1e-5 (K22a on
# the VI window, NVIDIA H100 80GB HBM3, 700.00 W) and up to 6e-5 (the
# float32 twin on the local BA windows); leaving out Hxx's damping moves
# S by 0.06 at lambda 1e-4 and 0.25 - 0.84 at 1 (``undamped_rel_err``), so
# K22a is held at both dampings of LM_LAMS to LM_REDUCE_TOL, between
LM_REDUCE_TOL = 2e-4
LM_REL_TOL = 1e-3  # K22b's H and g
# K22b's plan: W against the float64 twin's, relative to its largest entry
# (both float64 Choleskys of the same matrix, in another order)
LM_PLAN_TOL = 1e-10
LM_STEP_TOL = 1e-3  # K22a's point steps, relative to the largest step
LM_COST_TOL = 1e-5  # relative, the float64-summed costs
# K22c against the twin's float64 solve of the same float64 system: the
# factorisations differ only in their summation order
LM_SOLVE_TOL = 1e-6  # relative to the largest |dx|
LM_CAND_TOL = 1e-5  # candidate values (float32 retractions)
LM_LAM = 1e-4  # the first iteration's damping
LM_LAMS = (LM_LAM, 1.0)  # and one after four rejections


# the seeded K22c systems' sizes (chip_smoke.py, the GPU tests) and the
# family layout of each: the main path's D = 150 (VI BA), 66 (local BA),
# 201 (an initialisation of 64 keyframes); single tiles and their edges
# (1, 15, 16, 17); the last size whose tiles fit in shared memory (224)
# and the first two past it (225, 264, the local BA tiled to 44 slots)
LM_SEEDED_LAYOUTS = {
    1: dict(scale=1), 15: dict(pose=1, vel=3),
    16: dict(pose=1, vel=1, bg=1, ba=1, scale=1),
    17: dict(pose=1, vel=1, bg=1, ba=1, gdir=1), 66: dict(pose=11),
    150: dict(pose=10, vel=10, bg=10, ba=10),
    201: dict(vel=64, bg=1, ba=1, gdir=1, scale=1),
    224: dict(pose=37, gdir=1),
    225: dict(vel=72, bg=1, ba=1, gdir=1, scale=1), 264: dict(pose=44)}


def lm_solve_system(D: int, seed: int = 0) -> dict:
    """A seeded K22c system of size D (a key of LM_SEEDED_LAYOUTS), as
    numpy: H = J^T J and g = J^T c for J = R diag(s), R = I + N(0, 0.25 /
    D) (well conditioned) and s^2 spanning 1e-10 to ~3e6, so that H's
    diagonal spans ~1e-10 to 1e7 as the inertial systems' does while the
    solve stays well posed in float64; c = -J x with x ~ N(0, 0.05^2) (0
    on the gauge), so that the step is of an LM step's size (the
    candidates are float32, their tolerance absolute); ``free`` (D,) bool
    with the gauge fixed (the first pose's 6 columns, else column 0 when
    D > 1); float32 values of the layout's families (unit quaternions for
    pose and gdir)."""
    layout = LM_SEEDED_LAYOUTS[D]
    rng = np.random.default_rng(1000 + D + seed)
    s = 10.0 ** rng.uniform(-5.0, 3.25, D)
    J = (np.eye(D) + rng.normal(size=(D, D)) * (0.5 / np.sqrt(D))) * s
    free = np.ones(D, bool)
    free[:6 if "pose" in layout else int(D > 1)] = False
    c = -J @ (rng.normal(0.0, 0.05, D) * free)
    values = {}
    for k, n in layout.items():
        if k in ("pose", "gdir"):
            q = rng.normal(size=(n, 4))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            v = q if k == "gdir" else np.concatenate(
                [q, rng.normal(size=(n, 3))], axis=1)
        elif k == "scale":
            v = np.full((1, 1), 1.0 + 0.1 * rng.normal())
        else:
            v = rng.normal(size=(n, 3))
        values[k] = v.astype(np.float32)
    return dict(J=J, c=c, H=J.T @ J, g=J.T @ c, free=free, values=values)


class VIWindow(NamedTuple):
    """A VI local BA's inputs, as ``SlamSystem`` passes them."""

    m: MapState
    imu: object  # vi_ba.ImuKfState
    kf: int
    cam_K: torch.Tensor
    cam_bf: torch.Tensor
    T_bc: torch.Tensor
    walk_g: float
    walk_a: float


class LbaWindow(NamedTuple):
    """A generic windowed BA's inputs (``mapping.local_ba``)."""

    m: MapState
    kf: int
    cam_K: torch.Tensor
    cam_bf: torch.Tensor | None
    n_window: int
    n_local_pts: int


class LmWindows(NamedTuple):
    vi: VIWindow
    lba: LbaWindow


@contextlib.contextmanager
def watch_lm_windows(system, which: int = 3):
    """Inside the block, record the inputs of ``system``'s ``which``-th VI
    local BA (the last one if fewer ran) under "vi" and of the last generic
    local BA under "lba" (each a copy of the map); the solves themselves
    are unchanged.  The copies cost device time: watch a run that is not
    timed."""
    from visual_sgraphs_tpu_torch.slam import mapping
    out = {"vi_calls": 0}
    pipe = system.imu
    vi_orig, lba_orig = pipe.local_ba, mapping.local_ba

    def vi_spy(sys_, kf, **kw):
        out["vi_calls"] += 1
        if out["vi_calls"] <= which:
            out["vi"] = VIWindow(
                MapState(*(t.clone() for t in sys_.map)), pipe.state, kf,
                sys_.cam_K, sys_.cam_bf, pipe.T_bc, pipe.cfg.walk_gyro,
                pipe.cfg.walk_acc)
        return vi_orig(sys_, kf, **kw)

    def lba_spy(m, kf_id, cam_K, cam_bf=None, n_window=10,
                n_local_pts=8192, iters=10):
        out["lba"] = LbaWindow(MapState(*(t.clone() for t in m)), kf_id,
                               cam_K, cam_bf, n_window, n_local_pts)
        return lba_orig(m, kf_id, cam_K, cam_bf, n_window, n_local_pts,
                        iters)

    pipe.local_ba, mapping.local_ba = vi_spy, lba_spy
    try:
        yield out
    finally:
        del pipe.local_ba
        mapping.local_ba = lba_orig


def lm_windows(seen: dict) -> LmWindows:
    """The windows ``watch_lm_windows`` recorded."""
    missing = [k for k in ("vi", "lba") if k not in seen]
    if missing:
        raise RuntimeError(f"lm_windows: no {missing} local BA ran")
    return LmWindows(seen["vi"], seen["lba"])


def lm_window(device, n_frames: int = 72) -> LmWindows:
    """The third VI local BA window and the last generic local BA window
    of a small inertial run on ``device`` (72 ``arc`` frames at 240x320
    rendered on the CPU, 300 features, 32 keyframes / 4096 points)."""
    from visual_sgraphs_tpu_torch import main_path
    from visual_sgraphs_tpu_torch.config import CapacityConfig
    scene, frames = main_path.inertial_frames("cpu", n_frames, 240, 320,
                                              "arc")
    cfg = main_path.inertial_config(scene, 300, CapacityConfig(32, 4096))
    system = main_path.make_system(cfg, device, False)
    with watch_lm_windows(system) as seen:
        for frame in frames:
            main_path.feed_inertial(system, frame)
    return lm_windows(seen)


def _f64(x):
    """Floating tensors (and those inside tuples / dicts) in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _f64(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_replace"):
        return type(x)(*(_f64(v) for v in x))
    return x


def tile_window(p: dict, reps: int) -> dict:
    """A reprojection-only problem with its window repeated ``reps``
    times: slot s + k L of copy k holds slot s's pose and rows (the same
    points), so every slot of a wider window observes real data."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    rows, L = p["rows"], p["red"].pose.shape[0]
    tiled = lmk.ReprojRows(
        slot=torch.cat([rows.slot + k * L for k in range(reps)]),
        pt=rows.pt.repeat(reps), uvr=rows.uvr.repeat(reps, 1),
        use=rows.use.repeat(reps), stereo=rows.stereo.repeat(reps))
    return dict(p, red=lmk.Reduced(pose=p["red"].pose.repeat(reps, 1)),
                free=p["free"].repeat(reps), rows=tiled)


def tile_edges(p: dict, n_edges: int = 100) -> dict:
    """The initialisation problem ``p`` with its keyframe chain repeated
    until it has ``n_edges`` edges (past the K22b rows launch's 64 edges a
    round): copy k's rows k n .. k n + n - 1 hold rows 0 .. n - 1's poses
    and velocities and copy k's edges the same preintegrations between
    them; every seventh edge is made invalid."""
    imu, red = p["imu"], p["red"]
    n, E, dev = red.vel.shape[0], imu.edge.shape[0], red.vel.device
    t = torch.arange(n_edges, device=dev)
    src = t % E
    edge = imu.edge[src] + ((t // E) * n).to(torch.int32)[:, None]
    rows = torch.arange(-(-n_edges // E) * n, device=dev) % n
    free = p["free"]
    return dict(p, red=red._replace(vel=red.vel[rows].contiguous()),
                free=torch.cat([free[:3 * n].reshape(n, 3)[rows].reshape(-1),
                                free[3 * n:]]),
                imu=imu._replace(pre=imu.pre[src].contiguous(),
                                 edge=edge.contiguous(),
                                 valid=imu.valid[src] & (t % 7 != 6),
                                 poses=imu.poses[rows].contiguous()))


def lm_problems(win: LmWindows) -> dict:
    """The VI local BA problem of the VI window, the initialisation
    problem over its map's keyframes (as ``ImuPipeline.try_initialize``
    poses it) and that problem tiled to 100 and 1500 edges, the generic
    local BA problem of the other window and that problem tiled to 22 and
    44 slots (past the shared pair-sum accumulator's 33), float32 and
    float64."""
    from visual_sgraphs_tpu_torch.inertial import init as iinit
    from visual_sgraphs_tpu_torch.inertial import vi_ba
    from visual_sgraphs_tpu_torch.inertial.preintegration import (
        Preintegrated)
    from visual_sgraphs_tpu_torch.slam import mapping
    v = win.vi
    *_, vi = vi_ba.vi_problem(v.m, v.imu, v.kf, v.cam_K, v.cam_bf, v.T_bc,
                              v.walk_g, v.walk_a, 10, 4096)
    m = v.m
    n = min(int(m.n_kf), m.K)
    init = iinit.init_problem(
        m.kf_pose[:n], m.kf_valid[:n],
        Preintegrated(*(f[:n] for f in v.imu.preint)),
        v.imu.preint_valid[:n], v.T_bc, fix_scale=True)
    b = win.lba
    *_, lba = mapping.lba_problem(b.m, b.kf, b.cam_K, b.cam_bf, b.n_window,
                                  b.n_local_pts)
    out = {"vi": vi, "init": init, "init_x100": tile_edges(init),
           "init_x1500": tile_edges(init, 1500),
           "lba": lba, "lba_x2": tile_window(lba, 2),
           "lba_x4": tile_window(lba, 4)}
    return {**out, **{k + "64": _f64(p) for k, p in out.items()}}


def _lam(like, dtype=torch.float32, lam: float = LM_LAM):
    return torch.full((), lam, dtype=dtype, device=like.device)


def _rel_scaled(A, B, d) -> float:
    """max |A - B| / sqrt(d_i d_j) (matrices) or max |a - b| / sqrt(d_i)
    over the largest |b| / sqrt(d_i) (vectors), d = |diag| floored."""
    d = d.abs().clamp(min=1e-30).sqrt()
    if A.dim() == 2:
        return float(((A - B).abs() / (d[:, None] * d[None, :])).max())
    return float(((A - B).abs() / d).max()
                 / (B.abs() / d).max().clamp(min=1e-30))


def _reduced_pose(H, g, pairs, rhs, lam: float, eps: float):
    """(S, rhs) of the pose block: H damped as _solve_step damps it, minus
    the pair sums; -g plus the pair sums' rhs."""
    P6 = pairs.shape[0]
    Hp = H[:P6, :P6]
    damp = lam * torch.clamp(torch.diagonal(Hp), min=1e-6) + eps
    return (Hp + torch.diag(damp) - pairs, -g[:P6] + rhs)


def _present_slots(rows, L: int, N: int) -> torch.Tensor:
    """(N,) the number of window slots observing each landmark (a check's
    host read)."""
    use = rows.use.cpu()
    key = (rows.pt.cpu().long() * L + rows.slot.cpu().long())[use]
    return torch.bincount(torch.unique(key) // L, minlength=N)


def _tagged(name: str, tag: str, main: str) -> str:
    return name if tag == main else f"{name}@{tag}"


def check_lm_reproj(problems: dict, tag: str = "vi") -> list[dict]:
    """K22a on a real window's problem ``tag``: at each damping of
    LM_LAMS, the reduced pose block S = Hpp + damping - pairs and its rhs
    within LM_REDUCE_TOL (scaled) of the float64 twin's (the float32
    twin's error, and what leaving out Hxx's damping would move, beside);
    then the back-substitution of the float64 twin's full step: the
    points' steps within LM_STEP_TOL of the largest, the candidate cost
    and the cost without a step within LM_COST_TOL, both one device
    operation a call given the solve's plan and bitwise from launch to
    launch."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    p32, p64 = problems[tag], problems[tag + "64"]
    D = lmk.offsets(p32["red"])["D"]
    eps = lmk._eps(torch.float32)
    N32 = p32["pts"].shape[0]
    plan = lmk.lm_reproj_plan(p32["rows"], N32)

    def reduce(p, fn, dtype, lam=LM_LAM):
        return fn(p["red"].pose, p["pts"], p["rows"], p["cam"], p["bf"],
                  _lam(p["pts"], dtype, lam), D, plan)

    errs, twin32, undamped, first = {}, {}, {}, None
    for lam in LM_LAMS:
        k = reduce(p32, lmk.lm_reproj_reduce, torch.float32, lam)
        t64 = reduce(p64, lmk.lm_reproj_reduce_torch, torch.float64, lam)
        t32 = reduce(p32, lmk.lm_reproj_reduce_torch, torch.float32, lam)
        t0 = reduce(p64, lmk.lm_reproj_reduce_torch, torch.float64, 0.0)
        torch.cuda.synchronize()
        S64, r64 = _reduced_pose(*t64[:4], lam, eps)
        dS = torch.diagonal(S64)

        def err(H, g, pairs, rhs):
            S, r = _reduced_pose(H.double(), g.double(), pairs.double(),
                                 rhs.double(), lam, eps)
            return max(_rel_scaled(S, S64, dS), _rel_scaled(r, r64, dS))

        errs[lam], twin32[lam] = err(*k[:4]), err(*t32[:4])
        undamped[lam] = err(*t0[:4])
        if first is None:
            first = (k, t64, t32)
    k, t64, t32 = first
    # a step: the float64 twin's solve of the whole system
    H64, g64 = t64[0].clone(), t64[1].clone()
    if p64.get("imu") is not None:
        H64, g64 = lmk.lm_inertial_assemble_torch(p64["imu"], p64["red"],
                                                  H64, g64)
    dx64, cand64 = lmk.lm_solve_torch(H64, g64, t64[2], t64[3], p64["free"],
                                      _lam(H64, torch.float64), p64["red"])
    cand32 = lmk.Reduced(*(None if v is None else v.float() for v in cand64))
    cost_args = (cand32.pose, p32["pts"], p32["pt_fixed"], p32["rows"],
                 p32["cam"], p32["bf"])
    dx32 = dx64.float()

    def cost_step():
        return lmk.lm_reproj_cost(*cost_args, k[4], dx32, plan=plan)

    def cost_none():
        return lmk.lm_reproj_cost(*cost_args, plan=plan)

    pk, ck = cost_step()
    c0k = cost_none()[1]
    pt, ct = lmk.lm_reproj_cost_torch(cand64.pose, p64["pts"],
                                      p64["pt_fixed"], p64["rows"],
                                      p64["cam"], p64["bf"], t64[4], dx64)
    c0t = lmk.lm_reproj_cost_torch(cand64.pose, p64["pts"], p64["pt_fixed"],
                                   p64["rows"], p64["cam"], p64["bf"])[1]
    torch.cuda.synchronize()
    step = pt - p64["pts"]
    e_step = float(((pk.double() - p64["pts"]) - step).abs().max()
                   / step.abs().max().clamp(min=1e-30))
    e_cost = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                 for a, b in ((ck, ct), (c0k, c0t)))
    # points and cost bitwise from launch to launch, one device operation
    # a call with a step and without
    cost_repro = all(_bits_equal(pk, o[0]) and torch.equal(ck, o[1])
                     for o in (cost_step() for _ in range(3)))
    cost_repro = cost_repro and all(torch.equal(c0k, cost_none()[1])
                                    for _ in range(3))
    cost_ops = [graph_ops(cost_step), graph_ops(cost_none)]
    rows = p32["rows"]
    M, L, N = rows.slot.shape[0], p32["red"].pose.shape[0], p32["pts"].shape[0]
    # bitwise from launch to launch, one device operation a call given
    # the solve's plan
    again = [reduce(p32, lmk.lm_reproj_reduce, torch.float32)
             for _ in range(3)]
    repro = all(torch.equal(x, y) for o in again for x, y in
                zip(k[:4] + (k[4].Linv, k[4].c, k[4].mask),
                    o[:4] + (o[4].Linv, o[4].c, o[4].mask)))
    prof = device_ops(lambda: reduce(p32, lmk.lm_reproj_reduce,
                                     torch.float32))
    reduce_dev = device_time(lambda: reduce(p32, lmk.lm_reproj_reduce,
                                            torch.float32))
    plan_t = lmk.lm_reproj_plan_torch(rows, N)
    plan_ok = all(torch.equal(x, y) for x, y in zip(plan, plan_t))
    plan_prof = device_ops(lambda: lmk.lm_reproj_plan(rows, N))
    plan_ms = time_cuda(lambda: lmk.lm_reproj_plan(rows, N))
    plan_dev = device_time(lambda: lmk.lm_reproj_plan(rows, N))
    plan_plain = time_cuda(lambda: lmk.lm_reproj_plan_torch(rows, N))
    plan_lib = time_cuda(lambda: torch.sort(rows.pt, stable=True))
    n_use = int(rows.use.sum())
    npres = _present_slots(rows, L, N)
    pairs_work = int((npres * npres).sum())
    row_bytes = nbytes(*rows) + nbytes(p32["red"].pose, p32["pts"],
                                       p32["cam"], p32["bf"])
    reduce_ms = time_cuda(lambda: reduce(p32, lmk.lm_reproj_reduce,
                                         torch.float32))
    reduce_plain = time_cuda(lambda: reduce(
        p32, lmk.lm_reproj_reduce_torch, torch.float32), reps=5)
    t32_state = t32[4]
    cost_ms = time_cuda(cost_step)
    cost_dev = device_time(cost_step)
    cost_plain = time_cuda(lambda: lmk.lm_reproj_cost_torch(
        *cost_args, t32_state, dx32), reps=5)
    n_obs_slot = int(npres.sum())
    e_red = max(errs.values())
    return [
        dict(name=_tagged("lm_reproj_plan", tag, "vi"),
             max_abs_err=0.0 if plan_ok else float("inf"), ok=plan_ok,
             M=M, N=N, rows_used=int(plan_t.ptr[-1]),
             device_ops=plan_prof["ops"], device_ms=plan_dev, ms=plan_ms,
             plain_ms=plan_plain, library_ms=plan_lib,
             # ids and flags read, ptr and idx written; a count, a fill
             # and a sort step a used row (~10 operations)
             bytes=5 * M + 4 * (N + 1) + 4 * M, ops=10 * M),
        dict(name=_tagged("lm_reproj_reduce", tag, "vi"), max_abs_err=e_red,
             # leaving out the damping would fail the check at lambda = 1
             ok=e_red <= LM_REDUCE_TOL
             and undamped[LM_LAMS[-1]] > 10 * LM_REDUCE_TOL and repro,
             bitwise_repro=repro, device_ops=prof["ops"],
             device_ms=reduce_dev,
             rel_err_S_rhs={str(k_): v for k_, v in errs.items()},
             twin32_rel_err={str(k_): v for k_, v in twin32.items()},
             undamped_rel_err={str(k_): v for k_, v in undamped.items()},
             M=M, L=L, N=N, D=D, rows_used=n_use, ms=reduce_ms,
             plain_ms=reduce_plain,
             # rows read; H, g, pairs, rhs, per-landmark factors, c, P and
             # masks written once
             bytes=row_bytes + 8 * (D * D + D + 36 * L * L + 6 * L)
             + N * (24 + 12 + 4 * ((L + 31) // 32)) + 72 * n_obs_slot,
             # ~420 flops a used row (projection, Jacobians, Hxx, bx, P_s,
             # the slot block); ~60 a landmark's factor; 2 x 3 x 18 an
             # observing slot's B_s; 36 x 6 a slot pair, 36 an rhs entry
             ops=420 * n_use + 60 * N + 108 * n_obs_slot + 216 * pairs_work
             + 36 * n_obs_slot, library_ms=None),
        dict(name=_tagged("lm_reproj_cost", tag, "vi"),
             max_abs_err=max(e_step, e_cost),
             ok=e_step <= LM_STEP_TOL and e_cost <= LM_COST_TOL
             and cost_repro and cost_ops == [1, 1],
             rel_err_step=e_step, rel_err_cost=e_cost,
             cost=[float(ck), float(ct)], cost_no_step=[float(c0k),
                                                        float(c0t)],
             bitwise_repro=cost_repro, device_ops=cost_ops[0],
             device_ops_no_step=cost_ops[1], device_ms=cost_dev,
             device_ms_no_step=device_time(cost_none),
             ms=cost_ms, plain_ms=cost_plain,
             bytes=row_bytes + N * (12 + 24 + 12 + 4 * ((L + 31) // 32) + 1)
             + 72 * n_obs_slot + 4 * D + 8,
             # 36 + 30 a landmark's step, ~60 a used row's robust cost
             ops=(36 * n_obs_slot + 30 * N) + 60 * n_use, library_ms=None)]


def check_lm_inertial(problems: dict,
                      tags=("vi", "init", "init_x100", "init_x1500")
                      ) -> list[dict]:
    """K22b on a real window's VI problem, the initialisation problem over
    its keyframes and that problem tiled to 100 edges and to 1500 (past
    the rows launch's shared-memory edge index, ``tile_edges``):
    the plan's W within LM_PLAN_TOL of the float64 twin's and its edge
    index equal; H and g within LM_REL_TOL (scaled) of the float64 twin
    (the generic linearisation), also when added into zeros (equal to the
    written H, g); the cost within LM_COST_TOL; three more launches of
    each entry bitwise equal, one device operation a call (``graph_ops``;
    the VI problem timed as the solve calls it, adding into H, g and the
    cost); the float32 twin's errors beside."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    out = []
    for tag in tags:
        p32, p64 = problems[tag], problems[tag + "64"]
        imu, red = p32["imu"], p32["red"]
        D = lmk.offsets(red)["D"]
        f64 = dict(dtype=torch.float64, device=imu.pre.device)
        plan = lmk.lm_inertial_plan(imu, red)
        tplan = lmk.lm_inertial_plan_torch(p64["imu"], p64["red"])
        kH, kg = lmk.lm_inertial_assemble(imu, red, plan=plan)
        aH, ag = lmk.lm_inertial_assemble(
            imu, red, torch.zeros((D, D), **f64), torch.zeros((D,), **f64),
            plan)
        kc = lmk.lm_inertial_cost(imu, red, plan=plan)
        ac = lmk.lm_inertial_cost(imu, red, torch.full((), 1.5, **f64), plan)
        tH, tg = lmk.lm_inertial_assemble_torch(p64["imu"], p64["red"])
        sH, sg = lmk.lm_inertial_assemble_torch(imu, red)
        tc = lmk.lm_inertial_cost_torch(p64["imu"], p64["red"])
        again = [(*lmk.lm_inertial_assemble(imu, red, plan=plan),
                  lmk.lm_inertial_cost(imu, red, plan=plan))
                 for _ in range(3)]
        torch.cuda.synchronize()
        e_W = _rel(plan.W, tplan.W)
        index_ok = all(torch.equal(a, b) for a, b in zip(plan[1:5],
                                                         tplan[1:5]))
        d = torch.diagonal(tH)
        e_H, e_g = _rel_scaled(kH, tH, d), _rel_scaled(kg, tg, d)
        e_c = abs(float(kc) - float(tc)) / max(abs(float(tc)), 1e-30)
        added = (torch.equal(aH, kH) and torch.equal(ag, kg)
                 and float(ac) == 1.5 + float(kc))
        repro = all(torch.equal(H, kH) and torch.equal(g, kg)
                    and torch.equal(c, kc) for H, g, c in again)
        # timed as the solves call them: the VI rows and cost added into
        # K22a's H, g and cost, the initialisation's written whole
        H0 = g0 = acc0 = None
        if tag == "vi":
            H0, g0 = torch.zeros((D, D), **f64), torch.zeros((D,), **f64)
            acc0 = torch.zeros((), **f64)
        calls = {
            "lm_inertial_plan": (lambda: lmk.lm_inertial_plan(imu, red),
                                 lambda: lmk.lm_inertial_plan_torch(imu,
                                                                    red)),
            "lm_inertial_assemble": (
                lambda: lmk.lm_inertial_assemble(imu, red, H0, g0, plan),
                lambda: lmk.lm_inertial_assemble_torch(imu, red)),
            "lm_inertial_cost": (
                lambda: lmk.lm_inertial_cost(imu, red, acc0, plan),
                lambda: lmk.lm_inertial_cost_torch(imu, red))}
        timed = {k: dict(ms=time_cuda(fn), device_ms=device_time(fn),
                         device_ops=graph_ops(fn),
                         plain_ms=time_cuda(twin, warmup=1, reps=5))
                 for k, (fn, twin) in calls.items()}
        one_op = all(t["device_ops"] == 1 for t in timed.values())
        E, R = imu.edge.shape[0], red.vel.shape[0]
        nv = int(plan.nvalid[0])
        nd = 15 if imu.gs else 24
        # what both entries need: each edge's preintegration but its
        # covariance, its whitening W in its place, the edges, validity,
        # weights and values (the plan's edge index is derived from them)
        edge_in = (nbytes(imu.pre) - 4 * 81 * E + nbytes(plan.W)
                   + nbytes(imu.edge, imu.valid, imu.T_bc, imu.info_g,
                            imu.info_a, imu.poses)
                   + nbytes(*(v for v in red if v is not None)))
        # H, g: the touched entries read and written (adding), or every
        # entry written
        touched = int((tH != 0).sum()) + int((tg != 0).sum())
        out_bytes = 16 * touched if tag == "vi" else 8 * (D * D + D)
        name = lambda k: _tagged(k, tag, "vi")  # noqa: E731
        # a residual in float64 duals is ~2000 flops a direction, the
        # staging nd^2 x 9 x 2, each term of an entry 1, the walks 12 an
        # entry; the cost one value-only residual an edge; the plan ~1000
        # flops an edge's W and two passes of R x E index comparisons
        out += [
            dict(name=name("lm_inertial_plan"), max_abs_err=e_W,
                 ok=e_W <= LM_PLAN_TOL and index_ok and one_op,
                 index_equal=index_ok, edges=[nv, E], R=R,
                 **timed["lm_inertial_plan"],
                 bytes=nbytes(imu.edge, imu.valid) + E * 81 * (4 + 8)
                 + nbytes(*plan[1:5]), ops=1000 * E + 4 * R * E,
                 library_ms=None),
            dict(name=name("lm_inertial_assemble"),
                 max_abs_err=max(e_H, e_g),
                 ok=max(e_H, e_g) <= LM_REL_TOL and added and repro
                 and one_op, rel_err_H=e_H, rel_err_g=e_g,
                 twin32_rel_err_H=_rel_scaled(sH.double(), tH, d),
                 twin32_rel_err_g=_rel_scaled(sg.double(), tg, d),
                 bitwise_repro=repro, added_equal=added, edges=[nv, E], D=D,
                 **timed["lm_inertial_assemble"],
                 bytes=edge_in + out_bytes,
                 ops=nv * (nd * 2000 + nd * nd * 18) + touched * 4
                 + 36 * nv, library_ms=None),
            dict(name=name("lm_inertial_cost"), max_abs_err=e_c,
                 ok=e_c <= LM_COST_TOL and repro and one_op,
                 rel_err_cost=e_c, bitwise_repro=repro, edges=[nv, E],
                 **timed["lm_inertial_cost"],
                 bytes=edge_in + 8,
                 ops=nv * 2000 + 12 * nv, library_ms=None)]
    return out


def check_lm_solve(problems: dict, tags=("vi", "init")) -> dict:
    """K22c on real windows' full systems (the float64 twins' H, g, pairs,
    rhs at lambda = 1e-4), one for each of ``tags`` (the first timed): the
    step within LM_SOLVE_TOL of the twin's float64 solve of the same
    system, the candidates within LM_CAND_TOL; the float32 twin's step
    error beside (the reference's precision).  The initialisation's
    system is compacted (its poses fixed)."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    errs, errs32, systems = {}, {}, {}
    for tag in tags:
        p32, p64 = problems[tag], problems[tag + "64"]
        D = lmk.offsets(p64["red"])["D"]
        H = g = pairs = rhs = None
        if p64.get("rows") is not None:
            H, g, pairs, rhs, _ = lmk.lm_reproj_reduce_torch(
                p64["red"].pose, p64["pts"], p64["rows"], p64["cam"],
                p64["bf"], _lam(p64["pts"], torch.float64), D)
        if p64.get("imu") is not None:
            H, g = lmk.lm_inertial_assemble_torch(p64["imu"], p64["red"], H,
                                                  g)
        H, g = H.contiguous(), g.contiguous()
        if pairs is not None:
            pairs, rhs = pairs.contiguous(), rhs.contiguous()
        lam = _lam(H)
        free = p32["free"]
        kd, kc = lmk.lm_solve(H, g, pairs, rhs, free, lam, p32["red"])
        td, tc = lmk.lm_solve_torch(H, g, pairs, rhs, free, lam, p32["red"])
        sd, _ = lmk.lm_solve_torch(
            H.float(), g.float(), None if pairs is None else pairs.float(),
            None if rhs is None else rhs.float(), free, lam, p32["red"])
        torch.cuda.synchronize()
        scale = td.abs().max().clamp(min=1e-30)
        errs[tag] = dict(
            D=D, dx=float((kd - td).abs().max() / scale),
            cand=max(float((a - b).abs().max()) for a, b in zip(kc, tc)
                     if a is not None))
        errs32[tag] = float((sd - td).abs().max() / scale)
        systems[tag] = (H, g, pairs, rhs, free, lam, p32["red"], D)
    H, g, pairs, rhs, free, lam, red, D = systems[tags[0]]
    S = H + torch.eye(D, dtype=H.dtype, device=H.device)
    e = max(max(v["dx"] for v in errs.values()),
            max(v["cand"] for v in errs.values()))
    return dict(name=_tagged("lm_solve", tags[0], "vi"), max_abs_err=e,
                ok=all(v["dx"] <= LM_SOLVE_TOL and v["cand"] <= LM_CAND_TOL
                       for v in errs.values()), errs=errs,
                twin32_rel_err_dx=errs32, D=D,
                **_solve_times(H, g, pairs, rhs, free, lam, red, S),
                bytes=8 * (D * D + D) + nbytes(pairs, rhs) + D + 4 + 4 * D
                + 2 * nbytes(*(v for v in red if v is not None)),
                # the Cholesky (D^3 / 3 flops), two triangular solves (2 D^2
                # each), the damping and masking (~4 D^2), the retraction
                ops=D ** 3 // 3 + 8 * D * D + 300 * red.pose.shape[0])


def _solve_times(H, g, pairs, rhs, free, lam, red, S) -> dict:
    """K22c's and its twin's CUDA-event ms, and ``cholesky_ex`` of ``S``
    (the same size) as the library yardstick; the kernel's and the
    library call's device time (``device_time``)."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk

    def kernel():
        return lmk.lm_solve(H, g, pairs, rhs, free, lam, red)

    def library():
        return torch.linalg.cholesky_ex(S)

    return dict(ms=time_cuda(kernel), device_ms=device_time(kernel),
                plain_ms=time_cuda(lambda: lmk.lm_solve_torch(
                    H, g, pairs, rhs, free, lam, red), reps=5),
                library_ms=time_cuda(library),
                library_device_ms=device_time(library))


def lm_solve_operands(system: dict, device) -> tuple:
    """(H, g, free, lam, red) of a ``lm_solve_system`` on ``device``:
    float64 H, g, lambda LM_LAM in float32, the float32 values."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    H = torch.from_numpy(system["H"]).to(device)
    return (H, torch.from_numpy(system["g"]).to(device),
            torch.from_numpy(system["free"]).to(device), _lam(H),
            lmk.Reduced(**{k: torch.from_numpy(v).to(device)
                           for k, v in system["values"].items()}))


def check_lm_solve_seeded(device) -> dict:
    """K22c on the seeded systems of every size of LM_SEEDED_LAYOUTS (no
    landmark terms) against the twin's float64 solve: the step within
    LM_SOLVE_TOL of the largest |dx|, the candidates within LM_CAND_TOL;
    and on the D = 150 system with its free block negated (not positive
    definite), where kernel and twin must give a zero step and candidates
    equal to the inputs.  Timed at D = 150 against ``cholesky_ex``."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    errs = {}
    for D in LM_SEEDED_LAYOUTS:
        H, g, free, lam, red = lm_solve_operands(lm_solve_system(D), device)
        kd, kc = lmk.lm_solve(H, g, None, None, free, lam, red)
        td, tc = lmk.lm_solve_torch(H, g, None, None, free, lam, red)
        torch.cuda.synchronize()
        errs[D] = dict(
            dx=float((kd - td).abs().max() / td.abs().max().clamp(
                min=1e-30)),
            cand=max(float((a - b).abs().max())
                     for a, b in zip(kc, tc) if a is not None))
    sys150 = lm_solve_system(150)
    f = sys150["free"]
    sys150["H"][np.ix_(f, f)] *= -1.0
    H, g, free, lam, red = lm_solve_operands(sys150, device)
    kd, kc = lmk.lm_solve(H, g, None, None, free, lam, red)
    td, tc = lmk.lm_solve_torch(H, g, None, None, free, lam, red)
    torch.cuda.synchronize()
    non_pd = dict(
        kernel_step_zero=bool((kd == 0).all()),
        twin_step_zero=bool((td == 0).all()),
        kernel_cand_equal=all(bool((a == b).all()) for a, b in zip(kc, red)
                              if a is not None))
    H, g, free, lam, red = lm_solve_operands(lm_solve_system(150), device)
    S = H + torch.eye(150, dtype=H.dtype, device=H.device)
    e = max(max(v["dx"] for v in errs.values()),
            max(v["cand"] for v in errs.values()))
    return dict(name="lm_solve@seeded", max_abs_err=e,
                ok=all(v["dx"] <= LM_SOLVE_TOL and v["cand"] <= LM_CAND_TOL
                       for v in errs.values()) and all(non_pd.values()),
                errs=errs, non_pd=non_pd, D=150,
                **_solve_times(H, g, None, None, free, lam, red, S),
                bytes=8 * (150 * 150 + 150) + 150 + 4 + 4 * 150
                + 2 * nbytes(*(v for v in red if v is not None)),
                ops=150 ** 3 // 3 + 8 * 150 * 150 + 300 * red.pose.shape[0])


def run_lm(device, win: LmWindows | None = None) -> list[dict]:
    """K22a / K22b / K22c against their twins on a VI local BA window, a
    generic local BA window and that window tiled past 16 and 33 slots
    (``lm_window``'s small run when none is given); K22c also on the
    seeded systems (``check_lm_solve_seeded``)."""
    problems = lm_problems(win if win is not None else lm_window(device))
    return [*(r for tag in ("vi", "lba", "lba_x2", "lba_x4")
              for r in check_lm_reproj(problems, tag)),
            *check_lm_inertial(problems),
            check_lm_solve(problems),
            check_lm_solve(problems, ("lba", "lba_x4")),
            check_lm_solve_seeded(device)]


# ---------------------------------------------------------------------------
# K23: the room pair analysis; K24: plane association
# ---------------------------------------------------------------------------

ROOM_CENTER_TOL = 1e-6  # m, room centres: the same rounded operations
# plane coefficients, centroids, support, votes and observation confidences:
# the chart's atan2f / sinf / cosf differ from the CPU's libm in the last
# ulps, and the blends round in another order
ASSOC_TOL = 1e-5
ROOM_INT_FIELDS = ("room_walls", "room_is_corridor", "room_valid",
                   "room_ground", "n_rooms")
ASSOC_INT_FIELDS = ("pl_valid", "pl_nobs", "n_planes", "pl_vox", "ob_kf",
                    "ob_plane", "ob_valid", "n_obs")
ASSOC_FLOAT_FIELDS = ("pl_coeffs", "pl_centroid", "pl_npts", "pl_votes",
                      "ob_coeffs", "ob_conf", "ob_quadric")
GROUND, WALL, CEILING = 0, 1, 2


def _sg_numpy(P: int = 64, R: int = 16, Q: int = 1024, V: int = 512) -> dict:
    """An empty scene-graph state as numpy (the main path's capacities)."""
    from visual_sgraphs_tpu_torch.config import CapacityConfig
    from visual_sgraphs_tpu_torch.scenegraph.state import empty_scenegraph
    sg = empty_scenegraph(CapacityConfig(max_planes=P, plane_vox_slots=V,
                                         max_rooms=R), max_obs=Q,
                          device="cpu")
    return {k: v.numpy().copy() for k, v in sg._asdict().items()}


def _plane(d: dict, p: int, normal, point, cls: int, npts: float,
           votes: float = 5.0) -> None:
    """Plane ``p`` through ``point`` with ``normal``, of class ``cls``."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    d["pl_coeffs"][p] = [*n, -n @ np.asarray(point, np.float64)]
    d["pl_centroid"][p] = point
    d["pl_valid"][p] = True
    d["pl_npts"][p] = npts
    d["pl_votes"][p] = 0.0
    d["pl_votes"][p, cls] = votes
    d["n_planes"] = np.asarray(max(int(d["n_planes"]), p + 1), np.int32)


def _room(d: dict, r: int, center, walls, corridor: bool = False,
          valid: bool = True, ground: int = -1) -> None:
    d["room_center"][r] = center
    d["room_walls"][r] = walls
    d["room_is_corridor"][r] = corridor
    d["room_valid"][r] = valid
    d["room_ground"][r] = ground
    d["n_rooms"] = np.asarray(max(int(d["n_rooms"]), r + 1), np.int32)


def _box_room(d: dict) -> None:
    """Walls of a 4 x 5 m room, each side in two segments of equal
    support along x (four facing x pairs of one support, the lowest flat
    index (0, 1) first), a y pair, two grounds of equal support, an
    undecided wall and ceiling planes filling the table."""
    rng = np.random.default_rng(3)
    for p, (n, pt, npts) in enumerate((
            ((1, 0, 0), (0, 1, 1.2), 100), ((-1, 0, 0), (4, 1, 1.2), 100),
            ((1, 0, 0), (0, 3.5, 1.2), 100),
            ((-1, 0, 0), (4, 3.5, 1.2), 100),
            ((0, 1, 0), (2, 0, 1.2), 80), ((0, -1, 0), (2, 5, 1.2), 80))):
        _plane(d, p, n, pt, WALL, npts)
    _plane(d, 6, (0, 0, 1), (2, 2.5, 0), GROUND, 50)
    _plane(d, 7, (0, 0, 1), (1, 1, 0), GROUND, 50)
    _plane(d, 8, (0, 1, 0), (2, 2, 1.2), WALL, 500, votes=2.0)
    for p in range(9, 24):
        _plane(d, p, rng.normal(size=3), rng.uniform(-6, 6, 3), CEILING,
               float(rng.integers(10, 300)))


def room_cases() -> list[dict]:
    """Seeded scene graphs for K23 and its twin (the CPU test holds the twin
    against the reference on the same cases): name, kind ("walls" or
    "freespace"), the state as numpy and, for "freespace", the cluster
    centres, their validity and ``wall_dist``.

    walls: equal supports (the lowest flat pair index wins) with a room, a
    corridor and tied grounds; a corridor on wall 0, which its -1 walls'
    scatter leaves free for the next round; a full room table (16 rooms),
    where a match updates its room and a new candidate takes no slot; a
    match by distance (1.5 m) against one by two shared walls, and an
    invalid room that would match both.  freespace: an invalid cluster
    beside a valid one; two clusters that compete for one wall pair, a
    third room and a candidate equidistant from two rooms."""
    cases = []
    d = _sg_numpy()
    _box_room(d)
    cases.append(dict(name="support_ties", kind="walls", sg=d))

    d = _sg_numpy()
    _plane(d, 0, (1, 0, 0), (0, 0, 1), WALL, 300)
    _plane(d, 1, (-1, 0, 0), (3, 0, 1), WALL, 300)
    _plane(d, 2, (-1, 0, 0), (9, 0, 1), WALL, 100)
    cases.append(dict(name="corridor_wall0", kind="walls", sg=d))

    d = _sg_numpy()
    _box_room(d)
    for r in range(16):
        _room(d, r, (50.0 + 10 * r, 0, 0), (40 + r, 41 + r, -1, -1), True)
    _room(d, 5, (2.5, 1.75, 1.2), (30, 31, -1, -1), True)
    cases.append(dict(name="full_table", kind="walls", sg=d))

    d = _sg_numpy()
    _box_room(d)
    _room(d, 0, (10.0, 10.0, 1.2), (0, 1, 9, 10))  # two shared walls
    _room(d, 1, (2.5, 2.0, 1.2), (20, 21, -1, -1), True)  # within 1.5 m
    _room(d, 2, (2.0, 1.75, 1.2), (0, 1, 4, 5), valid=False)
    _room(d, 3, (-10.0, 0.0, 0.0), (2, 3, 7, 8))  # the corridor's walls
    cases.append(dict(name="match_distance_vs_walls", kind="walls", sg=d))

    def two_rooms():
        d = _sg_numpy()
        for p, (n, pt, npts) in enumerate((
                ((1, 0, 0), (0, 2, 1.2), 100), ((-1, 0, 0), (4, 2, 1.2), 100),
                ((0, 1, 0), (2, 0, 1.2), 90), ((0, -1, 0), (2, 4, 1.2), 90),
                ((1, 0, 0), (5, 2, 1.2), 120), ((-1, 0, 0), (9, 2, 1.2), 120),
                ((0, 1, 0), (7, 0, 1.2), 70), ((0, -1, 0), (7, 4, 1.2), 70))):
            _plane(d, p, n, pt, WALL, npts)
        _plane(d, 8, (0, 0, 1), (2, 2, 0), GROUND, 200)
        _plane(d, 9, (0, 0, 1), (7, 2, 0), GROUND, 150)
        return d

    f32 = np.float32
    cases.append(dict(
        name="fs_invalid_cluster", kind="freespace", sg=two_rooms(),
        centers=np.asarray([[2, 2, 1.2], [7, 2, 1.2], [0, 0, 0], [0, 0, 0]],
                           f32),
        valid=np.asarray([True, False, False, False]), wall_dist=2.5))
    cases.append(dict(
        name="fs_compete", kind="freespace", sg=two_rooms(),
        centers=np.asarray([[2, 2, 1.2], [2.3, 2.1, 1.2], [7, 2, 1.2],
                            [4.5, 2, 1.2]], f32),
        valid=np.asarray([True, True, True, True]), wall_dist=2.5))
    return cases


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _random_planes(rng, d: dict, lo: int, hi: int) -> None:
    for p in range(lo, hi):
        _plane(d, p, rng.normal(size=3), rng.uniform(-5, 5, 3),
               int(rng.integers(0, 3)), float(rng.integers(50, 300)),
               votes=float(rng.uniform(0, 8)))
        d["pl_nobs"][p] = rng.integers(1, 9)


def _near(rng, coeffs, centroid):
    """A detection of the plane (coeffs, centroid): its normal turned by
    ~0.02 rad, its distance moved by 0.03 m, its centroid by ~0.2 m."""
    n = _unit(coeffs[:3] + 0.02 * rng.normal(size=3))
    c = centroid + 0.2 * rng.normal(size=3)
    return np.asarray([*n, coeffs[3] - 0.03], np.float32), c


def _far(rng, d: dict):
    """A detection no valid table plane is near (normals > 0.5 rad apart
    or centroids > 2 m apart)."""
    ok = d["pl_valid"]
    while True:
        n, c = _unit(rng.normal(size=3)), rng.uniform(-5, 5, 3)
        cos = np.abs(d["pl_coeffs"][ok, :3] @ n)
        dist = np.linalg.norm(d["pl_centroid"][ok] - c, axis=1)
        if not np.any((cos > np.cos(0.5)) & (dist < 2.0)):
            return np.asarray([*n, -n @ c], np.float32), c


def assoc_cases() -> list[dict]:
    """Seeded plane tables and four detections each for K24 and its twin
    (the CPU test holds the twin against the reference on the same
    cases): name, the state as numpy, the detections (coeffs, valid,
    centroid, npts, votes, local, quadric, vox) and the keyframe id.

    same_plane_twice: a new plane detected twice (the second detection
    matches what the first created), a match and an invalid detection;
    full_planes: 64 planes, so unmatched detections get no slot and no
    observation; full_obs: 1024 observations, so nothing is recorded while
    planes still update and allocate; argmin_tie: two identical planes, the
    lower slot wins; two_on_one: two detections of one table plane (the
    second matches the plane the first blended)."""
    cases = []
    for k, name in enumerate(("same_plane_twice", "full_planes", "full_obs",
                              "argmin_tie", "two_on_one")):
        rng = np.random.default_rng(100 + k)
        d = _sg_numpy()
        P, V = d["pl_vox"].shape
        Q = d["ob_kf"].shape[0]
        _random_planes(rng, d, 0, P if name == "full_planes" else 10)
        d["pl_vox"] = np.where(rng.random((P, V)) < 0.5, -1, rng.integers(
            0, 2 ** 30, (P, V))).astype(np.int32)
        n_obs = Q if name == "full_obs" else 20
        d["ob_kf"][:n_obs] = rng.integers(0, 128, n_obs)
        d["ob_plane"][:n_obs] = rng.integers(0, 10, n_obs)
        d["ob_coeffs"][:n_obs] = _unit(rng.normal(size=(n_obs, 4)))
        d["ob_conf"][:n_obs] = rng.random(n_obs)
        d["ob_quadric"][:n_obs] = rng.normal(size=(n_obs, 4, 4))
        d["ob_valid"][:n_obs] = True
        d["n_obs"] = np.asarray(n_obs, np.int32)
        if name == "argmin_tie":
            for f in ("pl_coeffs", "pl_centroid"):
                d[f][7] = d[f][3]
        coeffs = np.zeros((4, 4), np.float32)
        cen = np.zeros((4, 3), np.float32)
        valid = np.ones(4, bool)
        if name == "same_plane_twice":
            coeffs[0], cen[0] = _far(rng, d)
            coeffs[1], cen[1] = _near(rng, coeffs[0], cen[0])
            coeffs[2], cen[2] = _near(rng, d["pl_coeffs"][3],
                                      d["pl_centroid"][3])
            coeffs[3], cen[3] = _near(rng, d["pl_coeffs"][5],
                                      d["pl_centroid"][5])
            valid[3] = False
        elif name == "two_on_one":
            coeffs[0], cen[0] = _near(rng, d["pl_coeffs"][3],
                                      d["pl_centroid"][3])
            coeffs[1], cen[1] = _near(rng, d["pl_coeffs"][3],
                                      d["pl_centroid"][3])
            coeffs[2], cen[2] = _near(rng, d["pl_coeffs"][5],
                                      d["pl_centroid"][5])
            coeffs[3], cen[3] = _far(rng, d)
        else:
            coeffs[0], cen[0] = _near(rng, d["pl_coeffs"][3],
                                      d["pl_centroid"][3])
            coeffs[1], cen[1] = _far(rng, d)
            coeffs[2], cen[2] = _far(rng, d)
            coeffs[3], cen[3] = _near(rng, d["pl_coeffs"][7],
                                      d["pl_centroid"][7])
        det = dict(
            coeffs=coeffs, valid=valid, centroid=cen,
            npts=rng.integers(20, 400, 4).astype(np.float32),
            votes=rng.uniform(0, 50, (4, 3)).astype(np.float32),
            local=_unit(rng.normal(size=(4, 4))).astype(np.float32),
            quadric=rng.normal(size=(4, 4, 4)).astype(np.float32),
            vox=np.where(rng.random((4, V)) < 0.7, -1, rng.integers(
                0, 2 ** 30, (4, V))).astype(np.int32))
        cases.append(dict(name=name, sg=d, det=det, kf=int(rng.integers(
            0, 128))))
    return cases


def _state(d: dict, device):
    from visual_sgraphs_tpu_torch import interop
    return interop.scenegraph_from_numpy(d, device)


def _state_errs(a, b, ints, floats) -> tuple[list, float]:
    """(int / bool fields of ``a`` and ``b`` that differ, the largest
    absolute difference of the float fields)."""
    bad = [k for k in ints
           if not torch.equal(getattr(a, k), getattr(b, k))]
    err = max(float((getattr(a, k) - getattr(b, k)).abs().max())
              for k in floats)
    return bad, err


def _rooms_call(kind: str, fn_kernel: bool):
    from visual_sgraphs_tpu_torch.scenegraph import freespace as fs
    from visual_sgraphs_tpu_torch.scenegraph import manager as sgm
    if kind == "walls":
        return sgm.detect_rooms if fn_kernel else sgm.detect_rooms_torch
    return (fs.detect_rooms_freespace if fn_kernel
            else fs.detect_rooms_freespace_torch)


def check_rooms(device, sg, kind: str = "walls", centers=None, valid=None,
                wall_dist: float = 4.0, name: str | None = None,
                cases: list | None = None, min_votes: float = 3.0) -> dict:
    """K23's ``kind`` entry ("walls": ``detect_rooms``, 3 rounds;
    "freespace": ``detect_rooms_freespace`` on ``centers`` / ``valid``)
    against its twin on ``sg``: room walls, flags, ground ids and count
    exactly equal, centres within ROOM_CENTER_TOL; also on each of
    ``cases`` (``room_cases()`` entries of this kind), if given.  Times are
    those on ``sg``; the eager operations of one twin call (what a call of
    the kernel replaces) are counted with ``torch.profiler``."""
    kern, twin = _rooms_call(kind, True), _rooms_call(kind, False)
    args = () if kind == "walls" else (centers, valid)
    kw = dict(min_votes=min_votes)
    if kind != "walls":
        kw.update(wall_dist=wall_dist)
    runs = [("main", sg, args, kw)] + [
        (c["name"], _state(c["sg"], device),
         () if kind == "walls" else (
             torch.from_numpy(c["centers"]).to(device),
             torch.from_numpy(c["valid"]).to(device)),
         {} if kind == "walls" else dict(wall_dist=c["wall_dist"]))
        for c in cases or ()]
    per_case, ok, err = {}, True, 0.0
    for tag, s, a, k in runs:
        out_k, out_t = kern(s, *a, **k), twin(s, *a, **k)
        torch.cuda.synchronize()
        bad, e = _state_errs(out_k, out_t, ROOM_INT_FIELDS, ("room_center",))
        per_case[tag] = dict(bad=bad, err=e, n_rooms=int(out_t.n_rooms),
                             walls=out_t.room_walls[out_t.room_valid]
                             .tolist())
        ok = ok and not bad and e <= ROOM_CENTER_TOL
        err = max(err, e)
    P, R = sg.P, sg.room_valid.shape[0]
    rounds = 3 if kind == "walls" else centers.shape[0]
    planes = (sg.pl_coeffs, sg.pl_valid, sg.pl_centroid, sg.pl_npts,
              sg.pl_votes)
    rooms = (sg.room_center, sg.room_walls, sg.room_is_corridor,
             sg.room_valid, sg.room_ground, sg.n_rooms)
    return dict(name=name or f"rooms_{kind}", max_abs_err=err, ok=ok,
                cases=per_case,
                **_timed(lambda: kern(sg, *args, **kw)),
                plain_ms=time_cuda(lambda: twin(sg, *args, **kw)),
                twin_profile=device_ops(lambda: twin(sg, *args, **kw)),
                kernel_profile=device_ops(lambda: kern(sg, *args, **kw)),
                # the plane and room tables read, the room table written
                bytes=nbytes(*planes, *args) + 2 * nbytes(*rooms),
                # per ordered pair: geometry (~40, once), two scores a
                # round (~14); per round: P ground and R room tests (~20)
                ops=P * P * (40 + 14 * rounds) + rounds * 20 * (P + R),
                library_ms=None)


def assoc_operands(case: dict, device):
    """(state, detections, kf_id) of an ``assoc_cases()`` entry."""
    det = case["det"]
    dets = tuple(torch.from_numpy(det[k]).to(device)
                 for k in ("coeffs", "valid", "centroid", "npts", "votes",
                           "local", "quadric", "vox"))
    return _state(case["sg"], device), dets, case["kf"]


def check_plane_assoc(device, sg, dets, kf: int, name: str = "plane_assoc",
                      cases: list | None = None, ominus_thresh: float = 0.3,
                      dist_thresh: float = 0.35) -> dict:
    """K24 (``associate_and_update``) against its twin on ``sg`` with the
    detections ``dets`` (coeffs, valid, centroid, npts, votes, local,
    quadric, vox) of keyframe ``kf``: the integer and bool fields exactly
    equal, the float fields within ASSOC_TOL, every table bitwise equal
    from launch to launch; also on each of ``cases`` (``assoc_cases()``
    entries), if given; one device operation a call on ``sg``
    (``graph_ops``).  Times are those on ``sg``."""
    from visual_sgraphs_tpu_torch.scenegraph import manager as sgm

    def call(fn, s, d, k):
        return fn(s, *d[:6], k, det_quadric=d[6], det_vox=d[7],
                  ominus_thresh=ominus_thresh, dist_thresh=dist_thresh)

    runs = [("main", sg, dets, kf)] + [
        (c["name"], *assoc_operands(c, device)) for c in cases or ()]
    per_case, ok, err = {}, True, 0.0
    for tag, s, d, k in runs:
        out_k = call(sgm.associate_and_update, s, d, k)
        out_t = call(sgm.associate_and_update_torch, s, d, k)
        again = [call(sgm.associate_and_update, s, d, k) for _ in range(2)]
        torch.cuda.synchronize()
        bad, e = _state_errs(out_k, out_t, ASSOC_INT_FIELDS,
                             ASSOC_FLOAT_FIELDS)
        repro = all(torch.equal(getattr(out_k, f), getattr(a, f))
                    for a in again for f in sgm._ASSOC_TABLES)
        per_case[tag] = dict(bad=bad, err=e, bitwise_repro=repro,
                             n_planes=int(out_t.n_planes),
                             n_obs=int(out_t.n_obs),
                             new_obs=int(out_t.n_obs - s.n_obs))
        ok = ok and not bad and e <= ASSOC_TOL and repro
        err = max(err, e)
    ops = graph_ops(lambda: call(sgm.associate_and_update, sg, dets, kf))
    ok = ok and ops == 1
    n_det = dets[0].shape[0]
    P, V = sg.pl_vox.shape
    tables = [getattr(sg, k) for k in sgm._ASSOC_TABLES]
    return dict(name=name, max_abs_err=err, ok=ok, cases=per_case,
                device_ops=ops,
                **_timed(lambda: call(sgm.associate_and_update, sg,
                                      dets, kf)),
                plain_ms=time_cuda(lambda: call(
                    sgm.associate_and_update_torch, sg, dets, kf)),
                twin_profile=device_ops(lambda: call(
                    sgm.associate_and_update_torch, sg, dets, kf)),
                kernel_profile=device_ops(lambda: call(
                    sgm.associate_and_update, sg, dets, kf)),
                # the tables read and written anew, the detections read
                bytes=2 * nbytes(*tables) + nbytes(*dets),
                # per detection and plane: the chart distance (~150 with
                # two atan2 and four sin / cos); per detection: the blend
                # (~300) and the voxel row (V compares)
                ops=n_det * (150 * P + 300 + V), library_ms=None)


def device_ops(fn) -> dict:
    """The device operations (kernels, copies, fills) one call of ``fn``
    runs and their device time in ms, from ``torch.profiler``: the CUDA
    events of ``time_cuda`` also hold the host's time to launch them when
    the device idles."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(ops=sum(e.count for e in events),
                device_ms=sum(e.device_time_total for e in events) / 1e3)


def graph_ops(fn) -> int:
    """The device operations (kernels, copies, fills) one call of ``fn``
    enqueues, counted exactly as the nodes of a CUDA graph captured from
    it: ``device_ops``' profiler can lose the launches of the ctypes
    kernels late in a long process and read 0.  ``fn`` is called once
    before the capture, so that nothing loads inside it."""
    fn()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    del graph
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {rc}")
    return n.value


@contextlib.contextmanager
def watch_assoc(which: int = 8):
    """Inside the block, record the operands of the ``which``-th call of
    ``associate_and_update`` (the last one if fewer ran): a copy of the
    state, the detections and the keyframe id.  The copies cost device
    time: watch a run that is not timed."""
    from visual_sgraphs_tpu_torch.scenegraph import manager as sgm
    out = {"calls": 0}
    orig = sgm.associate_and_update

    def spy(sg, *args, **kw):
        # args: the six detection tensors and the keyframe id
        out["calls"] += 1
        if out["calls"] <= which:
            dets = [t.clone() for t in args[:6]] + [
                None if kw.get(k) is None else kw[k].clone()
                for k in ("det_quadric", "det_vox")]
            out["operands"] = (type(sg)(*(t.clone() for t in sg)),
                               tuple(dets), int(args[6]))
        return orig(sg, *args, **kw)

    spy.launches = orig.launches
    sgm.associate_and_update = spy
    try:
        yield out
    finally:
        orig.launches = spy.launches
        sgm.associate_and_update = orig


def run_rooms(device) -> list[dict]:
    """K23's two entries and K24 on their seeded cases (the first case of
    each timed)."""
    walls = [c for c in room_cases() if c["kind"] == "walls"]
    free = [c for c in room_cases() if c["kind"] == "freespace"]
    assoc = assoc_cases()
    fs0 = free[0]
    return [
        check_rooms(device, _state(walls[0]["sg"], device), "walls",
                    name="rooms_walls@cases", cases=walls[1:]),
        check_rooms(device, _state(fs0["sg"], device), "freespace",
                    torch.from_numpy(fs0["centers"]).to(device),
                    torch.from_numpy(fs0["valid"]).to(device),
                    fs0["wall_dist"], name="rooms_freespace@cases",
                    cases=free[1:]),
        check_plane_assoc(device, *assoc_operands(assoc[0], device),
                          name="plane_assoc@cases", cases=assoc[1:])]


def run_loop_seeded(device) -> list[dict]:
    """The loop path's kernels on seeded inputs of its shapes."""
    return [check_bow(device), check_place_query(device),
            check_match_nn(device), check_guided(device),
            check_sim3(device), check_pnp(device), *check_pgo(device),
            *check_schur_gba(device)]


# ---------------------------------------------------------------------------
# K25: the tracking scan's per-frame bookkeeping; K26: the Schur BAs'
# damped solve and retraction
# ---------------------------------------------------------------------------

# K25's poses against its twin, per component: the kernel rounds the
# twin's operations op for op but for the order of |q|^2's four terms
SCAN_POSE_TOL = 2e-7
# K26's step relative to its largest |dx| against the float64 twin (both
# float64 factorisations, in different orders), and its moved values per
# component (float32 retractions of nearly equal steps)
BA_STEP_TOL = 1e-6
BA_VALUE_TOL = 1e-5
LAM_BA = 1e-4  # the Schur BAs' damping
# (L, P, R, Dn) of the three Schur BAs: the windowed local BA (D = 66),
# the scene-graph BA (D = 402) and the global BA at 128 keyframes (D =
# 768, K26's cluster over distributed shared memory) and at the default
# capacity's 256 (D = 1536, the cluster over global scratch)
BA_LAYOUTS = {"lba": (11, 0, 0, 0), "sg": (11, 64, 16, 16),
              "gba": (128, 0, 0, 0), "gba256": (256, 0, 0, 0)}


def _random_poses(rng, n: int, spread: float = 1.0) -> np.ndarray:
    xi = np.concatenate([rng.normal(size=(n, 3)) * spread,
                         rng.normal(size=(n, 3)) * 0.5], axis=1)
    return lie.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()


def scan_epilogue_inputs(device, retry: bool, accept: bool = True,
                         N: int = 4096, F: int = 1000, seed: int = 0):
    """Seeded operands of K25 at the scan's shapes (4096 local ids, 1000
    keypoint slots): two attempts (matched flags ~30 %, slots with
    repeats, visible ids, the solves' inliers and poses), the table's ids
    (ascending, -1 padded), the reference keyframe's pose, a state and
    ``min_inliers`` chosen between the attempts' kept counts so that the
    retry is taken or not, and the chosen attempt accepted or not.
    Returns (a1, a2, table, kf_base, min_inliers, state, F)."""
    from visual_sgraphs_tpu_torch.features.match import TrackPass
    rng = np.random.default_rng(seed)
    n_pts = int(0.9 * N)
    ids = np.full(N, -1, np.int32)
    ids[:n_pts] = np.sort(rng.choice(32768, n_pts, replace=False))
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa

    def attempt(p_ok):
        ok = (rng.uniform(size=N) < p_ok) & (ids >= 0)
        slot = np.where(ok, rng.integers(0, F, N), 0).astype(np.int64)
        vis = np.where(rng.uniform(size=N) < 0.6, ids, -1).astype(np.int32)
        inl = rng.uniform(size=N) < 0.8
        fine = TrackPass(uv_pred=None, vis=None, vis_pt=f(vis), match=None,
                         dist=None, ok=f(ok), slot=f(slot), uv_m=None,
                         depth_m=None,
                         n_match=torch.tensor(int(ok.sum()),
                                              dtype=torch.int32,
                                              device=device))
        return tracking.Attempt(pose=f(_random_poses(rng, 1)[0]), fine=fine,
                                inliers=f(inl)), int((ok & inl).sum())

    a1, k1 = attempt(0.15)
    a2, k2 = attempt(0.35)
    # the retry replaces a short first attempt; either result may still
    # fall short of the floor
    if retry:
        min_inliers = k2 if accept else k2 + 1
    else:
        min_inliers = k1 if accept else k1 + 1
        if not accept:
            raise ValueError("a first attempt below the floor retries")
    table = tracking.LocalTable(ids=f(ids), valid=f(ids >= 0), xw=None,
                                n_pts=torch.tensor(n_pts, dtype=torch.int32,
                                                   device=device))
    state = f(_random_poses(rng, 3).reshape(3, 7))
    return (a1, a2, table, f(_random_poses(rng, 1)[0]), min_inliers, state,
            F)


SCAN_CASES = (("retry_accepted", True, True),
              ("first_accepted", False, True),
              ("retry_rejected", True, False))


def _scan_run(fn, ops, B: int = 2, i: int = 1):
    """Fresh B-frame outputs (every row poisoned) after one ``fn`` (K25 or
    its twin) call on the operands ``ops`` (a1, a2, table, kf_base,
    min_inliers, state, F) at row ``i``."""
    a1, a2, table, kf_base, min_inliers, state, F = ops
    out = tracking.scan_outputs(B, F, table.ids.shape[0], kf_base.device)
    for t in out.results + (out.T_rels, out.packeds):
        t.fill_(-7)
    out.state.copy_(state)
    fn(a1, a2, table, kf_base, min_inliers, i, out)
    return out


def _scan_errors(k, t) -> dict:
    """Integer fields' equality and float fields' largest difference of
    two scan outputs."""
    ints = all(torch.equal(x, y) for x, y in zip(
        (k.results.slot_pt, k.results.vis_pt, k.results.n_matches,
         k.results.n_inliers, k.results.n_local_pts, k.packeds),
        (t.results.slot_pt, t.results.vis_pt, t.results.n_matches,
         t.results.n_inliers, t.results.n_local_pts, t.packeds)))
    err = max(float((x - y).abs().max()) for x, y in (
        (k.results.pose, t.results.pose), (k.T_rels, t.T_rels),
        (k.state, t.state)))
    return dict(ints_equal=ints, max_abs_err=err)


def _scan_work(table, F: int) -> tuple[int, int]:
    """(bytes, operations) of a K25 frame: both attempts' match flags and
    inlier masks (both keep counts), the chosen attempt's slots, visible
    ids, count and pose, the table's ids, its size, the keyframe pose and
    T_prev read once; the row's slot_pt, vis_pt, counts, pose, T_rel,
    packed row and the state written once; per table entry and attempt a
    test and an add, per kept entry a max, ~300 pose flops."""
    N = table.ids.shape[0]
    read = 2 * N * (1 + 1) + N * (8 + 4) + 4 + 28 + 4 * N + 4 + 28 + 28
    write = 4 * F + 4 * N + 12 + 28 + 28 + 16 + 84
    return read + write, 4 * N + N + 300


def check_scan_epilogue(device, operands=None, name: str = "scan_epilogue",
                        cases=SCAN_CASES) -> list[dict]:
    """K25's frame entry against its twin: on seeded operands with the
    retry taken and accepted, not taken, and taken but rejected (or on
    recorded ``operands``): integers, decisions and the packed row exact,
    poses (the row's pose, T_rel, the next state) within SCAN_POSE_TOL;
    bitwise from launch to launch; one device operation a call (CUDA-graph
    nodes).  Timed on the first case against the twin."""
    runs = ([(name, operands)] if operands is not None else
            [(f"{name}@{c}", scan_epilogue_inputs(device, r, a))
             for c, r, a in cases])
    out = []
    for tag, ops in runs:
        k = _scan_run(tracking.scan_epilogue, ops)
        t = _scan_run(tracking.scan_epilogue_torch, ops)
        torch.cuda.synchronize()
        errs = _scan_errors(k, t)
        again = [_scan_run(tracking.scan_epilogue, ops) for _ in range(3)]
        repro = all(torch.equal(x, y) for o in again
                    for x, y in zip((*k.results, k.T_rels, k.packeds,
                                     k.state),
                                    (*o.results, o.T_rels, o.packeds,
                                     o.state)))
        work_bytes, work_ops = _scan_work(ops[2], ops[6])
        out.append(dict(name=tag, **errs, bitwise_repro=repro,
                        retried=bool(k.packeds[1, 3] > 0),
                        n_inliers=int(k.results.n_inliers[1]),
                        min_inliers=ops[4], ms=None, plain_ms=None,
                        library_ms=None, bytes=work_bytes, ops=work_ops,
                        ok=errs["ints_equal"] and repro
                        and errs["max_abs_err"] <= SCAN_POSE_TOL))
    a1, a2, table, kf_base, min_inl, state, F = runs[0][1]
    res = tracking.scan_outputs(2, F, table.ids.shape[0], device)
    res.state.copy_(state)

    def kernel():
        tracking.scan_epilogue(a1, a2, table, kf_base, min_inl, 1, res)

    def twin():
        tracking.scan_epilogue_torch(a1, a2, table, kf_base, min_inl, 1, res)

    first = out[0]
    first.update(ms=time_cuda(kernel), device_ms=device_time(kernel),
                 plain_ms=time_cuda(twin), plain_device_ms=device_time(twin),
                 graph_ops=graph_ops(kernel),
                 plain_device_ops=device_ops(twin)["ops"], library_ms=None)
    first["ok"] = first["ok"] and first["graph_ops"] == 1
    return out


def check_scan_prologue(device, seed: int = 0) -> dict:
    """K25's first-frame entry against its twin on seeded poses: the state
    within SCAN_POSE_TOL, the copies exact; bitwise from launch to launch."""
    rng = np.random.default_rng(seed)
    T, v = (torch.from_numpy(x).to(device) for x in _random_poses(rng, 2))
    k = torch.empty((3, 7), dtype=torch.float32, device=device)
    t = torch.empty_like(k)
    tracking.scan_prologue(T, v, k)
    tracking.scan_prologue_torch(T, v, t)
    torch.cuda.synchronize()
    err = float((k - t).abs().max())
    again = torch.empty_like(k)
    tracking.scan_prologue(T, v, again)
    fn = lambda: tracking.scan_prologue(T, v, again)  # noqa: E731
    return dict(name="scan_prologue", max_abs_err=err,
                copies_exact=bool(torch.equal(k[1:], t[1:])),
                bitwise_repro=bool(torch.equal(k, again)),
                ok=err <= SCAN_POSE_TOL and bool(torch.equal(k[1:], t[1:]))
                and bool(torch.equal(k, again)),
                ms=time_cuda(fn), device_ms=device_time(fn),
                plain_ms=time_cuda(lambda: tracking.scan_prologue_torch(
                    T, v, again)), library_ms=None, bytes=4 * (7 + 7 + 21),
                ops=120)


def check_inlier_tail(device, operands=None,
                      name: str = "inlier_tail") -> dict:
    """K25's tail entry against its twin on each seeded attempt (or on
    ``operands`` (attempt, table, F)), with and without the retry flag:
    every output exact, bitwise from launch to launch."""
    if operands is None:
        a1, a2, table, *_, F = scan_epilogue_inputs(device, True)
        runs = [(a1, table, False), (a2, table, True)]
    else:
        a1, table, F = operands
        runs = [(a1, table, False)]
    exact = True
    for a, tab, retried in runs:
        k = tracking.inlier_tail(a, tab, F, retried)
        t = tracking.inlier_tail_torch(a, tab, F, retried)
        again = tracking.inlier_tail(a, tab, F, retried)
        exact = exact and all(torch.equal(x, y) for x, y in zip(k, t)) \
            and all(torch.equal(x, y) for x, y in zip(k, again))
    a, tab, retried = runs[0]
    kernel = lambda: tracking.inlier_tail(a, tab, F, retried)  # noqa: E731
    N = tab.ids.shape[0]
    return dict(name=name, max_abs_err=0.0 if exact else float("inf"),
                exact=exact, ok=exact, ms=time_cuda(kernel),
                device_ms=device_time(kernel), graph_ops=graph_ops(kernel),
                plain_ms=time_cuda(lambda: tracking.inlier_tail_torch(
                    a, tab, F, retried)), library_ms=None,
                bytes=N * (1 + 8 + 1 + 4) + 8 + 4 * F + 4 + 16, ops=3 * N)


@contextlib.contextmanager
def watch_scan(which: int = 40):
    """Inside the block, record the operands of the ``which``-th K25 frame
    of the scans (the last one if fewer ran) as copies: (a1, a2, table,
    kf_base, min_inliers, state before the frame, keypoint slots).  The
    copies cost device time: watch a run that is not timed."""
    from visual_sgraphs_tpu_torch.features.match import TrackPass
    out = {"calls": 0}
    orig = tracking.scan_epilogue

    def copy_attempt(a):
        fine = TrackPass(*(None if x is None else x.clone()
                           for x in a.fine))
        return tracking.Attempt(a.pose.clone(), fine, a.inliers.clone())

    def spy(a1, a2, table, kf_base, min_inliers, i, res):
        out["calls"] += 1
        if out["calls"] <= which:
            tab = tracking.LocalTable(table.ids.clone(), table.valid.clone(),
                                      None, table.n_pts.clone())
            out["operands"] = (copy_attempt(a1), copy_attempt(a2), tab,
                               kf_base.clone(), int(min_inliers),
                               res.state.clone(),
                               res.results.slot_pt.shape[1])
        return orig(a1, a2, table, kf_base, min_inliers, i, res)

    spy.launches = orig.launches
    tracking.scan_epilogue = spy
    try:
        yield out
    finally:
        tracking.scan_epilogue = orig


def ba_solve_inputs(device, layout: str = "sg", seed: int = 0,
                    pd: bool = True) -> tuple:
    """Seeded operands of K26 for one of BA_LAYOUTS: a symmetric positive
    definite float32 S (a Gram matrix plus a diagonal spanning ~1e-2 to
    1e4, as a reduced camera system's), rhs (LM-sized steps), the gauge
    mask (keyframe 0
    and every fourth keyframe fixed; on the scene-graph layout every fifth
    plane, the first room and door fixed), unit-quaternion poses and
    doors, unit-normal planes, rooms; ``pd`` False negates the free
    block's diagonal (not positive definite).  Returns (S, rhs, free,
    lam, poses, planes, rooms, doors)."""
    L, P, R, Dn = BA_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    D = 6 * L + 3 * P + 3 * R + 6 * Dn
    A = rng.normal(size=(D, D // 2)) / math.sqrt(D)
    S = A @ A.T + np.diag(10.0 ** rng.uniform(-2, 4, D))
    fixed_kf = np.arange(L) % 4 == 0
    free = np.concatenate([
        np.repeat(~fixed_kf, 6), np.repeat(np.arange(P) % 5 != 0, 3),
        np.repeat(np.arange(R) != 0, 3), np.repeat(np.arange(Dn) != 0, 6)])
    if not pd:
        S[free, free] *= -1.0
    S = S.astype(np.float32)
    S = (S + S.T) / np.float32(2.0)
    # LM-sized steps: rhs = S x for x of 1e-4 to 1e-1 an entry
    rhs = S.astype(np.float64) @ (rng.normal(size=D)
                                  * 10.0 ** rng.uniform(-4, -1, D))
    n = rng.normal(size=(P, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    f = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, dtype=np.float32)).to(device)
    opt = lambda x, k: f(x) if k else None  # noqa: E731
    return (f(S), f(rhs), f(free), LAM_BA, f(_random_poses(rng, L, 3.0)),
            opt(np.concatenate([n, rng.uniform(-4, 4, (P, 1))], 1), P),
            opt(rng.uniform(-5, 5, (R, 3)), R),
            opt(_random_poses(rng, Dn, 3.0), Dn))


def _ba_work(S, n_values: int) -> tuple[int, int]:
    """(bytes, operations) of K26 on a D x D system: S's lower triangle
    (the only part either path reads), rhs and the mask read once, the
    values read and their moved copies and the step written once; the
    Cholesky's D^3 / 3 flops, the two triangular solves' 2 D^2 and ~300
    flops a moved variable."""
    D = S.shape[0]
    return 4 * (D * (D + 1) // 2 + 3 * D) + 8 * n_values, \
        D ** 3 // 3 + 2 * D * D + 300 * n_values // 7


def _ba_twin64(S, rhs, free, lam, *values):
    """K26's twin on the float64 system (as the kernel factors) and the
    float32 values."""
    return dist_ba.ba_solve_torch(S.double(), rhs.double(), free.double(),
                                  lam, *values)


def check_ba_solve(device, operands=None, name: str = "ba_solve") -> dict:
    """K26 against its float64 twin on ``operands`` (S, rhs, free, lam,
    poses, planes, rooms, doors): the step within BA_STEP_TOL of the
    largest |dx|, the moved values within BA_VALUE_TOL; bitwise from
    launch to launch; one device operation a call.  Timed against the
    float32 twin (the plain solve and retraction) and the library's
    ``cholesky_ex`` + ``cholesky_solve`` of the damped, masked float32
    system."""
    ops = operands
    k = dist_ba.ba_solve(*ops)
    t = _ba_twin64(*ops)
    torch.cuda.synchronize()
    dx_err = _rel(k[0].double(), t[0].double())
    val_err = max([float((a - b).abs().max()) for a, b in zip(k[1:], t[1:])
                   if a is not None and a.numel()] or [0.0])
    again = [dist_ba.ba_solve(*ops) for _ in range(3)]
    repro = all(torch.equal(x, y) for o in again for x, y in zip(k, o)
                if x is not None)
    S, rhs, free, lam = ops[:4]
    Sd = S + torch.diag(lam * torch.clamp(torch.diagonal(S), min=1e-6)
                        + 1e-5)
    Sd = Sd * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    b = (rhs * free)[:, None]

    def library():
        Ls, _ = torch.linalg.cholesky_ex(Sd)
        return torch.cholesky_solve(b, Ls)

    kernel = lambda: dist_ba.ba_solve(*ops)  # noqa: E731
    plain = lambda: dist_ba.ba_solve_torch(*ops)  # noqa: E731
    n_values = sum(v.numel() for v in ops[4:] if v is not None)
    work_bytes, work_ops = _ba_work(S, n_values)
    g_ops = graph_ops(kernel)
    return dict(name=name, D=S.shape[0], max_abs_err=max(dx_err, val_err),
                dx_rel_err_vs_f64=dx_err, value_err=val_err,
                step_zero=bool((k[0] == 0).all()), bitwise_repro=repro,
                graph_ops=g_ops, ms=time_cuda(kernel),
                device_ms=device_time(kernel), plain_ms=time_cuda(plain),
                plain_device_ops=device_ops(plain)["ops"],
                library_ms=time_cuda(library),
                library_device_ms=device_time(library),
                ok=dx_err <= BA_STEP_TOL and val_err <= BA_VALUE_TOL
                and repro and g_ops == 1,
                bytes=work_bytes, ops=work_ops)


def run_ba_solve(device) -> list[dict]:
    """K26 on the seeded systems of the three Schur BAs (D = 66, 402,
    768 and 1536: each of its three paths), and on the scene-graph system
    made not positive definite, where kernel and twin must both give a
    zero step."""
    out = [check_ba_solve(device, ba_solve_inputs(device, lay),
                          f"ba_solve@{lay}") for lay in BA_LAYOUTS]
    bad = check_ba_solve(device, ba_solve_inputs(device, "sg", pd=False),
                         "ba_solve@not_pd")
    twin = _ba_twin64(*ba_solve_inputs(device, "sg", pd=False))
    bad["twin_step_zero"] = bool((twin[0] == 0).all())
    bad["ok"] = bad["ok"] and bad["step_zero"] and bad["twin_step_zero"]
    out[1]["name"] = "ba_solve"  # the scene-graph BA's: the JSON line's row
    return out + [bad]


@contextlib.contextmanager
def watch_ba_solve(which: int = 17):
    """Inside the block, record the operands of the ``which``-th K26 call
    of ``fast_scenegraph_ba`` (the last one if fewer ran) as copies: (S,
    rhs, free, lam, poses, planes, rooms, doors).  The copies cost device
    time: watch a run that is not timed."""
    from visual_sgraphs_tpu_torch.optim import fast_ba
    out = {"calls": 0}
    orig = fast_ba.ba_solve

    def spy(S, rhs, free, lam, *values):
        out["calls"] += 1
        if out["calls"] <= which:
            out["operands"] = (S.clone(), rhs.clone(), free.clone(), lam,
                               *(None if v is None else v.clone()
                                 for v in values))
        return orig(S, rhs, free, lam, *values)

    spy.launches = orig.launches
    fast_ba.ba_solve = spy
    try:
        yield out
    finally:
        fast_ba.ba_solve = orig


# ---------------------------------------------------------------------------
# K27-K29: the keyframe program's map maintenance (slam/mapping.py)

# pt_pos, kf_pose and led_T_cp per component, kernel against twin: the
# back-projection and T_cp round op for op as the torch chain on the card
# (lie_rn.cuh), so they are expected bitwise; stated at the CPU tests' 1e-5
MAINT_TOL = 1e-5
MAINT_CAM = np.array([260.0, 260.0, 320.0, 240.0], np.float32)
# the cells' capacities: K, F, N, E (the default ledger), the local tables
MAINT_SHAPES = dict(K=128, F=1000, N=32768, E=4096, V=4096)
MAINT_MIN_INLIERS = 30
MAINT_FLOAT_FIELDS = ("kf_pose", "kf_timestamp", "kf_uv", "kf_depth",
                      "kf_angle", "pt_pos", "led_T_cp")


def maint_map_numpy(K: int, F: int, N: int, E: int, seed: int = 0) -> dict:
    """A seeded map of capacity (K, F, N, E) as numpy: ~3/4 of the
    keyframe slots valid (slot 0 always), distinct sequence numbers, each
    valid keyframe's keypoints linked (70 %) to points of a window of the
    valid ids, so that neighbouring keyframes share points, 2 % of the
    links stale; half the points valid, a third young, visible / found
    counts with collapsed ratios among them, freed points inside and past
    their quarantine; the ledger half full."""
    rng = np.random.default_rng(seed)
    n_kf = 3 * K // 2 + 10
    kf_valid = rng.uniform(size=K) < 0.75
    kf_valid[0] = True
    kf_seq = np.full(K, -1, np.int32)
    kf_seq[kf_valid] = np.sort(rng.choice(n_kf, int(kf_valid.sum()),
                                          replace=False))
    pt_valid = rng.uniform(size=N) < 0.5
    ids = np.flatnonzero(pt_valid)
    win = max(len(ids) // 6, 1)
    obs = np.full((K, F), -1, np.int32)
    for r in np.flatnonzero(kf_valid):
        pick = ids[(rng.integers(len(ids)) + rng.integers(0, win, F))
                   % len(ids)]
        pick = np.where(rng.uniform(size=F) < 0.02, rng.integers(0, N, F),
                        pick)
        obs[r] = np.where(rng.uniform(size=F) < 0.7, pick, -1)
    vis = rng.integers(0, 24, N).astype(np.int32)
    young = rng.uniform(size=N) < 0.3
    led_n = E // 2
    led_seq = np.full(E, -1, np.int32)
    led_parent = np.full(E, -1, np.int32)
    led_seq[:led_n] = rng.integers(0, n_kf, led_n)
    led_parent[:led_n] = rng.integers(0, n_kf, led_n)
    led_T = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (E, 1))
    led_T[:led_n] = _random_poses(rng, led_n, 0.3)
    return dict(
        kf_pose=_random_poses(rng, K, 0.5), kf_valid=kf_valid,
        kf_timestamp=np.sort(rng.uniform(0.0, 10.0, K)).astype(np.float32),
        kf_uv=rng.uniform((0, 0), (640, 480), (K, F, 2)).astype(np.float32),
        kf_depth=np.where(rng.uniform(size=(K, F)) < 0.8,
                          rng.uniform(0.5, 6.0, (K, F)), -1.0
                          ).astype(np.float32),
        kf_level=rng.integers(0, 8, (K, F)).astype(np.int32),
        kf_angle=rng.uniform(-np.pi, np.pi, (K, F)).astype(np.float32),
        kf_desc=rng.integers(0, 256, (K, F, 32), dtype=np.uint8),
        kf_kp_valid=rng.uniform(size=(K, F)) < 0.9, kf_obs_pt=obs,
        kf_seq=kf_seq,
        pt_pos=rng.uniform(-5.0, 5.0, (N, 3)).astype(np.float32),
        pt_valid=pt_valid,
        pt_desc=rng.integers(0, 256, (N, 32), dtype=np.uint8),
        pt_first_kf=rng.choice(np.flatnonzero(kf_valid), N).astype(np.int32),
        pt_first_seq=np.where(young, rng.integers(n_kf - 4, n_kf + 1, N),
                              rng.integers(0, n_kf - 4, N)).astype(np.int32),
        pt_freed_seq=np.where(~pt_valid & (rng.uniform(size=N) < 0.5),
                              rng.integers(n_kf - 5, n_kf + 1, N),
                              -10**6).astype(np.int32),
        pt_visible=vis,
        pt_found=(vis * rng.uniform(0.0, 1.0, N)).astype(np.int32),
        led_seq=led_seq, led_parent_seq=led_parent, led_T_cp=led_T,
        led_n=np.int32(led_n), n_kf=np.int32(n_kf),
        n_pt=np.int32(pt_valid.sum()))


def maint_empty_numpy(K: int, F: int, N: int, E: int) -> dict:
    """``empty_map`` at capacity (K, F, N, E) as numpy."""
    from visual_sgraphs_tpu_torch import interop
    from visual_sgraphs_tpu_torch.config import CapacityConfig
    return interop.map_to_numpy(map_state.empty_map(
        CapacityConfig(max_keyframes=K, max_points=N, max_retired=E),
        OrbConfig(n_features=F)))


def maint_tie_numpy(m: dict) -> dict:
    """``m`` with tied cases: keyframes 1-8 valid with keyframe 1's
    observations (its points valid and old), so that keyframe 1's
    covisibility counts tie over 2-8 and 2-8 are equally redundant
    (every point seen by 8); slot 2's sequence s has two valid neighbours
    at s + 1 (slot 3) and s - 1 (slot 9), every other sequence 4 or more
    away (the retirement's parent ties)."""
    m = {k: np.array(v) for k, v in m.items()}
    K = m["kf_valid"].shape[0]
    n_kf = int(m["n_kf"])
    m["kf_valid"][:10] = True
    for r in range(2, 9):
        m["kf_obs_pt"][r] = m["kf_obs_pt"][1]
        m["kf_kp_valid"][r] = m["kf_kp_valid"][1]
    row = m["kf_obs_pt"][1]
    pts = row[row >= 0]
    m["pt_valid"][pts] = True
    m["pt_first_seq"][pts] = 0
    s = n_kf // 2
    others = np.array([v for v in range(n_kf) if abs(v - s) > 3])
    rng = np.random.default_rng(7)
    seq = np.full(K, -1, np.int32)
    valid = np.flatnonzero(m["kf_valid"])
    seq[valid] = rng.choice(others, len(valid), replace=False)
    seq[2], seq[3], seq[9] = s, s + 1, s - 1
    m["kf_seq"] = seq
    m["n_pt"] = np.int32(m["pt_valid"].sum())
    return m


def maint_frame_numpy(m: dict, seed: int = 1) -> dict:
    """A seeded frame for ``m``'s keyframe slots: 92 % of the keypoints
    valid, 80 % with depth (the rest 0 or -1); its pose, slot_pt and
    camera, and a copy of ``m`` with fuse targets.  On a map with points:
    a valid keyframe r0's points split in two halves, 40 % of the
    keypoints with depth matched to the first (so r0 is covisible with the
    inserted keyframe), and up to 16 of the valid keypoints without depth
    (left free by the insertion) made the exact projection, at the pose,
    of a point of the second half, with its descriptor; the next point of
    that half copies the last target (position and descriptor), so two
    points match one keypoint at distance 0 (a repeated slot)."""
    m = {k: np.array(v) for k, v in m.items()}
    rng = np.random.default_rng(seed)
    F = m["kf_obs_pt"].shape[1]
    valid = rng.uniform(size=F) < 0.92
    depth = np.where(rng.uniform(size=F) < 0.8, rng.uniform(0.5, 6.0, F),
                     np.where(rng.uniform(size=F) < 0.5, 0.0, -1.0))
    uv = rng.uniform((0, 0), (640, 480), (F, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    pose = _random_poses(rng, 1, 0.5)[0]
    slot_pt = np.full(F, -1, np.int32)
    obs, pt_valid = m["kf_obs_pt"], m["pt_valid"]
    rows = [r for r in np.flatnonzero(m["kf_valid"])
            if pt_valid[obs[r][obs[r] >= 0]].any()]
    if rows:
        r0 = rows[rng.integers(len(rows))]
        ids = np.unique(obs[r0][obs[r0] >= 0])
        ids = ids[pt_valid[ids]]
        rng.shuffle(ids)
        half = max(len(ids) // 2, 1)
        slot_pt = np.where(valid & (depth > 0) & (rng.uniform(size=F) < 0.4),
                           rng.choice(ids[:half], F), -1).astype(np.int32)
        targets, free_kp = ids[half:], np.flatnonzero(valid & ~(depth > 0))
        n_t = min(16, len(free_kp), len(targets) - 1)
        T_wc = lie.se3_inverse(torch.from_numpy(pose))
        fx, fy, cx, cy = (float(v) for v in MAINT_CAM)
        for j in range(max(n_t, 0)):
            i, q = free_kp[j], targets[j]
            z = rng.uniform(1.0, 4.0)
            u, v = rng.uniform((20, 20), (620, 460)).astype(np.float32)
            p = torch.tensor([(u - cx) * z / fx, (v - cy) * z / fy, z],
                             dtype=torch.float32)
            m["pt_pos"][q] = lie.se3_apply(T_wc, p).numpy()
            uv[i] = (u, v)
            desc[i] = m["pt_desc"][q]
        if n_t >= 1:
            q2, q1 = targets[n_t], targets[n_t - 1]
            m["pt_pos"][q2] = m["pt_pos"][q1]
            m["pt_desc"][q2] = m["pt_desc"][q1]
    frame = dict(uv=uv, depth=depth.astype(np.float32),
                 level=rng.integers(0, 8, F).astype(np.int32),
                 angle=rng.uniform(-np.pi, np.pi, F).astype(np.float32),
                 desc=desc, valid=valid, timestamp=np.float32(12.5))
    return dict(map=m, frame=frame, pose=pose, slot_pt=slot_pt,
                cam=MAINT_CAM.copy())


def maint_stats_numpy(m: dict, rows: int, V: int, seed: int = 2) -> dict:
    """Seeded found (rows, F) and visible (rows, V) id tables of valid
    points (-1 elsewhere, the last quarter of the rows all -1: the
    program's padding) and their packed rows, half of them below
    MAINT_MIN_INLIERS."""
    rng = np.random.default_rng(seed)
    F = m["kf_obs_pt"].shape[1]
    ids = np.flatnonzero(m["pt_valid"])
    slots = np.where(rng.uniform(size=(rows, F)) < 0.5,
                     rng.choice(ids, (rows, F)), -1).astype(np.int32)
    vis = np.where(rng.uniform(size=(rows, V)) < 0.6,
                   rng.choice(ids, (rows, V)), -1).astype(np.int32)
    pad = rows - rows // 4
    slots[pad:] = -1
    vis[pad:] = -1
    packeds = np.stack([rng.integers(50, 400, rows),
                        MAINT_MIN_INLIERS + rng.integers(-20, 20, rows),
                        rng.integers(V // 4, V, rows),
                        rng.integers(0, 2, rows)], 1).astype(np.float32)
    return dict(slots=slots, vis=vis, packeds=packeds)


def maint_cases(K: int, F: int, N: int, E: int, V: int,
                seed: int = 0) -> list[dict]:
    """The map-maintenance cases as numpy: a keyframe into an empty map
    (point 0 free: its last writer), into a free slot with a serial
    program's fold (32 rows), over a valid occupant, over one with a full
    ledger, over the only valid keyframe (no parent), over slot 2 of
    ``maint_tie_numpy`` (tied parents), and into a free slot of it with
    keyframe 1 fused and culled (tied covisibility counts, tied redundant
    keyframes, tied parents).  Each: map, frame, pose, slot_pt, cam, slot,
    the fused and culled keyframe ``kf``, stats (or None)."""
    base = maint_map_numpy(K, F, N, E, seed)
    valid = np.flatnonzero(base["kf_valid"])
    free = int(np.flatnonzero(~base["kf_valid"])[0])
    full = {k: np.array(v) for k, v in base.items()}
    full["led_n"] = np.int32(E)
    full["led_seq"][:] = np.arange(E, dtype=np.int32)
    alone = {k: np.array(v) for k, v in base.items()}
    only = int(valid[len(valid) // 2])
    alone["kf_valid"][:] = False
    alone["kf_valid"][only] = True
    alone["kf_seq"][np.arange(K) != only] = -1
    tie = maint_tie_numpy(base)
    tie_free = [r for r in range(10, K) if not tie["kf_valid"][r]] + [K - 1]
    out = []
    for name, m, slot, kf, stats in (
            ("first_keyframe", maint_empty_numpy(K, F, N, E), 0, None,
             False),
            ("free_slot_fold", base, free, None, True),
            ("evict", base, int(valid[1]), None, False),
            ("evict_full_ledger", full, int(valid[2]), None, False),
            ("evict_alone", alone, only, None, False),
            ("evict_tie", tie, 2, None, False),
            ("ties", tie, tie_free[0], 1, False)):
        c = maint_frame_numpy(m, seed + len(out) + 1)
        out.append(dict(name=name, slot=slot, kf=slot if kf is None else kf,
                        stats=(maint_stats_numpy(c["map"], 32, V) if stats
                               else None), **c))
    return out


class MaintOps(NamedTuple):
    """One keyframe's maintenance operands on a device."""
    m: MapState
    frame: FrameObs
    pose: torch.Tensor
    slot_pt: torch.Tensor
    cam: torch.Tensor
    slot: int
    kf: int
    stats: tuple | None  # (found (B, F), visible (B, V)) or None
    packeds: torch.Tensor | None  # (B, 4), the stats rows' packed rows


def maint_operands(c: dict, device) -> MaintOps:
    from visual_sgraphs_tpu_torch import interop
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    st = c["stats"]
    return MaintOps(
        m=interop.map_from_numpy(c["map"], device),
        frame=interop.frame_from_numpy(c["frame"], device), pose=f(c["pose"]),
        slot_pt=f(c["slot_pt"]), cam=f(c["cam"]), slot=c["slot"], kf=c["kf"],
        stats=None if st is None else (f(st["slots"]), f(st["vis"])),
        packeds=None if st is None else f(st["packeds"]))


def _clone_map(m: MapState) -> MapState:
    return MapState(*(t.clone() for t in m))


def maint_diff(a: MapState, b: MapState) -> tuple[list, float]:
    """(the integer / bool fields that differ, the largest float
    difference) of two maps."""
    bad = [f for f in MapState._fields if f not in MAINT_FLOAT_FIELDS
           and not torch.equal(getattr(a, f), getattr(b, f))]
    err = max(float((getattr(a, f) - getattr(b, f)).abs().max())
              if getattr(a, f).numel() else 0.0 for f in MAINT_FLOAT_FIELDS)
    return bad, err


def _unchanged(m: MapState, before: MapState) -> bool:
    return all(torch.equal(x, y) for x, y in zip(m, before))


def _maint_result(name: str, kernel, twin, repro_fn, work: tuple,
                  **extra) -> dict:
    """Times, device operations and the bound's work of a kernel call
    ``kernel`` against its twin ``twin``; ``repro_fn`` -> whether three
    more launches agree bitwise."""
    plain = device_ops(twin)
    return dict(name=name, ms=time_cuda(kernel), device_ms=device_time(kernel),
                graph_ops=graph_ops(kernel), plain_ms=time_cuda(twin),
                plain_device_ms=plain["device_ms"],
                plain_device_ops=plain["ops"], library_ms=None,
                bitwise_repro=repro_fn(), bytes=work[0], ops=work[1],
                **extra)


def check_found_stats(device, m: MapState, slots, vis, packeds=None,
                      min_inliers: int = MAINT_MIN_INLIERS,
                      name: str = "found_stats") -> dict:
    """K27's stats entry against its twin (with the acceptance mask when
    ``packeds`` is given): both counters exact, the input unmodified, one
    device operation a call, bitwise from launch to launch."""
    from visual_sgraphs_tpu_torch.slam import mapping
    before = _clone_map(m)
    kernel = lambda: mapping.apply_found_stats(  # noqa: E731
        m, slots, vis, packeds, min_inliers)
    twin = lambda: mapping.apply_found_stats_torch(  # noqa: E731
        m, slots, vis, packeds, min_inliers)
    k, t = kernel(), twin()
    torch.cuda.synchronize()
    exact = (torch.equal(k.pt_found, t.pt_found)
             and torch.equal(k.pt_visible, t.pt_visible))
    same = _unchanged(m, before)
    n_ids = slots.numel() + (0 if vis is None else vis.numel())
    work = (16 * m.N + 4 * n_ids + nbytes(packeds), 2 * n_ids + 2 * m.N)
    r = _maint_result(name, kernel, twin, lambda: all(
        torch.equal(k.pt_found, o.pt_found)
        and torch.equal(k.pt_visible, o.pt_visible)
        for o in (kernel() for _ in range(3))), work, exact=exact,
        input_unchanged=same, rows=slots.numel() // slots.shape[-1],
        max_abs_err=0.0 if exact else float("inf"))
    r["ok"] = exact and same and r["bitwise_repro"] and r["graph_ops"] == 1
    return r


def check_kf_insert(device, ops: MaintOps, name: str = "kf_insert",
                    quarantine: int = 3) -> dict:
    """K27's insert entry against its twin: every integer and bool field
    of the new map exact, its float fields within MAINT_TOL, the slot and
    the eviction flag equal, the input unmodified, one device operation a
    call, bitwise from launch to launch."""
    from visual_sgraphs_tpu_torch.slam import mapping
    m = ops.m
    before = _clone_map(m)

    def kernel():
        return mapping.insert_keyframe(m, ops.frame, ops.pose, ops.slot_pt,
                                       ops.cam, ops.slot, quarantine,
                                       ops.stats)

    def twin():
        return mapping.insert_keyframe_torch(m, ops.frame, ops.pose,
                                             ops.slot_pt, ops.cam, ops.slot,
                                             quarantine, ops.stats)

    (km, kk, ke), (tm, tk, te) = kernel(), twin()
    torch.cuda.synchronize()
    bad, err = maint_diff(km, tm)
    same = _unchanged(m, before)
    changed = [getattr(m, f) for f in mapping.INSERT_FIELDS]
    n_ids = 0 if ops.stats is None else sum(s.numel() for s in ops.stats)
    work = (2 * nbytes(*changed) + nbytes(m.pt_freed_seq, *ops.frame,
                                          ops.pose, ops.slot_pt, ops.cam)
            + 4 * n_ids, 40 * m.F + 6 * m.N + 2 * n_ids)
    r = _maint_result(name, kernel, twin, lambda: all(
        all(torch.equal(x, y) for x, y in zip(km, o[0]))
        for o in (kernel() for _ in range(3))), work, int_fields_differ=bad,
        max_abs_err=err, input_unchanged=same, evicted=bool(ke),
        n_new=int(km.n_pt) - int(m.n_pt),
        led_written=int(km.led_n) - int(m.led_n))
    r["ok"] = (not bad and err <= MAINT_TOL and kk == tk
               and bool(ke) == bool(te) and same and r["bitwise_repro"]
               and r["graph_ops"] == 1)
    return r


def check_fuse(device, m: MapState, kf: int, cam_K, tag: str = "",
               n_local: int = 4096) -> list[dict]:
    """K28's two entries against their twins on ``m`` at keyframe ``kf``:
    the prologue's candidate ids and free keypoints exact, the write-back's
    kf_obs_pt exact (on the tracking pass's matches at 4 px: the fuse's
    own), the map unmodified, one device operation a call each, bitwise
    from launch to launch."""
    from visual_sgraphs_tpu_torch.slam import mapping
    before = _clone_map(m)
    pro_k = lambda: mapping.fuse_candidates(m, kf, n_local)  # noqa: E731
    pro_t = lambda: mapping.fuse_candidates_torch(m, kf, n_local)  # noqa
    (ids, kp), (ids_t, kp_t) = pro_k(), pro_t()
    torch.cuda.synchronize()
    pro_exact = torch.equal(ids, ids_t) and torch.equal(kp.valid, kp_t.valid)
    K, F, N = m.K, m.F, m.N
    pro = _maint_result(
        f"fuse_prologue{tag}", pro_k, pro_t, lambda: all(
            torch.equal(ids, o[0]) and torch.equal(kp.valid, o[1].valid)
            for o in (pro_k() for _ in range(3))),
        (K * F * 5 + K + N + 4 * n_local + F, K * F * 3 + K * K + N),
        exact=pro_exact, n_ids=int((ids >= 0).sum()),
        n_free=int(kp.valid.sum()),
        max_abs_err=0.0 if pro_exact else float("inf"))
    pro["ok"] = pro_exact and pro["bitwise_repro"] and pro["graph_ops"] == 1
    tp = match.track_pass(m.pt_pos, m.pt_desc, ids, m.kf_pose[kf], cam_K,
                          None, FUSE_RADIUS, kp, want_depth=False)
    wb_k = lambda: mapping.fuse_writeback(  # noqa: E731
        m.kf_obs_pt, kf, ids, tp.ok, tp.slot)
    wb_t = lambda: mapping.fuse_writeback_torch(  # noqa: E731
        m.kf_obs_pt, kf, ids, tp.ok, tp.slot)
    ko, to = wb_k(), wb_t()
    torch.cuda.synchronize()
    wb_exact = torch.equal(ko, to)
    same = _unchanged(m, before)
    n = ids.shape[0]
    wb = _maint_result(
        f"fuse_writeback{tag}", wb_k, wb_t, lambda: all(
            torch.equal(ko, wb_k()) for _ in range(3)),
        (8 * K * F + n * 13, n + K * F), exact=wb_exact,
        n_matched=int(tp.ok.sum()), input_unchanged=same,
        max_abs_err=0.0 if wb_exact else float("inf"))
    wb["ok"] = (wb_exact and same and wb["bitwise_repro"]
                and wb["graph_ops"] == 1)
    return [pro, wb]


def check_map_cull(device, m: MapState, kf: int, min_obs: int = 2,
                   min_found_ratio: float = 0.25, redundancy: float = 0.9,
                   name: str = "map_cull") -> dict:
    """K29 against its twin (``cull_points`` then ``cull_keyframes``):
    every integer field exact, the ledger's T_cp within MAINT_TOL, the
    culled slot equal, the input unmodified, one device operation a call,
    bitwise from launch to launch."""
    from visual_sgraphs_tpu_torch.slam import mapping
    before = _clone_map(m)
    kernel = lambda: mapping.cull_map(  # noqa: E731
        m, kf, min_obs, min_found_ratio, redundancy)
    twin = lambda: mapping.cull_map_torch(  # noqa: E731
        m, kf, min_obs, min_found_ratio, redundancy)
    (km, kc), (tm, tc) = kernel(), twin()
    torch.cuda.synchronize()
    bad, err = maint_diff(km, tm)
    same = _unchanged(m, before)
    read = nbytes(m.kf_obs_pt, m.kf_kp_valid, m.kf_valid, m.kf_seq,
                  m.kf_pose, m.pt_valid, m.pt_first_seq, m.pt_found,
                  m.pt_visible, m.pt_freed_seq, m.pt_first_kf, m.led_seq,
                  m.led_parent_seq, m.led_T_cp, m.led_n, m.n_kf)
    write = nbytes(*(getattr(m, f) for f in mapping.CULL_FIELDS)) + 4
    r = _maint_result(name, kernel, twin, lambda: all(
        all(torch.equal(x, y) for x, y in zip(km, o[0]))
        and torch.equal(kc, o[1]) for o in (kernel() for _ in range(3))),
        (read + write, 6 * m.K * m.F + 12 * m.N), int_fields_differ=bad,
        max_abs_err=err, input_unchanged=same, culled=int(kc),
        n_culled_points=int(m.pt_valid.sum()) - int(km.pt_valid.sum()))
    r["ok"] = (not bad and err <= MAINT_TOL and int(kc) == int(tc) and same
               and r["bitwise_repro"] and r["graph_ops"] == 1)
    return r


def check_maintenance(device, ops: MaintOps, tag: str) -> list[dict]:
    """K27's insert entry, K28 and K29 on one case's operands, in the
    keyframe program's order (the fuse on the inserted map, the cull on
    the fused one), and K27's stats entry on its stats."""
    from visual_sgraphs_tpu_torch.slam import mapping
    out = [check_kf_insert(device, ops, f"kf_insert@{tag}")]
    m1, k, _ = mapping.insert_keyframe(ops.m, ops.frame, ops.pose,
                                       ops.slot_pt, ops.cam, ops.slot, 3,
                                       ops.stats)
    kf = ops.kf
    out += check_fuse(device, m1, kf, ops.cam, f"@{tag}")
    m2 = mapping.fuse_observations(m1, kf, ops.cam)
    out.append(check_map_cull(device, m2, kf, name=f"map_cull@{tag}"))
    if ops.stats is not None:
        out.append(check_found_stats(device, ops.m, *ops.stats, ops.packeds,
                                     name=f"found_stats@{tag}"))
    return out


def run_maintenance(device, shapes: dict = MAINT_SHAPES) -> list[dict]:
    """K27-K29 on every seeded case of ``maint_cases`` at the cells'
    capacities, and K27's stats entry on one serial frame's row."""
    out = []
    for c in maint_cases(**shapes):
        ops = maint_operands(c, device)
        out += check_maintenance(device, ops, c["name"])
        if c["stats"] is not None:
            s = c["stats"]
            f = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
            out.append(check_found_stats(device, ops.m, f(s["slots"][0]),
                                         f(s["vis"][0]),
                                         name="found_stats@frame"))
    return out


@contextlib.contextmanager
def watch_maintenance(which: int = 8):
    """Inside the block, record copies of the operands of the ``which``-th
    keyframe insertion (the last one if fewer ran) and of the fuse and the
    cull that follow it (the first cull at or after it), and of the
    ``which``-th stats fold with an acceptance mask (the cycle's): a
    MaintOps under "operands" (its fold's packeds under "packeds"), the
    fused map under "fuse" and the culled one under "cull".  The copies
    cost device time: watch a run that is not timed."""
    from visual_sgraphs_tpu_torch.slam import mapping
    out = {"inserts": 0, "folds": 0}
    orig = (mapping.insert_keyframe, mapping.fuse_observations,
            mapping.cull_map, mapping.apply_found_stats)

    def ins(m, frame, pose, slot_pt, cam_K, slot, quarantine=3, stats=None):
        out["inserts"] += 1
        if out["inserts"] <= which:
            out["operands"] = MaintOps(
                _clone_map(m), FrameObs(*(t.clone() for t in frame)),
                pose.clone(), slot_pt.clone(), cam_K.clone(), int(slot),
                int(slot), None if stats is None
                else tuple(s.clone() for s in stats), None)
            out.pop("fuse", None)
            out.pop("cull", None)
        return orig[0](m, frame, pose, slot_pt, cam_K, slot, quarantine,
                       stats)

    def fuse(m, kf_id, cam_K, *args, **kw):
        if "operands" in out and "fuse" not in out:
            out["fuse"] = (_clone_map(m), int(kf_id), cam_K.clone())
        return orig[1](m, kf_id, cam_K, *args, **kw)

    def cull(m, kf_id, *args):
        if "fuse" in out and "cull" not in out:
            out["cull"] = (_clone_map(m), int(kf_id), *args)
        return orig[2](m, kf_id, *args)

    def stats(m, slot_pts, vis_pts=None, packeds=None, min_inliers=0):
        if packeds is not None:
            out["folds"] += 1
            if out["folds"] <= which:
                out["fold"] = (_clone_map(m), slot_pts.clone(),
                               vis_pts.clone(), packeds.clone(),
                               int(min_inliers))
        return orig[3](m, slot_pts, vis_pts, packeds, min_inliers)

    # the wrapped functions count their calls through their module names
    for fn, spy in zip(orig, (ins, fuse, cull, stats)):
        spy.__dict__.update(fn.__dict__)
    mapping.insert_keyframe, mapping.fuse_observations = ins, fuse
    mapping.cull_map, mapping.apply_found_stats = cull, stats
    try:
        yield out
    finally:
        (mapping.insert_keyframe, mapping.fuse_observations,
         mapping.cull_map, mapping.apply_found_stats) = orig


def check_recorded_maintenance(device, seen: dict) -> list[dict]:
    """K27-K29 on the operands ``watch_maintenance`` recorded: the
    insertion, the fuse, the cull and the cycle's fold of a
    ``bench_slice`` keyframe program (named after the kernels: the
    ``kernels`` line's rows)."""
    ops = seen["operands"]
    fm, fkf, fcam = seen["fuse"]
    out = [check_kf_insert(device, ops, "kf_insert"),
           *check_fuse(device, fm, fkf, fcam)]
    cm, ckf, *cargs = seen["cull"]
    out.append(check_map_cull(device, cm, ckf, *cargs))
    fold = seen["fold"]
    out.append(check_found_stats(device, fold[0], fold[1], fold[2], fold[3],
                                 fold[4], name="found_stats"))
    return out


def run_scan(device) -> list[dict]:
    """K25's three entries on seeded operands."""
    return [*check_scan_epilogue(device), check_scan_prologue(device),
            check_inlier_tail(device)]


def run_all(device) -> list[dict]:
    """Every kernel against its twin at the slice's shapes (K1's resize
    chain also on one frame, as the serial path extracts it)."""
    grays = batch_frames(device)
    one = check_pyramid(grays[:1])
    for r in one:
        r["name"] += "@B1"
    return [*check_pyramid(grays), *one, *check_blur_cases(device),
            check_detect(grays), *check_detect_cases(device),
            check_compact(device), check_compact_observed(device),
            check_group(device),
            *check_front_k2_k4(device),
            check_match_window(device),
            *check_track_pass_radii(device, tag="@seeded"),
            check_pose_gn(device),
            *check_schur(device), *check_scenegraph(device)]
