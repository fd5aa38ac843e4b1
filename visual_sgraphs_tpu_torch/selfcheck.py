"""Kernel-against-twin checks at the slice's shapes, on a CUDA device.

Each check builds seeded inputs of the shapes the main path gives the
kernel (a rendered 480x640 frame's 8 pyramid levels and 1000 keypoints;
4096 local-map points against 1000 keypoints; 4096 matches with stereo
rows), runs the hand kernel and its plain PyTorch twin on the same device,
compares them at the stated tolerance and times both with CUDA events.
``chip_smoke.py`` and the GPU tests call these; nothing here runs on
import.
"""

from __future__ import annotations

import statistics
from typing import Callable

import numpy as np
import torch

from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.features import fast, match, orb
from visual_sgraphs_tpu_torch.features.pyramid import (
    build_pyramid,
    gaussian_blur,
)
from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
from visual_sgraphs_tpu_torch.slam import tracking

# tolerances (the reasons are in the kernels' sources and the CPU tests)
ANGLE_TOL = 1e-5  # rad, IC angle
POSE_TOL = 1e-4  # per pose component, K6
INLIER_AGREE = 0.99  # fraction of equal inlier flags, K6


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


def slice_levels(device, h: int = 480, w: int = 640, frame: int = 10,
                 n_features: int = 1000):
    """Pyramid levels, per-level keypoints (rc) and blurred levels of one
    rendered ``orbit2`` frame at the slice's size."""
    scene = SyntheticScene(h=h, w=w, device=device)
    T = scene.trajectory(96, "orbit2")[frame]
    gray, _, _ = scene.render(T)
    params = orb.OrbParams(n_features=n_features)
    levels = build_pyramid(gray, params.n_levels, params.scale)
    budgets = orb.level_budgets(params)
    rcs, blurred = [], []
    for lv, b in zip(levels, budgets):
        rc, _, _ = orb._detect_level(fast.fast_nms_torch(lv), b, params)
        rcs.append(rc)
        blurred.append(gaussian_blur(lv))
    return levels, rcs, blurred


def check_fast_nms(levels) -> dict:
    """K2 on every level: bitwise equal to the twin."""
    err = 0.0
    for lv in levels:
        k = fast.fast_nms(lv)
        t = fast.fast_nms_torch(lv)
        torch.cuda.synchronize()
        err = max(err, float((k - t).abs().max()))
    ms = time_cuda(lambda: [fast.fast_nms(lv) for lv in levels])
    plain = time_cuda(lambda: [fast.fast_nms_torch(lv) for lv in levels])
    return dict(name="fast_nms", max_abs_err=err, ms=ms, plain_ms=plain,
                ok=err == 0.0, shapes=[list(lv.shape) for lv in levels])


def check_orb_desc(rcs, blurred) -> dict:
    """K4 on every level's keypoints: angle within ANGLE_TOL, descriptor
    bitwise equal given the twin's angle."""
    pattern = orb.brief_pattern_tensor(42, blurred[0].device)
    err, bits = 0.0, 0
    for rc, bl in zip(rcs, blurred):
        ka, _ = orb.orb_describe(bl, rc, pattern)
        ta, td = orb.orb_describe_torch(bl, rc, pattern)
        _, kd = orb.orb_describe(bl, rc, pattern, angle=ta)
        torch.cuda.synchronize()
        err = max(err, float((ka - ta).abs().max()))
        bits += int((kd != td).sum())
    ms = time_cuda(lambda: [orb.orb_describe(bl, rc, pattern)
                            for rc, bl in zip(rcs, blurred)])
    plain = time_cuda(lambda: [orb.orb_describe_torch(bl, rc, pattern)
                               for rc, bl in zip(rcs, blurred)],
                      warmup=1, reps=5)
    return dict(name="orb_desc", max_abs_err=err, ms=ms, plain_ms=plain,
                ok=err <= ANGLE_TOL and bits == 0, desc_bytes_differ=bits,
                n_keypoints=sum(int(rc.shape[0]) for rc in rcs))


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
    ms = time_cuda(lambda: match.match_window(*args, radius=radius))
    plain = time_cuda(lambda: match.match_window_torch(*args, radius=radius))
    return dict(name="match_window", max_abs_err=err, ms=ms, plain_ms=plain,
                ok=err == 0.0, n_matched=int((km >= 0).sum()))


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


def check_pose_gn(device) -> dict:
    """K6 at 4096 matches with stereo rows and the wide first gate: pose
    within POSE_TOL, inlier flags equal on >= INLIER_AGREE of rows."""
    T0, xw, uv, valid, K, depth, bf = pose_inputs(device)
    kw = dict(iters=12, gate0=(2.0 * 15.0) ** 2, depth=depth, bf=bf)
    kT, kin = tracking.pose_only_gn(T0, xw, uv, valid, K, **kw)
    tT, tin = tracking.pose_only_gn_torch(T0, xw, uv, valid, K, **kw)
    torch.cuda.synchronize()
    err = float((kT - tT).abs().max())
    agree = float((kin == tin).float().mean())
    ms = time_cuda(lambda: tracking.pose_only_gn(T0, xw, uv, valid, K, **kw))
    plain = time_cuda(
        lambda: tracking.pose_only_gn_torch(T0, xw, uv, valid, K, **kw))
    return dict(name="pose_gn", max_abs_err=err, ms=ms, plain_ms=plain,
                ok=err <= POSE_TOL and agree >= INLIER_AGREE,
                inlier_agreement=agree, n_inliers=int(kin.sum()))


def run_all(device) -> list[dict]:
    """Every kernel against its twin at the slice's shapes."""
    levels, rcs, blurred = slice_levels(device)
    return [check_fast_nms(levels), check_orb_desc(rcs, blurred),
            check_match_window(device), check_pose_gn(device)]
