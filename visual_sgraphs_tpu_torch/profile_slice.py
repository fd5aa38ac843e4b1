"""Where the time goes on the card: one profiled window of the slice.

    python -m visual_sgraphs_tpu_torch.profile_slice [--scenegraph]
    python -m visual_sgraphs_tpu_torch.profile_slice --bench
    python -m visual_sgraphs_tpu_torch.profile_slice --inertial
    python -m visual_sgraphs_tpu_torch.profile_slice --freespace
    python -m visual_sgraphs_tpu_torch.profile_slice --loop-runs N
    python -m visual_sgraphs_tpu_torch.profile_slice --small-vs-cpu
    python -m visual_sgraphs_tpu_torch.profile_slice --cells
    python -m visual_sgraphs_tpu_torch.profile_slice --kernel-times
    python -m visual_sgraphs_tpu_torch.profile_slice --track-ops
    python -m visual_sgraphs_tpu_torch.profile_slice --k20-sections
    python -m visual_sgraphs_tpu_torch.profile_slice --schur-times PATH

Runs the main path of ``main_path`` (640x480, 1000 features, 96
``orbit2`` frames) through ``SlamSystem.track_rgbd`` on the card (with
``--scenegraph`` the scene graph attached, as ``chip_smoke.py`` phase 4b
runs it) and profiles frames 32-63 twice: under ``torch.profiler``
(device time by kernel, device busy share of the window, launches a
frame) and under ``cProfile`` (host time by Python function); on the
scene-graph paths it then counts the device operations of one call of
each scene-graph function still in plain torch (``plain_scenegraph``).  With
``--bench`` the profiled path is the headline configuration on the B-frame
pipeline (``main_path.bench_config``, 192 frames, ``chip_smoke.py``'s
``bench_slice``) and the window frames 96-127.  With ``--inertial`` it is
the inertial row (``main_path.inertial_config``, 128 ``orbit`` frames with
their IMU samples, ``chip_smoke.py``'s ``inertial_slice``) and the window
frames 64-95, after the IMU initialised.  With ``--freespace`` it is
``chip_smoke.py``'s ``freespace_slice`` (the scene graph with free-space
rooms, ``main_path.freespace_config``) over frames 32-63, which hold
clustering passes.  With ``--scenegraph`` it also
times one plane-KF factor linearisation (1024 items) with
``torch.func.jacfwd`` and, for comparison, ``jacrev``.  With ``--loop-runs N`` it instead runs the loop
path (``chip_smoke.py``'s ``loop_slice``: scene graph and loop closing on)
N times and prints each run's loops, relocalisations and ATE: the spread
that the card's float summation order alone gives one configuration.
With ``--small-vs-cpu`` it runs the headline configuration cut to
240x320 and 600 features over the first 96 of its 192 frames on the card
(twice, on frames rendered on the CPU; once on frames rendered on the
card) and on the CPU twins (on the CPU's frames and on the card's), then
both on the serial path (``pipeline_depth=1``), and prints how far the
two renders differ and where each run first parts from its CPU
counterpart: the front end (K1-K4) frame by frame, then positions,
tracking and keyframes.  With ``--cells`` it runs ``slice``,
``scenegraph_slice``, ``bench_slice``, ``freespace_slice`` and
``inertial_slice`` once each and prints their fps as ``chip_smoke.py``
times them, and the keyframe program's mean host ms (a cycle's on
``bench_slice``, the VI local BA's on ``inertial_slice``).  To compare two
trees on one card, run this file by path with ``PYTHONPATH`` set to the
other tree's root: the package and kernels are then that tree's.  With
``--kernel-times`` it runs ``selfcheck``'s checks of K9, K6, K6's prior
branch, K5's window matcher, the tracking pass (seeded operands, the
coarse radius) and K20 at the main path's shapes and prints
each one's CUDA-event and device times (``selfcheck.device_time``) beside
its library call's, the host ms of the tracking pass's and K6's wrappers
(``wrapper_host``), and the card's name and power limit.  With
``--track-ops`` it counts the device operations of one tracking call
(both passes) and of one pipeline scan batch on ``bench_slice``'s map
(``track_ops``); with ``--k20-sections`` it reads K20's clock at its
section boundaries (``selfcheck.vi_pose_sections``).  With
``--schur-times PATH`` it times the two landmark Schur reductions, K8
(``dist_ba.local_reduced_system``: seeded at L = 11 and 128, and on the
tables of ``bench_slice``'s 17th scene-graph BA call) and K22a's
reduction (``lm_kernels.lm_reproj_reduce`` on ``inertial_slice``'s fourth
VI local BA, and its last generic local BA), each with its CUDA-event
and device ms, its device operations a call and whether three launches
agree bitwise; the two windows are recorded into PATH (a ``torch.save``
of plain tensors) when it does not exist, so that two trees are timed on
the same operands.
Prints one JSON line per result; needs a card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time

import numpy as np
import torch

WINDOW = (32, 64)
BENCH_WINDOW = (96, 128)
INERTIAL_WINDOW = (64, 96)


def _line(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=str), flush=True)


def _slice(with_sg: bool, bench: bool = False, inertial: bool = False,
           freespace: bool = False):
    from visual_sgraphs_tpu_torch import main_path
    if inertial:
        scene, frames = main_path.inertial_frames("cuda")
        return main_path.make_system(main_path.inertial_config(scene),
                                     "cuda", False), frames
    if bench:
        scene, frames = main_path.frames("cuda", main_path.BENCH_FRAMES)
        return main_path.make_system(main_path.bench_config(scene), "cuda",
                                     True), frames
    scene, frames = main_path.frames("cuda")
    if freespace:
        return main_path.make_system(main_path.freespace_config(scene),
                                     "cuda", True), frames
    cfg, sg_cfg = main_path.configs(scene)
    return main_path.make_system(sg_cfg if with_sg else cfg, "cuda",
                                 with_sg), frames


def _feed(system, frames) -> None:
    from visual_sgraphs_tpu_torch import main_path
    feed = main_path.feed if system.imu is None else main_path.feed_inertial
    for frame in frames:
        feed(system, frame)


def profile(with_sg: bool, bench: bool = False, inertial: bool = False,
            freespace: bool = False) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    lo, hi = (INERTIAL_WINDOW if inertial else BENCH_WINDOW if bench
              else WINDOW)
    n = hi - lo
    # device view
    system, frames = _slice(with_sg, bench, inertial, freespace)
    _feed(system, frames[:lo])
    torch.cuda.synchronize()
    kf0 = system.events.count("keyframe")
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        _feed(system, frames[lo:hi])
        torch.cuda.synchronize()
    window_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:12]
    _line("device", frames=f"{lo}-{hi - 1}", window_us=window_us,
          device_us=device_us, busy_share=device_us / window_us,
          device_ops_per_frame=sum(e.count for e in events) / n,
          keyframes=system.events.count("keyframe") - kf0,
          top={e.key[:60]: [e.device_time_total, e.count] for e in top})
    # host view, without the profiler
    system, frames = _slice(with_sg, bench, inertial, freespace)
    _feed(system, frames[:lo])
    torch.cuda.synchronize()
    system.timers.reset()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    _feed(system, frames[lo:hi])
    system.flush()
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(pr).stats
    port = {f"{k[0].rsplit('/', 1)[-1]}:{k[2]}": v[3]
            for k, v in stats.items() if "visual_sgraphs_tpu_torch" in k[0]}
    _line("host", frames=f"{lo}-{hi - 1}", wall_s=wall, fps=n / wall,
          cumulative_s=dict(sorted(port.items(), key=lambda kv: -kv[1])[:15]),
          stages=system.timers.summary())
    if system.scenegraph is not None:
        _line("plain_scenegraph", **plain_scenegraph_ops(system))
    if with_sg and not (bench or freespace):
        _line("linearize", **linearization_ms())


def cells_fps(warm: int = 16) -> None:
    """fps of the serial cells, ``bench_slice`` and ``inertial_slice``, one
    run each, over the frames after the warm-up (``main_path.BENCH_WARMUP``
    on ``bench_slice``, ``INERTIAL_WARMUP`` on ``inertial_slice``), ending
    in a synchronize, as ``chip_smoke.py``; beside each the keyframe
    stage's mean ms (on ``inertial_slice`` the VI local BA's, ``vi_lba``)."""
    from visual_sgraphs_tpu_torch import cuda, main_path
    cuda.build()
    scene, frames = main_path.frames("cuda")
    cfg, sg_cfg = main_path.configs(scene)
    bench_frames = main_path.frames("cuda", main_path.BENCH_FRAMES)[1]
    vi_scene, vi_frames = main_path.inertial_frames("cuda")
    out = {}
    for tag, c, with_sg, fr, lo, feed, stage in (
            ("slice", cfg, False, frames, warm, main_path.feed,
             "kf_program"),
            ("scenegraph_slice", sg_cfg, True, frames, warm, main_path.feed,
             "kf_program"),
            ("bench_slice", main_path.bench_config(scene), True,
             bench_frames, main_path.BENCH_WARMUP, main_path.feed,
             "track_dispatch"),
            ("freespace_slice", main_path.freespace_config(scene), True,
             frames, warm, main_path.feed, "kf_program"),
            ("inertial_slice", main_path.inertial_config(vi_scene), False,
             vi_frames, main_path.INERTIAL_WARMUP, main_path.feed_inertial,
             "vi_lba")):
        system = main_path.make_system(c, "cuda", with_sg)
        for i, frame in enumerate(fr):
            if i == lo:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                system.timers.reset()
            feed(system, frame)
        system.flush()
        torch.cuda.synchronize()
        out[tag] = (len(fr) - lo) / (time.perf_counter() - t0)
        out[tag + "_kf_ms"] = system.timers.summary().get(stage, {}).get(
            "mean_ms")
    _line("cells_fps", **out)


def plain_scenegraph_ops(system) -> dict:
    """Device operations and device ms of one call of each function of
    the scene-graph keyframe that still runs as plain torch ops, on the
    system's final state (``selfcheck.device_ops``): the semantic point
    refinement and the plane covisibility bonus run every keyframe (with
    their settings on), the two maintenance passes every
    ``maintenance_interval``-th."""
    from visual_sgraphs_tpu_torch import selfcheck
    from visual_sgraphs_tpu_torch.scenegraph import manager as sgm
    sg, m, kf = system.scenegraph.state, system.map, system.ref_kf_host
    cfg = system.cfg.scenegraph
    v = cfg.plane_min_votes
    fns = dict(
        refine_points_semantic=lambda: sgm.refine_points_semantic(
            m, sg, m.kf_pose[kf], min_votes=v,
            behind_thresh=cfg.refine_behind_thresh),
        plane_covis_bonus=lambda: sgm.plane_covis_bonus(
            sg, kf, m.K, min_votes=v, score=cfg.plane_covis_score,
            undefined_factor=cfg.plane_covis_undefined_factor),
        filter_semantic_planes=lambda: sgm.filter_semantic_planes(
            sg, min_votes=v),
        reassociate_planes=lambda: sgm.reassociate_planes(sg, min_votes=v))
    return {k: selfcheck.device_ops(f) for k, f in fns.items()}


def linearization_ms(n_items: int = 1024, reps: int = 10) -> dict:
    """ms per plane-KF factor linearisation of ``n_items`` items on the
    card, forward mode (the port's) against reverse mode."""
    from torch.func import jacfwd, jacrev, vmap

    from visual_sgraphs_tpu_torch.core import lie
    from visual_sgraphs_tpu_torch.core import plane as plane_mod
    from visual_sgraphs_tpu_torch.optim import factors

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    poses = lie.se3_exp(torch.randn(n_items, 6, generator=gen) * 0.1).to(dev)
    planes = torch.nn.functional.normalize(
        torch.randn(n_items, 4, generator=gen), dim=-1).to(dev)
    obs = torch.nn.functional.normalize(
        torch.randn(n_items, 4, generator=gen), dim=-1).to(dev)
    zeros = (torch.zeros(n_items, 6, device=dev),
             torch.zeros(n_items, 3, device=dev))

    def residual(d, v, c):
        return factors.plane_kf((lie.se3_boxplus(v[0], d[0]),
                                 plane_mod.oplus(v[1], d[1])), c)

    out = {}
    for name, jac in (("jacfwd", jacfwd), ("jacrev", jacrev)):
        run = lambda: vmap(jac(residual))(  # noqa: E731
            zeros, (poses, planes), {"pi_obs": obs})
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        out[name + "_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def loop_spread(n_runs: int) -> None:
    """The loop path ``n_runs`` times on the same frames and configuration;
    one line a run, then the ATE's spread."""
    from visual_sgraphs_tpu_torch import main_path
    from visual_sgraphs_tpu_torch.core import geometry
    scene, frames = main_path.frames("cuda")
    cfg = main_path.loop_config(main_path.configs(scene)[1])
    gt = torch.from_numpy(np.stack([f[3][4:7] for f in frames]))
    ates = []
    for run in range(n_runs):
        system = main_path.make_system(cfg, "cuda", True)
        _feed(system, frames)
        system.flush()
        pos, tracked = system.positions(), system.tracked_mask()
        ate = float(geometry.ate_rmse(torch.from_numpy(pos[tracked]),
                                      gt[tracked])[0])
        ates.append(ate)
        ev = system.events
        _line("loop_run", run=run, tracked=int(tracked.sum()), ate_m=ate,
              n_loops_closed=system.loop_closer.n_loops_closed,
              verified=[[e["kf"], e["cand"], e["drift"], e["n_inl"]]
                        for e in ev.of_kind("loop_verified")],
              n_global_ba=ev.count("global_ba"), n_reloc=ev.count("reloc"),
              n_recovery_kf=ev.count("recovery_keyframe"),
              n_kf=int(system.map.n_kf))
        del system
    _line("loop_spread", runs=n_runs, ate_m_min=min(ates),
          ate_m_median=float(np.median(ates)), ate_m_max=max(ates))


def _run_record(system, frames) -> dict:
    """Positions, tracked mask and keyframe / event record of one run."""
    _feed(system, frames)
    system.flush()
    ev = system.events
    return dict(
        pos=system.positions(), tracked=system.tracked_mask(),
        keyframes=[(e["kf"], e["n_inliers"]) for e in ev.of_kind("keyframe")],
        events={k: ev.count(k) for k in (
            "keyframe", "serial_relief", "batch_retrack", "reloc",
            "recovery_keyframe", "loop_closed", "global_ba")})


def _parting(a: dict, b: dict, tol_m: float = 1e-3) -> dict:
    """Where run ``a`` first parts from run ``b``."""
    d = np.abs(a["pos"] - b["pos"]).max(axis=1)
    far = np.flatnonzero(d > tol_m)
    kf = next((i for i, (x, y) in enumerate(zip(a["keyframes"],
                                                b["keyframes"])) if x != y),
              None)
    lost = lambda r: np.flatnonzero(~r["tracked"]).tolist()  # noqa: E731
    return dict(first_frame_over_1mm=int(far[0]) if len(far) else None,
                max_pos_diff_m=float(d.max()),
                first_keyframe_differing=kf,
                keyframes=[a["keyframes"][:kf + 2 if kf is not None else 4],
                           b["keyframes"][:kf + 2 if kf is not None else 4]],
                lost=[lost(a), lost(b)], events=[a["events"], b["events"]])


def small_vs_cpu(n: int = 96) -> None:
    """The headline configuration at 240x320 / 600 features over the first
    ``n`` of its 192 frames on the card against the CPU twins."""
    import dataclasses

    from visual_sgraphs_tpu_torch import main_path
    from visual_sgraphs_tpu_torch.config import OrbConfig, TrackingConfig
    from visual_sgraphs_tpu_torch.slam.frame import make_frame_obs

    scene, frames = main_path.frames("cpu", main_path.BENCH_FRAMES, 240, 320)
    frames = frames[:n]
    cfg = dataclasses.replace(main_path.bench_config(scene),
                              orb=OrbConfig(n_features=600))
    _, card_frames = main_path.frames("cuda", main_path.BENCH_FRAMES, 240,
                                      320)
    card_frames = card_frames[:n]
    gray_diff = torch.stack([(a[0].cpu() - b[0]).abs()
                             for a, b in zip(card_frames, frames)])
    depth_diff = max(float((a[1].cpu() - b[1]).abs().max())
                     for a, b in zip(card_frames, frames))
    # the front end: each frame's ORB on the card (K1-K4) and on the CPU
    # twins, from the same CPU-rendered image
    kp_frames, desc_bytes, first_kp = 0, 0, None
    for i, (g, d, _, _, ts) in enumerate(frames):
        c = make_frame_obs(g.cuda(), d.cuda(), ts, cfg.camera, cfg.orb)
        p = make_frame_obs(g, d, ts, cfg.camera, cfg.orb)
        same_kp = (torch.equal(c.uv.cpu(), p.uv)
                   and torch.equal(c.valid.cpu(), p.valid))
        if not same_kp:
            kp_frames += 1
            first_kp = i if first_kp is None else first_kp
        else:
            desc_bytes += int((c.desc.cpu() != p.desc).sum())
    _line("small_front_end", frames=n,
          render_gray_max_abs_diff=float(gray_diff.max()),
          render_gray_share_differing=float((gray_diff > 0).float().mean()),
          render_gray_share_over_1=float((gray_diff > 1).float().mean()),
          render_depth_max_abs_diff_m=depth_diff,
          frames_with_keypoints_differing=kp_frames,
          first_frame_keypoints_differ=first_kp,
          desc_bytes_differing_where_keypoints_equal=desc_bytes)
    on_card = [tuple(x.cuda() if torch.is_tensor(x) else x for x in f)
               for f in frames]
    serial = dataclasses.replace(cfg, tracking=TrackingConfig())
    runs = {}
    for tag, dev, c, fr in (("cpu", "cpu", cfg, frames),
                            ("card_a", "cuda", cfg, on_card),
                            ("card_b", "cuda", cfg, on_card),
                            ("card_rendered", "cuda", cfg, card_frames),
                            ("cpu_card_rendered", "cpu", cfg, [tuple(
                                x.cpu() if torch.is_tensor(x) else x
                                for x in f) for f in card_frames]),
                            ("cpu_serial", "cpu", serial, frames),
                            ("card_serial", "cuda", serial, on_card)):
        t0 = time.perf_counter()
        runs[tag] = rec = _run_record(main_path.make_system(c, dev, True), fr)
        _line("small_run", run=tag, seconds=time.perf_counter() - t0,
              tracked=int(rec["tracked"].sum()), events=rec["events"])
    for tag, against in (("card_a", "cpu"), ("card_b", "cpu"),
                         ("card_rendered", "cpu"), ("card_b", "card_a"),
                         ("card_rendered", "cpu_card_rendered"),
                         ("card_serial", "cpu_serial"),
                         ("cpu_serial", "cpu")):
        _line("small_parting", run=tag, against=against,
              **_parting(runs[tag], runs[against]))


def kernel_times() -> None:
    """The kernels' checks that carry a device time, one line each."""
    import subprocess
    from visual_sgraphs_tpu_torch import cuda, selfcheck
    cuda.build()
    dev = torch.device("cuda")
    for check in (selfcheck.check_group, selfcheck.check_pose_gn,
                  selfcheck.check_pose_gn_prior,
                  selfcheck.check_match_window,
                  selfcheck.check_track_pass_seeded, selfcheck.check_vi_pose):
        r = check(dev)
        _line("kernel_times", **{k: r.get(k) for k in (
            "name", "ok", "max_abs_err", "ms", "device_ms", "library_ms",
            "library_device_ms", "plain_ms", "launches_per_call",
            "failed")})
    kernel_breakdown(dev)
    wrapper_host(dev)
    _line("card", nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


def wrapper_host(dev, reps: int = 200) -> None:
    """Host ms of one wrapper call (median, the host clock around the call
    alone, the device synchronised between calls) of the tracking pass and
    of K6, with their C call and with it replaced by a no-op: the CUDA-event
    ms of a latency-bound kernel is mostly this."""
    import statistics

    from visual_sgraphs_tpu_torch import cuda
    from visual_sgraphs_tpu_torch.features import match
    from visual_sgraphs_tpu_torch.selfcheck import (pose_inputs,
                                                    track_pass_inputs)
    from visual_sgraphs_tpu_torch.slam import tracking
    args = track_pass_inputs(dev)
    T0, xw, uv, valid, K, depth, bf = pose_inputs(dev)
    calls = dict(
        track_pass=lambda: match.track_pass(*args[:6], 15.0, args[6]),
        pose_gn=lambda: tracking.pose_only_gn(T0, xw, uv, valid, K, iters=12,
                                              gate0=900.0, depth=depth,
                                              bf=bf))

    def host_ms(fn):
        for _ in range(10):
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return 1e3 * statistics.median(times)

    out = {name: host_ms(fn) for name, fn in calls.items()}
    real = cuda.call
    cuda.call = lambda *a: None
    try:
        out.update({name + "_without_c_call": host_ms(fn)
                    for name, fn in calls.items()})
    finally:
        cuda.call = real
    _line("wrapper_host_ms", **out)


def kernel_breakdown(dev) -> None:
    """Device ms of one tiny kernel (the floor of ``device_time``), of K6
    at 4096 stereo matches against its iterations and its cluster's size,
    and of K9 at the global BA's shape against its slices, and on an
    empty list (the fills and the launch alone)."""
    from visual_sgraphs_tpu_torch.parallel import dist_ba
    from visual_sgraphs_tpu_torch.selfcheck import (
        GROUP_CASES, device_time, group_inputs, pose_inputs)
    from visual_sgraphs_tpu_torch.slam import tracking
    T0, xw, uv, valid, K, depth, bf = pose_inputs(dev)
    one = torch.zeros(1, device=dev)
    _line("device_time_floor", one_tiny_kernel_ms=device_time(
        lambda: one.add_(1.0)))
    plan = tracking.pose_gn_plan
    rows = {}
    try:
        for cluster in (1, 2, 4, 8):
            chunk = -(-xw.shape[0] // cluster)
            tracking.pose_gn_plan = lambda M, c=cluster, k=chunk: \
                tracking.PoseGnPlan(
                    c, k, -(-tracking.POSE_GN_BYTES * k // 16) * 16)
            for iters in (1, 2, 12):
                rows[f"cluster{cluster}_iters{iters}"] = device_time(
                    lambda: tracking.pose_only_gn(
                        T0, xw, uv, valid, K, iters=iters, gate0=900.0,
                        depth=depth, bf=bf))
    finally:
        tracking.pose_gn_plan = plan
    _line("pose_gn_breakdown", device_ms=rows)
    kw, n_pt, O = GROUP_CASES["global"]
    args = group_inputs(dev, **kw)
    empty = group_inputs(dev, **GROUP_CASES["empty"][0])
    slices = dist_ba.GROUP_SLICES
    rows = {}
    try:
        for s in (4, 8, 16, 32):
            dist_ba.GROUP_SLICES = s
            rows[f"slices{s}"] = device_time(
                lambda: dist_ba.group_observations(*args, n_pt, O))
            rows[f"slices{s}_empty"] = device_time(
                lambda: dist_ba.group_observations(*empty, n_pt, O))
    finally:
        dist_ba.GROUP_SLICES = slices
    _line("group_breakdown", device_ms=rows)


def _ops_by_name(fn) -> dict:
    """{device operation: count} of one call of ``fn``, and {aten
    operation: count} of the operations that launched device work
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    return dict(
        by_name={e.key[:70]: e.count for e in avg
                 if getattr(e, "device_time_total", 0) > 0
                 and e.device_type == torch.autograd.DeviceType.CUDA},
        by_op={e.key: e.count for e in avg
               if e.key.startswith("aten::")
               and getattr(e, "self_device_time_total", 0) > 0})


def track_ops(n_frames: int = 96) -> None:
    """Device operations, device ms (``selfcheck.device_ops``) and
    CUDA-event ms of one tracking call on ``bench_slice``'s map after
    ``n_frames`` frames, at the next frame from the system's last pose
    with the batch's local table (``tracking._track_frame_impl``: both
    passes, no retry; as the tree's scan calls it), and of one
    ``make_frame_scan`` batch over the next 8 frames (ORB for the batch,
    both attempts a frame)."""
    from visual_sgraphs_tpu_torch import cuda, main_path, selfcheck
    from visual_sgraphs_tpu_torch.slam import tracking
    from visual_sgraphs_tpu_torch.slam.frame import make_frame_obs
    cuda.build()
    scene, frames = main_path.frames("cuda", main_path.BENCH_FRAMES)
    cfg = main_path.bench_config(scene)
    system = main_path.make_system(cfg, "cuda", True)
    for frame in frames[:n_frames]:
        main_path.feed(system, frame)
    system.flush()
    torch.cuda.synchronize()
    t, n_window = cfg.tracking, cfg.mapping.local_window
    m, ref, K, bf = system.map, system.ref_kf_host, system.cam_K, \
        system.cam_bf
    wh = (cfg.camera.width, cfg.camera.height)
    table = tracking._local_point_table(m, ref, n_window, 4096)
    gray, depth, _, _, ts = frames[n_frames]
    obs = make_frame_obs(gray, depth, ts, cfg.camera, cfg.orb)
    T_pred = system.last_pose

    def one():
        return tracking._track_frame_impl(
            m, obs, T_pred, ref, K, n_window, 4096, t.match_radius_coarse,
            t.match_radius_fine, bf, wh, local_table=table)

    B = t.pipeline_depth
    batch = frames[n_frames:n_frames + B]
    grays = torch.stack([f[0] for f in batch])
    depths = torch.stack([f[1] for f in batch])
    scan = tracking.make_frame_scan(cfg.camera, cfg.orb, n_window, 4096,
                                    t.match_radius_coarse,
                                    t.match_radius_fine, True, B)

    def one_batch():
        return scan(m, grays, depths, [f[4] for f in batch], system.last_pose,
                    system.velocity, ref, K, t.min_inliers_ok, bf)

    res = one()
    _line("track_ops", call="_track_frame_impl", frame=n_frames,
          n_local=int(res.n_local_pts), n_matches=int(res.n_matches),
          n_inliers=int(res.n_inliers), **selfcheck.device_ops(one),
          ms=selfcheck.time_cuda(one),
          device_span_ms=selfcheck.device_time(one), **_ops_by_name(one))
    one_batch()
    _line("track_ops", call="make_frame_scan", frames=f"{n_frames}-"
          f"{n_frames + B - 1}", **selfcheck.device_ops(one_batch),
          ms=selfcheck.time_cuda(one_batch, reps=5),
          **_ops_by_name(one_batch))


def k20_sections() -> None:
    """K20's clock at its section boundaries (``selfcheck.vi_pose_sections``)
    and its device time, with the card's SM clock."""
    import subprocess
    from visual_sgraphs_tpu_torch import cuda, selfcheck
    from visual_sgraphs_tpu_torch.inertial import pipeline
    cuda.build()
    dev = torch.device("cuda")
    r = selfcheck.vi_pose_sections(dev)
    args = selfcheck.vi_pose_inputs(dev)
    r["device_ms"] = selfcheck.device_time(
        lambda: pipeline.pose_inertial_gn(*args))
    r["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _line("k20_sections", **r)


def _record_schur_windows(path: str) -> None:
    """The operands of ``bench_slice``'s 17th K8 call from a scene-graph BA
    (96 frames) and of the K22a reductions of ``inertial_slice``'s fourth
    VI local BA and last generic local BA (96 frames), saved as plain
    tensors."""
    from visual_sgraphs_tpu_torch import main_path, selfcheck
    from visual_sgraphs_tpu_torch.optim import fast_ba
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    out, seen = {}, {"calls": 0}
    orig = fast_ba.local_reduced_system

    def spy(*a, **kw):
        seen["calls"] += 1
        if seen["calls"] <= 17:
            out["k8"] = [t.clone() for t in a[:7]]
        return orig(*a, **kw)

    scene, frames = main_path.frames("cuda", main_path.BENCH_FRAMES)
    system = main_path.make_system(main_path.bench_config(scene), "cuda",
                                   True)
    fast_ba.local_reduced_system = spy
    try:
        for frame in frames[:96]:
            main_path.feed(system, frame)
        system.flush()
    finally:
        fast_ba.local_reduced_system = orig
    del system
    vi_scene, vi_frames = main_path.inertial_frames("cuda")
    system = main_path.make_system(main_path.inertial_config(vi_scene),
                                   "cuda", False)
    with selfcheck.watch_lm_windows(system, which=4) as lm_seen:
        for frame in vi_frames[:96]:
            main_path.feed_inertial(system, frame)
    problems = selfcheck.lm_problems(selfcheck.lm_windows(lm_seen))
    for tag in ("vi", "lba"):
        p = problems[tag]
        out[tag] = dict(pose=p["red"].pose, pts=p["pts"], cam=p["cam"],
                        bf=p["bf"], D=lmk.offsets(p["red"])["D"],
                        **p["rows"]._asdict())
    torch.save(out, path)


def schur_times(path: str) -> None:
    """K8 and K22a's reduction: CUDA-event and device ms, device
    operations a call and launch-to-launch bitwise equality, on seeded
    operands and on the windows recorded in ``path``."""
    import inspect
    import os
    import subprocess
    from visual_sgraphs_tpu_torch import cuda, selfcheck
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    from visual_sgraphs_tpu_torch.parallel import dist_ba
    cuda.build()
    dev = torch.device("cuda")
    if not os.path.exists(path):
        _record_schur_windows(path)
    rec = torch.load(path)

    def measure(name, fn, **info):
        first = fn()
        again = [fn() for _ in range(3)]
        flat = lambda o: [t for t in o if isinstance(t, torch.Tensor)]  # noqa
        repro = all(torch.equal(a, b) for o in again
                    for a, b in zip(flat(first), flat(o)))
        prof = selfcheck.device_ops(fn)
        _line("schur_times", name=name, ms=selfcheck.time_cuda(fn),
              device_ms=selfcheck.device_time(fn), device_ops=prof["ops"],
              profiled_device_ms=prof["device_ms"], bitwise_repro=repro,
              **info)

    kw = dict(lam=1e-4, huber=2.45)
    for n, O, L in ((8192, 12, 11), (32768, 8, 128)):
        args = selfcheck.schur_inputs(dev, n, O, L)
        measure(f"K8@L{L}", lambda: dist_ba.local_reduced_system(*args, **kw),
                n=n, O=O, L=L)
    args = rec["k8"]
    measure("K8@window", lambda: dist_ba.local_reduced_system(*args, **kw),
            n=args[2].shape[0], O=args[2].shape[1], L=args[0].shape[0],
            observed=int(args[4].any(dim=1).sum()))
    with_plan = "plan" in inspect.signature(lmk.lm_reproj_reduce).parameters
    for tag in ("vi", "lba"):
        w = rec[tag]
        rows = lmk.ReprojRows(*(w[k] for k in lmk.ReprojRows._fields))
        N = w["pts"].shape[0]
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        extra = (lmk.lm_reproj_plan(rows, N),) if with_plan else ()
        measure(f"K22a@{tag}", lambda: lmk.lm_reproj_reduce(
            w["pose"], w["pts"], rows, w["cam"], w["bf"], lam, w["D"],
            *extra), L=w["pose"].shape[0], N=N, M=rows.slot.shape[0],
            rows_used=int(rows.use.sum()), plan_given=with_plan)
        if with_plan:
            measure(f"K22a_plan@{tag}", lambda: lmk.lm_reproj_plan(rows, N))
    _line("card", nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenegraph", action="store_true",
                    help="attach the scene graph")
    ap.add_argument("--bench", action="store_true",
                    help="profile the headline configuration (B-frame "
                    "pipeline, loops and scene graph on)")
    ap.add_argument("--inertial", action="store_true",
                    help="profile the inertial row (Sensor.IMU_RGBD)")
    ap.add_argument("--freespace", action="store_true",
                    help="profile the scene graph with free-space rooms")
    ap.add_argument("--loop-runs", type=int, default=0,
                    help="run the loop path this many times instead")
    ap.add_argument("--small-vs-cpu", action="store_true",
                    help="the headline configuration at 240x320 on the "
                    "card against the CPU twins, frame by frame")
    ap.add_argument("--cells", action="store_true",
                    help="fps of the serial cells, bench_slice and "
                    "inertial_slice")
    ap.add_argument("--track-ops", action="store_true",
                    help="device operations of one tracking call and one "
                    "scan batch on bench_slice's map")
    ap.add_argument("--k20-sections", action="store_true",
                    help="K20's time by section (clock64)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="K9, K6, K6's prior, K5's window matcher, the "
                    "tracking pass and K20: CUDA-event and device times")
    ap.add_argument("--schur-times", metavar="PATH", default=None,
                    help="K8 and K22a's reduction: times, device operations "
                    "and bitwise repeats (windows recorded into PATH)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.small_vs_cpu:
        small_vs_cpu()
    elif args.cells:
        cells_fps()
    elif args.kernel_times:
        kernel_times()
    elif args.track_ops:
        track_ops()
    elif args.k20_sections:
        k20_sections()
    elif args.schur_times:
        schur_times(args.schur_times)
    elif args.loop_runs:
        loop_spread(args.loop_runs)
    else:
        profile(args.scenegraph, args.bench, args.inertial, args.freespace)


if __name__ == "__main__":
    main()
