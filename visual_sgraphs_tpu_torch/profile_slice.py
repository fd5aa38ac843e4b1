"""Where the time goes on the card: one profiled window of the slice.

    python -m visual_sgraphs_tpu_torch.profile_slice [--scenegraph]
    python -m visual_sgraphs_tpu_torch.profile_slice --bench
    python -m visual_sgraphs_tpu_torch.profile_slice --inertial
    python -m visual_sgraphs_tpu_torch.profile_slice --freespace
    python -m visual_sgraphs_tpu_torch.profile_slice --loop-runs N
    python -m visual_sgraphs_tpu_torch.profile_slice --small-vs-cpu
    python -m visual_sgraphs_tpu_torch.profile_slice --cells
    python -m visual_sgraphs_tpu_torch.profile_slice --kernel-times
    python -m visual_sgraphs_tpu_torch.profile_slice --orb-times
    python -m visual_sgraphs_tpu_torch.profile_slice --compact-times PATH
    python -m visual_sgraphs_tpu_torch.profile_slice --other-times
    python -m visual_sgraphs_tpu_torch.profile_slice --track-ops
    python -m visual_sgraphs_tpu_torch.profile_slice --k20-sections
    python -m visual_sgraphs_tpu_torch.profile_slice --schur-times PATH
    python -m visual_sgraphs_tpu_torch.profile_slice --sg-times PATH
    python -m visual_sgraphs_tpu_torch.profile_slice --place-times PATH
    python -m visual_sgraphs_tpu_torch.profile_slice --assoc-guided-times PATH

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
times them, the keyframe program's mean host ms (a cycle's on
``bench_slice``, the VI local BA's on ``inertial_slice``), and a digest
of each cell's final ``kf_obs_pt``.  To compare two
trees on one card, run this file by path with ``PYTHONPATH`` set to the
other tree's root: the package and kernels are then that tree's.  With
``--kernel-times`` it runs ``selfcheck``'s checks of K9, K6, K6's prior
branch, K5's window matcher, the tracking pass (seeded operands, the
coarse radius) and K20 at the main path's shapes and prints
each one's CUDA-event and device times (``selfcheck.device_time``) beside
its library call's, K7's two entries and ``fuse_observations``' match at
4 px (``compact_fuse_times``; alone with ``--compact-times PATH``, the
operands recorded into PATH, or loaded from it when it exists), the host
ms of the tracking pass's and K6's wrappers (``wrapper_host``), the
device ms and device operations of K18 without
and with the pose prediction, of the prediction alone, of K3 over a
batch's 8 levels and one frame's (beside ``torch.topk`` of the cells)
(``inertial_front_times``), of K22b's plan, rows and cost on the VI and
initialisation problems as the solves call them (``k22b_times``), of
K22b's rows with the edge index staged in shared memory and read from
global memory (``k22b_index_times``), of K1's blur (beside its library
yardstick), K17a and K22a's cost without a step, with a zero step and
with a solve's step on the VI and generic local BA problems
(``other_device_times``; alone with ``--other-times``) and of K2, K4 and
the whole ``extract_orb`` at B = 8 and B = 1, with their host ms
(``orb_front_times``; alone with ``--orb-times``), and the card's name
and power limit.  With
``--track-ops`` it counts the device operations of one tracking call
(both passes) and of one pipeline scan batch on ``bench_slice``'s map
(``track_ops``), and of a keyframe's map maintenance there: the cycle's
fold, the keyframe program's insertion, fusion and culls, and a serial
frame's point stats (``kf_maintenance_ops``); with ``--k20-sections`` it reads K20's clock at its
section boundaries (``selfcheck.vi_pose_sections``).  With
``--schur-times PATH`` it times the two landmark Schur reductions, K8
(``dist_ba.local_reduced_system``: seeded at L = 11 and 128, and on the
tables of ``bench_slice``'s 17th scene-graph BA call) and K22a's
reduction (``lm_kernels.lm_reproj_reduce`` on ``inertial_slice``'s fourth
VI local BA, and its last generic local BA), each with its CUDA-event
and device ms, its device operations a call and whether three launches
agree bitwise, K8's back-substitution on the ``bench_slice`` window
against the float64 twin (``_backsub_errors``), and a Schur BA
iteration's damped solve and retraction (K26, ``dist_ba.ba_solve``; on a
tree without it the plain ``solve_damped`` and retraction chain,
``_damped_step``) on ``bench_slice``'s 17th scene-graph BA iteration and
on seeded systems at D = 66, 402 and 768; the windows are recorded into
PATH (a ``torch.save``
of plain tensors) when it does not exist, so that two trees are timed on
the same operands.  With ``--sg-times PATH`` it times K21 (the scene-graph
BA iteration's assembly, its kernel and plan) and K13 on seeded operands
and on ``bench_slice``'s, recorded into PATH likewise (``sg_times``).
With ``--place-times PATH`` it times K11 (the keyframe program's database
step and the relocalisation's query) on a ``bench_slice`` keyframe's
operands and seeded ones, and K5's NN ratio on ``bench_slice``'s first
loop verification's operands and at its three seeded call shapes,
recorded into PATH likewise (``place_times``).  With
``--assoc-guided-times PATH`` it times K16 (loop verification's guided
re-match count from the refined Sim3 on: this tree's one launch, or the
former rows' validity, projection, gate and count) on ``bench_slice``'s
first loop verification's operands and seeded ones, and K24 (plane
association) on ``bench_slice``'s eighth plane association's operands
and a seeded case, recorded into PATH likewise (``assoc_guided_times``).
Prints one JSON line per result; needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import hashlib
import json
import pstats
import statistics
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
    stage's mean ms (on ``inertial_slice`` the VI local BA's, ``vi_lba``,
    and the initialisation's attempts in the warm-up, ``imu_init``), the
    ORB extraction's mean ms, the tracked frames and the ATE."""
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
                warm_stages = system.timers.summary()
                system.timers.reset()
            feed(system, frame)
        system.flush()
        torch.cuda.synchronize()
        out[tag] = (len(fr) - lo) / (time.perf_counter() - t0)
        stages = system.timers.summary()
        out[tag + "_kf_ms"] = stages.get(stage, {}).get("mean_ms")
        out[tag + "_orb_extract_ms"] = stages.get("orb_extract", {}).get(
            "mean_ms")
        out[tag + "_tracked"], out[tag + "_ate_m"] = _cell_ate(
            system, fr, 2 if feed is main_path.feed_inertial else 3)
        out[tag + "_kf_obs_pt_sha256"] = hashlib.sha256(
            system.map.kf_obs_pt.cpu().numpy().tobytes()).hexdigest()[:16]
        if stage == "vi_lba":
            init = warm_stages.get("imu_init", {})
            out[tag + "_imu_init_ms"] = init.get("mean_ms")
            out[tag + "_imu_init_attempts"] = init.get("count")
    _line("cells_fps", **out)


def _cell_ate(system, frames, pose_at: int) -> tuple[int, float]:
    """Tracked frames and the ATE of the tracked frames' camera centres
    against the frames' ground truth (``frame[pose_at]``, T_wc)."""
    from visual_sgraphs_tpu_torch.core import geometry
    gt = np.stack([np.asarray(f[pose_at])[4:7] for f in frames])
    pos, tracked = system.positions(), system.tracked_mask()
    return int(tracked.sum()), float(geometry.ate_rmse(
        torch.from_numpy(pos[tracked]), torch.from_numpy(gt[tracked]))[0])


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
    compact_fuse_times(dev)
    wrapper_host(dev)
    inertial_front_times(dev)
    problems = selfcheck.lm_problems(selfcheck.lm_window(dev))
    k22b_times(dev, problems)
    k22b_index_times(dev, problems)
    other_device_times(dev, problems)
    orb_front_times(dev)
    _card_line()


def _card_line() -> None:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    import subprocess
    _line("card", nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


def _times(name: str, fn, **info) -> None:
    """One ``kernel_times`` line: CUDA-event ms, device ms and the device
    operations of one call of ``fn``."""
    from visual_sgraphs_tpu_torch import selfcheck
    fn()
    prof = selfcheck.device_ops(fn)
    _line("kernel_times", name=name, ms=selfcheck.time_cuda(fn),
          device_ms=selfcheck.device_time(fn), device_ops=prof["ops"],
          profiled_device_ms=prof["device_ms"], **info)


def inertial_front_times(dev) -> None:
    """K18 on ``selfcheck.preint_inputs`` (frame 30 of the inertial row, 7
    valid samples of 64) without and with the pose prediction, and the
    prediction alone (``pipeline.predict_state``); K3 over the 8 levels of
    a batch of 8 rendered 480x640 frames and of one frame (1000
    features), beside ``torch.topk`` of the levels' cells.  A tree
    without the fused entries (K18 with the
    prediction, K3 over all levels) is timed through the calls its main
    path makes instead: K18 then ``predict_state``, K3 once a level."""
    from visual_sgraphs_tpu_torch import selfcheck
    from visual_sgraphs_tpu_torch.config import ImuConfig
    from visual_sgraphs_tpu_torch.core import lie
    from visual_sgraphs_tpu_torch.features import fast, orb, pyramid
    from visual_sgraphs_tpu_torch.inertial import pipeline
    from visual_sgraphs_tpu_torch.inertial import preintegration as pre
    since, tab, bg, ba = selfcheck.preint_inputs(dev)
    T_bc = torch.tensor(ImuConfig().T_bc, dtype=torch.float32, device=dev)
    T_cw = lie.se3_exp(torch.tensor([0.3, -0.2, 1.1, 0.05, -0.4, 0.2],
                                    device=dev))
    v = torch.tensor([0.4, -0.1, 0.05], device=dev)
    window = pre.preintegrate_merge(since, tab, bg, ba)[0]
    n_valid = int((tab[:, 7] != 0).sum())
    if hasattr(pre, "preint_frame"):
        vec = pre.pack(since).contiguous()
        k18 = lambda: pre.preint_frame(vec, tab, bg, ba)  # noqa: E731
        k18_pred = lambda: pre.preint_frame(  # noqa: E731
            vec, tab, bg, ba, pose=(T_cw, v, T_bc))
    else:
        k18 = lambda: pre.preintegrate_merge(since, tab, bg, ba)  # noqa
        k18_pred = lambda: pipeline.predict_state(  # noqa: E731
            T_cw, v, k18()[0], T_bc)
    _times("K18", k18, valid_samples=n_valid)
    _times("K18+prediction", k18_pred, valid_samples=n_valid)
    _times("predict_state", lambda: pipeline.predict_state(
        T_cw, v, window, T_bc))

    params = orb.OrbParams()
    budgets = orb.level_budgets(params)
    cs = params.cell_size
    grays = selfcheck.batch_frames(dev)
    for tag, g in (("B8", grays), ("B1", grays[0])):
        levels = pyramid.build_pyramid_torch(g, params.n_levels,
                                             params.scale)
        scores = [fast.fast_nms_torch(lv) for lv in levels]
        if hasattr(orb, "detect_levels"):
            k3 = lambda s=scores: orb.detect_levels(  # noqa: E731
                s, budgets, params)
        else:
            k3 = lambda s=scores: [  # noqa: E731
                orb.detect_level(x, b, params) for x, b in zip(s, budgets)]
        cells = []
        for sc in scores:
            x = sc.reshape(-1, *sc.shape[-2:])
            B, h, w = x.shape
            ncy, ncx = -(-h // cs), -(-w // cs)
            p = torch.nn.functional.pad(x, (0, ncx * cs - w, 0, ncy * cs - h))
            cells.append(p.reshape(B, ncy, cs, ncx, cs).permute(
                0, 1, 3, 2, 4).reshape(B, ncy * ncx, cs * cs).contiguous())
        _times(f"K3@{tag}", k3)
        _times(f"K3_library@{tag}", lambda c=cells: [
            torch.topk(x, 2, dim=-1) for x in c])



def k22b_times(dev, problems: dict) -> None:
    """K22b's rows and cost as the solves call them: on the VI local BA
    problem (9 edges, D = 150; the rows added into a float64 H and the
    cost into a float64 sum, as after K22a) and on the initialisation
    problem (H, g and the cost written whole), both of
    ``selfcheck.lm_problems``, and the plan (W and the edge index, once a
    solve).  A tree without the plan is timed through its own calls."""
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    has_plan = hasattr(lmk, "lm_inertial_plan")
    for tag in ("vi", "init"):
        imu, red = problems[tag]["imu"], problems[tag]["red"]
        D = lmk.offsets(red)["D"]
        info = dict(edges=int(imu.valid.sum()), E=imu.edge.shape[0], D=D)
        kw = {}
        if has_plan:
            kw["plan"] = lmk.lm_inertial_plan(imu, red)
            _times(f"K22b_plan@{tag}", lambda: lmk.lm_inertial_plan(
                imu, red), **info)
        f64 = dict(dtype=torch.float64, device=dev)
        if tag == "vi":
            H, g = torch.zeros((D, D), **f64), torch.zeros((D,), **f64)
            acc = torch.zeros((), **f64)
        else:
            H = g = acc = None
        _times(f"K22b_rows@{tag}", lambda: lmk.lm_inertial_assemble(
            imu, red, H, g, **kw), **info)
        _times(f"K22b_cost@{tag}", lambda: lmk.lm_inertial_cost(
            imu, red, acc, **kw), **info)


def k22b_index_times(dev, problems: dict, reps: int = 60) -> None:
    """K22b's rows as the solves call them with the plan's edge index
    staged in shared memory (s) and read from global memory (g), in the
    order s, g, g, s, on the VI, initialisation and 100-edge problems."""
    from visual_sgraphs_tpu_torch import selfcheck
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    staged = lmk._IX_SHARED_BYTES
    f64 = dict(dtype=torch.float64, device=dev)
    try:
        for rnd, mode in enumerate("sggs"):
            lmk._IX_SHARED_BYTES = staged if mode == "s" else 0
            for tag in ("vi", "init", "init_x100"):
                imu, red = problems[tag]["imu"], problems[tag]["red"]
                plan = lmk.lm_inertial_plan(imu, red)
                D = lmk.offsets(red)["D"]
                H = g = None
                if tag == "vi":
                    H = torch.zeros((D, D), **f64)
                    g = torch.zeros((D,), **f64)

                def fn(imu=imu, red=red, H=H, g=g, plan=plan):
                    return lmk.lm_inertial_assemble(imu, red, H, g, plan)

                _line("kernel_times", name=f"K22b_rows_index@{tag}",
                      round=rnd, index=mode, staged_ints=plan.args.solve.ix,
                      device_ms=selfcheck.device_time(fn, reps=reps),
                      ms=selfcheck.time_cuda(fn, reps=reps))
    finally:
        lmk._IX_SHARED_BYTES = staged


def orb_front_times(dev) -> None:
    """K2 and K4 over one ORB extraction (480x640, 1000 features), at
    B = 8 (a batch of rendered frames, as the pipeline extracts it) and
    B = 1, and the whole ``extract_orb``: CUDA-event ms, device ms
    (``selfcheck.device_time``), host ms (the first less the second) and
    device operations (the nodes of a CUDA graph captured from the call,
    ``selfcheck.graph_ops``), and the host ms of the call alone
    (``host_call_ms``: the host clock around it, the device synchronised
    before each; the event less device ms hides the host's time wherever
    the device is the busier).  K4 reads the twins' keypoints and blurred
    levels and writes the extraction's arrays.  A tree without the
    one-launch entries (``fast_levels``, ``orb_describe_levels``) is timed
    through the per-level calls its ``extract_orb`` makes."""
    from visual_sgraphs_tpu_torch import selfcheck
    from visual_sgraphs_tpu_torch.features import fast, orb, pyramid
    params = orb.OrbParams()
    budgets = orb.level_budgets(params)
    pattern = orb.brief_pattern_tensor(params.pattern_seed, dev)
    grays = selfcheck.batch_frames(dev)
    for tag, g in (("B8", grays), ("B1", grays[0])):
        levels = pyramid.build_pyramid_torch(g, params.n_levels,
                                             params.scale)
        kp = orb.detect_levels_torch(
            [fast.fast_nms_torch(lv) for lv in levels], budgets, params)
        blurred = [pyramid.gaussian_blur_torch(lv) for lv in levels]
        angle = torch.empty(kp.response.shape, device=dev)
        desc = torch.empty((*kp.response.shape, 32), dtype=torch.uint8,
                           device=dev)
        if hasattr(fast, "fast_levels"):
            def k2(lv=levels):
                return fast.fast_levels(lv)

            def k4(bl=blurred, rc=kp.rc, a=angle, d=desc):
                return orb.orb_describe_levels(bl, rc, budgets, pattern,
                                               out=(a, d))
        else:
            def k2(lv=levels):
                return [fast.fast_nms(x) for x in lv]

            def k4(bl=blurred, rc=kp.rc, a=angle, d=desc):
                off = 0
                for x, b in zip(bl, budgets):
                    rows = slice(off, off + b)
                    orb.orb_describe(x, rc[..., rows, :], pattern,
                                     out=(a[..., rows], d[..., rows, :]))
                    off += b

        for name, fn in (("K2", k2), ("K4", k4), ("extract_orb", lambda x=g:
                                                 orb.extract_orb(x, params))):
            ms = selfcheck.time_cuda(fn)
            dev_ms = selfcheck.device_time(fn)
            _line("orb_front_times", name=f"{name}@{tag}", ms=ms,
                  device_ms=dev_ms, host_ms=ms - dev_ms,
                  host_call_ms=_host_call_ms(fn),
                  device_ops=selfcheck.graph_ops(fn),
                  keypoints=int(kp.response.numel()))


def _host_call_ms(fn, reps: int = 200) -> float:
    """Median host ms of one call of ``fn`` (the host clock around the
    call alone, the device synchronised before each)."""
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


def _device_line(name: str, fn, **info) -> None:
    """One ``other_device_times`` line: device ms
    (``selfcheck.device_time``) and device operations (the nodes of a
    CUDA graph captured from one call, ``selfcheck.graph_ops``: the
    profiler can lose ctypes launches) of one call of ``fn``."""
    from visual_sgraphs_tpu_torch import selfcheck
    _line("other_device_times", name=name,
          device_ms=selfcheck.device_time(fn),
          device_ops=selfcheck.graph_ops(fn), **info)


def other_device_times(dev, problems: dict) -> None:
    """Device ms and device operations (``_device_line``) of K1's blur over
    the 8 levels of a batch of 8 rendered 480x640 frames and of one frame
    (``gaussian_blur_levels``, one launch; a tree without it: a
    ``gaussian_blur`` call a level) beside its library yardstick (a
    separable ``F.conv2d`` pair a level on replicate-padded levels), of
    K17a on a rendered frame, and of K22a's back-substitution and cost on
    the VI and generic local BA problems as a solve calls it: without a
    step (the initial cost), with a zero step and with the step of the
    kernel route's own solve at lambda 1e-4, given the solve's row plan (a
    tree whose ``lm_reproj_cost`` takes no ``plan``: its own call)."""
    import inspect

    from visual_sgraphs_tpu_torch import selfcheck
    from visual_sgraphs_tpu_torch.features import orb, pyramid
    from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
    from visual_sgraphs_tpu_torch.scenegraph import freespace as fs
    F_ = torch.nn.functional
    params = orb.OrbParams()
    grays = selfcheck.batch_frames(dev)
    taps = pyramid._blur_taps_on(7, 2.0, dev)
    for tag, g in (("B8", grays), ("B1", grays[0])):
        levels = pyramid.build_pyramid_torch(g, params.n_levels,
                                             params.scale)
        if hasattr(pyramid, "gaussian_blur_levels"):
            blur = lambda lv=levels: pyramid.gaussian_blur_levels(lv)  # noqa
        else:
            blur = lambda lv=levels: [  # noqa: E731
                pyramid.gaussian_blur(x) for x in lv]

        def conv_blur(lv=levels):
            out = []
            for x in lv:
                x = F_.pad(x.reshape(-1, 1, *x.shape[-2:]), (3, 3, 3, 3),
                           mode="replicate")
                x = F_.conv2d(x, taps.reshape(1, 1, 7, 1))
                out.append(F_.conv2d(x, taps.reshape(1, 1, 1, 7)))
            return out

        px = sum(x.numel() for x in levels)
        _device_line(f"K1_blur@{tag}", blur, pixels=px)
        _device_line(f"K1_blur_library@{tag}", conv_blur, pixels=px)
    depth, T_cw, cam_K, origin = selfcheck.freespace_inputs(dev)
    grid = torch.zeros((32, 32, 32), dtype=torch.bool, device=dev)
    _device_line("K17a", lambda: fs.accumulate_freespace(
        grid, origin, 0.35, depth, T_cw, cam_K))
    with_plan = "plan" in inspect.signature(lmk.lm_reproj_cost).parameters
    for tag in ("vi", "lba"):
        p = problems[tag]
        red, rows, pts = p["red"], p["rows"], p["pts"]
        D = lmk.offsets(red)["D"]
        plan = lmk.lm_reproj_plan(rows, pts.shape[0])
        H, g, pairs, rhs, state = lmk.lm_reproj_reduce(
            red.pose, pts, rows, p["cam"], p["bf"], selfcheck._lam(pts), D,
            plan)
        if p.get("imu") is not None:
            H, g = lmk.lm_inertial_assemble(
                p["imu"], red, H, g, lmk.lm_inertial_plan(p["imu"], red))
        dx, cand = lmk.lm_solve(H, g, pairs, rhs, p["free"],
                                selfcheck._lam(pts), red)
        kw = dict(plan=plan) if with_plan else {}
        info = dict(M=rows.slot.shape[0], rows_used=int(rows.use.sum()),
                    N=pts.shape[0], L=red.pose.shape[0])
        for step, pose, d in (
                ("none", red.pose, None),
                ("zero", red.pose, torch.zeros_like(dx)),
                ("solve", cand.pose, dx)):
            _device_line(
                f"K22a_cost@{tag}:{step}",
                lambda pose=pose, d=d: lmk.lm_reproj_cost(
                    pose, pts, p["pt_fixed"], rows, p["cam"], p["bf"],
                    None if d is None else state, d, **kw), **info)


def _fuse_operands_spy(which: int = 8):
    """(spy, seen): a stand-in for ``mapping.fuse_observations`` that
    records a copy of the map, the keyframe and the camera at its
    ``which``-th call (``seen["operands"]``) and counts the calls."""
    from visual_sgraphs_tpu_torch.slam import mapping
    orig = mapping.fuse_observations
    seen = {"calls": 0}

    def spy(m, kf_id, cam_K, *args, **kw):
        seen["calls"] += 1
        if seen["calls"] == which:
            seen["operands"] = (type(m)(*(t.clone() for t in m)), int(kf_id),
                                cam_K.clone())
        return orig(m, kf_id, cam_K, *args, **kw)

    # a tree whose fuse_observations counts its calls does so on the name
    # it is bound to
    spy.cuda_calls = getattr(orig, "cuda_calls", 0)
    return spy, seen


def compact_fuse_times(dev, path: str | None = None) -> None:
    """K7 and ``fuse_observations``' match, each with its device ms
    (``selfcheck.device_time``), device operations (``selfcheck.graph_ops``),
    CUDA-event ms and host ms of the call alone (``_host_call_ms``):
    - K7's plain entry at the main path's three shapes (seeded 32768-entry
      masks: 8 % True and size 4096, 20 % and 8192, 90 % and 1000) beside
      ``torch.nonzero``'s CUDA-event ms (it synchronises: no device time);
    - a run of ``bench_slice`` (192 frames; its tracked frames, ATE and a
      digest of its final ``kf_obs_pt`` printed), which gives the operands
      below: its final map and the operands (map, keyframe, camera) of its
      eighth ``fuse_observations`` call; with ``path`` they are saved there
      (``torch.save``) when it does not exist and loaded from it when it
      does, so that two trees are timed on the same operands;
    - the tracking table's compaction on the final map at the reference
      keyframe's tracking keyframes (``mapping.lba_slots``), as the
      composition (``observed_mask`` & ``pt_valid``, ``compact_true``, the
      int32 cast) and as K7's observed entry;
    - on the fuse operands as recorded (``fuse``; on the synthetic scenes
      every keypoint with depth seeds a point, so the keyframe has no free
      keypoint) and with the keyframe's even keypoints unlinked
      (``fuse_unlinked``: their points stay in the covisible keyframes):
      the match at 4 px as K5's window matcher on the projected points and
      as the tracking pass (``mapping.fuse_candidates``' operands, no image
      gate, no depths), and the whole ``fuse_observations``, with a digest
      of the keyframe's new row and its links;
    - K5's window matcher at 4 px on the seeded window problem
      (``selfcheck.match_inputs``).
    A tree without ``compact_observed`` / ``fuse_candidates`` times only
    its own calls."""
    import os

    from visual_sgraphs_tpu_torch import main_path, selfcheck
    from visual_sgraphs_tpu_torch.core import cameras, lie
    from visual_sgraphs_tpu_torch.features import match
    from visual_sgraphs_tpu_torch.slam import map_state as ms
    from visual_sgraphs_tpu_torch.slam import mapping, tracking

    def line(name, fn, **info):
        _line("compact_fuse_times", name=name,
              device_ms=selfcheck.device_time(fn),
              device_ops=selfcheck.graph_ops(fn), ms=selfcheck.time_cuda(fn),
              host_call_ms=_host_call_ms(fn), **info)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    rng = np.random.default_rng(0)
    for tag, p, size in (("track", 0.08, 4096), ("lba", 0.2, 8192),
                         ("free", 0.9, 1000)):
        mask = torch.from_numpy(rng.uniform(size=32768) < p).to(dev)
        line(f"K7@{tag}", lambda m=mask, s=size: ms.compact_true(m, s),
             true_entries=int(mask.sum()), size=size,
             nonzero_ms=selfcheck.time_cuda(lambda m=mask: torch.nonzero(m)))

    scene, frames = main_path.frames(dev, main_path.BENCH_FRAMES)
    cfg = main_path.bench_config(scene)
    system = main_path.make_system(cfg, dev, True)
    orig = mapping.fuse_observations
    spy, seen = _fuse_operands_spy()
    mapping.fuse_observations = spy
    try:
        for frame in frames:
            main_path.feed(system, frame)
        system.flush()
    finally:
        mapping.fuse_observations = orig
        if hasattr(orig, "cuda_calls"):
            orig.cuda_calls = spy.cuda_calls
    tracked, ate = _cell_ate(system, frames, 3)
    _line("compact_fuse", cell="bench_slice", tracked=tracked, ate_m=ate,
          kf_obs_pt_sha256=sha(system.map.kf_obs_pt),
          fuse_calls=seen["calls"])
    mf, kf, cam = seen["operands"]
    rec = dict(map=system.map._asdict(), ref_kf=system.ref_kf_host,
               fuse_map=mf._asdict(), kf=kf, cam=cam)
    if path is not None:
        if os.path.exists(path):
            rec = torch.load(path, map_location=dev)
        else:
            torch.save(rec, path)
    m, mf = ms.MapState(**rec["map"]), ms.MapState(**rec["fuse_map"])
    kf, cam = rec["kf"], rec["cam"]
    kf_ids, kf_mask = mapping.lba_slots(m, rec["ref_kf"],
                                        cfg.mapping.local_window)
    info = dict(L=kf_ids.shape[0], rows=int(kf_mask.sum()),
                map_sha=sha(m.kf_obs_pt))
    line("K7_composition@bench_map", lambda: ms.compact_true(
        ms.observed_mask(m, kf_ids, kf_mask) & m.pt_valid, 4096).to(
            torch.int32), **info)
    if hasattr(ms, "compact_observed"):
        line("K7_observed@bench_map", lambda: ms.compact_observed(
            m, kf_ids, kf_mask, 4096, torch.int32), **info)

    unlinked = mf.kf_obs_pt.clone()
    unlinked[kf, ::2] = -1
    for tag, mk in (("fuse", mf),
                    ("fuse_unlinked", mf._replace(kf_obs_pt=unlinked))):
        counts = ms.covisibility_counts(mk, kf)
        _, top = tracking.topk_stable(counts, 8)
        ids = ms.compact_true(ms.observed_mask(mk, top, counts[top] > 0)
                              & mk.pt_valid, 4096)
        safe = torch.clamp(ids, min=0)
        p_cam = lie.se3_apply(mk.kf_pose[kf], mk.pt_pos[safe])
        free = mk.kf_kp_valid[kf] & (mk.kf_obs_pt[kf] < 0)
        wargs = (mk.pt_desc[safe].contiguous(),
                 cameras.project_pinhole(cam, p_cam).contiguous(),
                 (p_cam[:, 2] > 0.05) & (ids >= 0),
                 mk.kf_desc[kf].contiguous(), mk.kf_uv[kf].contiguous(),
                 free)
        window = match.match_window(*wargs, radius=4.0)[0]
        row = mapping.fuse_observations(mk, kf, cam).kf_obs_pt[kf]
        info = dict(kf=kf, n_ids=int((ids >= 0).sum()), free=int(free.sum()),
                    matches=int((window >= 0).sum()),
                    links=int(((mk.kf_obs_pt[kf] < 0) & (row >= 0)).sum()),
                    operands_sha=sha(mk.kf_obs_pt), new_row_sha=sha(row))
        line(f"K5_window@{tag}", lambda a=wargs: match.match_window(
            *a, radius=4.0), **info)
        if hasattr(mapping, "fuse_candidates"):
            fids, kp = mapping.fuse_candidates(mk, kf)

            def fuse_pass(mk=mk, fids=fids, kp=kp):
                return match.track_pass(mk.pt_pos, mk.pt_desc, fids,
                                        mk.kf_pose[kf], cam, None, 4.0, kp,
                                        want_depth=False)

            tp = fuse_pass()
            same = bool(torch.equal(fids.long(), ids) and torch.equal(
                torch.where(tp.ok, tp.slot, -1).to(torch.int32), window))
            line(f"track_pass@{tag}", fuse_pass, same_as_window=same, **info)
        line(f"fuse_observations@{tag}",
             lambda mk=mk: mapping.fuse_observations(mk, kf, cam), **info)
    seeded = selfcheck.match_inputs(dev)
    line("K5_window@seeded4px", lambda: match.match_window(
        *seeded, radius=4.0))


def wrapper_host(dev, reps: int = 200) -> None:
    """Host ms of one wrapper call (median, the host clock around the call
    alone, the device synchronised between calls) of the tracking pass and
    of K6, with their C call and with it replaced by a no-op: the CUDA-event
    ms of a latency-bound kernel is mostly this."""
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

    out = {name: _host_call_ms(fn, reps) for name, fn in calls.items()}
    real = cuda.call
    cuda.call = lambda *a: None
    try:
        out.update({name + "_without_c_call": _host_call_ms(fn, reps)
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
    if not isinstance(res, tracking.TrackResult):  # (result, packed)
        res = res[0]
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
    kf_maintenance_ops(system, obs, res, one_batch(), cfg)
    _card_line()


def _graph_ops(fn):
    """``selfcheck.graph_ops`` (exact), or None where the call cannot be
    captured in a CUDA graph."""
    from visual_sgraphs_tpu_torch import selfcheck
    try:
        return selfcheck.graph_ops(fn)
    except RuntimeError as e:
        return f"not captured: {str(e)[:80]}"


def kf_maintenance_ops(system, obs, res, batch, cfg) -> None:
    """Device operations and device ms of a ``bench_slice`` keyframe's map
    maintenance on the system's map, with the frame ``obs`` and its
    tracking result ``res`` as the keyframe and the scan ``batch``'s
    tables as the cycle's fold: the cycle's fold of the accepted frames'
    stats, the keyframe program's insertion (into the first free slot, or
    over the oldest keyframe), fusion and culls (a cull keyframe), and a
    serial frame's ``update_point_stats``; on this tree (one call each of
    ``apply_found_stats`` with the acceptance mask, ``insert_keyframe``,
    ``fuse_observations``, ``cull_map``) or on a tree without K27-K29
    (its own chain: the mask, the fold, the program's empty fold,
    ``insert_keyframe``, ``fuse_observations``, ``cull_points``,
    ``cull_keyframes``).  Operations: the profiler's count
    (``selfcheck.device_ops``) and the nodes of a CUDA graph of the call
    (``graph_ops``, exact where it captures)."""
    from visual_sgraphs_tpu_torch import selfcheck
    from visual_sgraphs_tpu_torch.slam import mapping, tracking
    m, K = system.map, system.cam_K
    mc, t = cfg.mapping, cfg.tracking
    _, results, _, packeds, _, _ = batch
    free = (~m.kf_valid).nonzero()
    slot = int(free[0]) if len(free) else int(torch.argmin(
        torch.where(m.kf_valid, m.kf_seq, 2**30)))
    pose = res.pose.clone()
    kernels = hasattr(mapping, "cull_map")
    cull_args = (mc.point_cull_min_obs, mc.point_cull_min_found_ratio,
                 mc.kf_cull_redundancy)

    def fold():
        if kernels:
            return mapping.apply_found_stats(m, results.slot_pt,
                                             results.vis_pt, packeds,
                                             t.min_inliers_ok)
        acc = packeds[:, 1] >= t.min_inliers_ok
        return mapping.apply_found_stats(
            m, torch.where(acc[:, None], results.slot_pt, -1),
            torch.where(acc[:, None], results.vis_pt, -1))

    def maintain():
        m0 = m
        if not kernels:
            dev = pose.device
            m0 = mapping.apply_found_stats(
                m0, torch.full((1, m.F), -1, dtype=torch.int32, device=dev),
                torch.full((1, results.vis_pt.shape[1]), -1,
                           dtype=torch.int32, device=dev))
        m1, kf, _ = mapping.insert_keyframe(m0, obs, pose, res.slot_pt, K,
                                            slot=slot)
        m2 = mapping.fuse_observations(m1, kf, K)
        if kernels:
            return mapping.cull_map(m2, kf, *cull_args)
        m3 = mapping.cull_points(m2, min_obs=cull_args[0],
                                 min_found_ratio=cull_args[1])
        return mapping.cull_keyframes(m3, kf, cull_args[2])

    def serial_stats():
        return tracking.update_point_stats(m, res)

    for name, fn in (("cycle_fold", fold), ("keyframe_maintenance", maintain),
                     ("update_point_stats", serial_stats)):
        fn()
        _line("kf_maintenance_ops", call=name, slot=slot,
              k27_k29=kernels, **selfcheck.device_ops(fn),
              graph_ops=_graph_ops(fn), ms=selfcheck.time_cuda(fn),
              device_span_ms=selfcheck.device_time(fn), **_ops_by_name(fn))


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
    and of its 17th damped solve (K26, by a tree that has it; 96 frames),
    K26's seeded systems at D = 66, 402 and 768, and the K22a reductions of
    ``inertial_slice``'s fourth VI local BA and last generic local BA (96
    frames), saved as plain tensors."""
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
    watch = (selfcheck.watch_ba_solve(which=17)
             if hasattr(selfcheck, "watch_ba_solve")
             else contextlib.nullcontext({}))
    try:
        with watch as ba_seen:
            for frame in frames[:96]:
                main_path.feed(system, frame)
            system.flush()
    finally:
        fast_ba.local_reduced_system = orig
    del system
    if "operands" in ba_seen:
        out["k26"] = list(ba_seen["operands"])
        out["k26_seeded"] = {lay: list(selfcheck.ba_solve_inputs("cuda", lay))
                             for lay in selfcheck.BA_LAYOUTS}
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


def _backsub_errors(args, seed: int = 1) -> dict:
    """K8's back-substitution with the points' update on a window's
    tables, given the factors of K8's reduction there, seeded pose steps
    (1e-3) and a seeded point mask: the moved points' error relative to
    the largest point step against the float64 twin on the same (float32)
    operands, and against the float32 twin; the error of the whole chain
    (K8's reduction and back-substitution) against the float64 twin's;
    CUDA-event and device ms.  A tree whose entry returns the step alone
    is timed through it, the points' update added after."""
    import inspect

    from visual_sgraphs_tpu_torch import selfcheck
    from visual_sgraphs_tpu_torch.parallel import dist_ba
    kw = dict(lam=1e-4, huber=2.45)
    kf_tab, val = args[2], args[4]
    L = args[0].shape[0]
    _, _, Hinv, bx, W, _ = dist_ba.local_reduced_system(*args, **kw)
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    _, _, H64, b64, W64, _ = dist_ba.local_reduced_system_torch(*f64, **kw)
    dx6 = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(L, 6)).astype(np.float32) * 1e-3).to(args[0].device)
    pts, pt_ok = args[1], torch.from_numpy(
        np.random.default_rng(seed).uniform(size=args[1].shape[0])
        >= 0.125).to(args[1].device)
    sub = (Hinv, bx, W, kf_tab, val, dx6)
    if "pts" in inspect.signature(dist_ba.back_substitute).parameters:
        fn = lambda: dist_ba.back_substitute(*sub, pts, pt_ok)  # noqa
    else:
        fn = lambda: pts + torch.where(  # noqa: E731
            pt_ok[:, None], dist_ba.back_substitute(*sub), 0.0)
    kd = fn().double()
    p64 = pts.double()

    def moved(*ops):
        return p64 + torch.where(pt_ok[:, None], dist_ba.back_substitute_torch(
            *ops, kf_tab, val, dx6.double()).double(), 0.0)

    same = moved(Hinv.double(), bx.double(), W.double())
    twin32 = pts + torch.where(pt_ok[:, None],
                               dist_ba.back_substitute_torch(*sub), 0.0)
    chain = moved(H64, b64, W64)

    def rel(a, b):
        return float((a - b).abs().max()
                     / (b - p64).abs().max().clamp(min=1e-30))

    return dict(rel_err_vs_f64=rel(kd, same),
                rel_err_vs_f32_twin=rel(kd, twin32.double()),
                chain_rel_err_vs_f64=rel(kd, chain),
                ms=selfcheck.time_cuda(fn), device_ms=selfcheck.device_time(fn))


def _damped_step(ops):
    """A Schur BA iteration's damped solve and retraction on ``ops`` (S,
    rhs, free, lam, poses, planes, rooms, doors) as the tree runs it: K26
    (``dist_ba.ba_solve``), or on a tree without it the plain chain its
    BAs ran (``solve_damped``, then each family's retraction)."""
    from visual_sgraphs_tpu_torch.core import lie
    from visual_sgraphs_tpu_torch.core import plane as plane_mod
    from visual_sgraphs_tpu_torch.parallel import dist_ba
    if hasattr(dist_ba, "ba_solve"):
        return lambda: dist_ba.ba_solve(*ops)
    S, rhs, free, lam, poses, planes, rooms, doors = ops
    counts = [0 if v is None else v.shape[0]
              for v in (poses, planes, rooms, doors)]
    fixed = []
    off = 0
    for n, t in zip(counts, (6, 3, 3, 6)):
        fixed.append(free[off:off + t * n:t] == 0)
        off += t * n

    def plain():
        dx = dist_ba.solve_damped(S, rhs, free, lam)
        L, P, R, Dn = counts
        o = 6 * L
        out = [lie.se3_normalize(lie.se3_boxplus(poses, torch.where(
            fixed[0][:, None], 0.0, dx[:o].reshape(L, 6))))]
        if P:
            out.append(plane_mod.oplus(planes, torch.where(
                fixed[1][:, None], 0.0, dx[o:o + 3 * P].reshape(P, 3))))
            o += 3 * P
            out.append(rooms + torch.where(
                fixed[2][:, None], 0.0, dx[o:o + 3 * R].reshape(R, 3)))
            o += 3 * R
            out.append(lie.se3_normalize(lie.se3_boxplus(doors, torch.where(
                fixed[3][:, None], 0.0, dx[o:o + 6 * Dn].reshape(Dn, 6)))))
        return [dx] + out

    return plain


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
    _line("schur_times", name="K8_backsub@window", **_backsub_errors(args))
    for tag, ops in [("window", rec.get("k26"))] + sorted(
            rec.get("k26_seeded", {}).items()):
        if ops is not None:
            fn = _damped_step(ops)
            measure(f"K26@{tag}", fn, D=ops[0].shape[0],
                    route="ba_solve" if hasattr(dist_ba, "ba_solve")
                    else "solve_damped + retraction")
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


def _implied_winners(points, valid, weights, hyp_idx, assign,
                     dist_thresh: float) -> list[int]:
    """Each round's winning hypothesis implied by an extraction's
    assignment: the twin's scores (``plane_fit.ransac_plane_torch``'s)
    over the points that remained at the round (valid, and unassigned or
    assigned to a later round), first maximum on ties."""
    from visual_sgraphs_tpu_torch.scenegraph import plane_fit
    out = []
    for i in range(hyp_idx.shape[0]):
        rem = valid & ((assign < 0) | (assign >= i))
        idx = hyp_idx[i].long()
        coeffs, degen = plane_fit.hypothesis_planes(points, idx)
        inl = (plane_fit.abs_distance(coeffs, points) < dist_thresh) & rem
        scores = torch.where(rem[idx].all(dim=1) & ~degen,
                             torch.sum(inl * weights, dim=1), -1.0)
        out.append(int(torch.argmax(scores)))
    return out


def _record_sg_operands(path: str) -> None:
    """K21's operands of ``bench_slice``'s 17th scene-graph BA iteration
    and K13's of its eighth plane detection (96 frames), and seeded K21
    operands with every factor type live, saved as plain tensors (needs a
    tree with ``fast_ba.sg_system``)."""
    from visual_sgraphs_tpu_torch import main_path, selfcheck
    scene, frames = main_path.frames("cuda", main_path.BENCH_FRAMES)
    system = main_path.make_system(main_path.bench_config(scene), "cuda",
                                   True)
    with selfcheck.watch_sg_system(which=17) as sg_seen, \
            selfcheck.watch_planes(which=8) as planes_seen:
        for frame in frames[:96]:
            main_path.feed(system, frame)
        system.flush()
    del system

    def plain(args):
        poses, planes, rooms, doors, fac, S_kf, rhs_kf = args
        return dict(values=[poses, planes, rooms, doors], fac=fac._asdict(),
                    S_kf=S_kf, rhs_kf=rhs_kf)

    torch.save(dict(
        bench=plain(sg_seen["operands"]),
        seeded=plain(selfcheck.sg_system_args(
            selfcheck.sg_assemble_inputs(), torch.device("cuda"))),
        detection=list(planes_seen["operands"])), path)


def sg_times(path: str) -> None:
    """K21 and K13 on the operands recorded in ``path`` (recorded there
    first when it does not exist): for K21 on seeded operands (every factor
    type live) and on a ``bench_slice`` scene-graph BA iteration's, the
    iteration's assembly (this tree's: one ``sg_system`` launch, or the
    former ``sg_assemble`` and the five operations that built S and rhs
    around it), the kernel alone and the plan; for K13 a ``bench_slice``
    detection and the seeded keyframes 21 and 48: device ms
    (``selfcheck.device_time``), device operations (``selfcheck.graph_ops``)
    and host ms (``_host_call_ms``) of each, whether four calls agree
    bitwise, and K13's outputs (plane flags, the implied winners, a digest
    of coefficients and assignment).  Run by path with ``PYTHONPATH`` set
    to another tree's root to time that tree on the same operands."""
    import os

    from visual_sgraphs_tpu_torch import cuda, selfcheck
    from visual_sgraphs_tpu_torch.optim import fast_ba
    from visual_sgraphs_tpu_torch.scenegraph import plane_fit, pointcloud
    cuda.build()
    dev = torch.device("cuda")
    if not os.path.exists(path):
        _record_sg_operands(path)
    rec = torch.load(path, map_location=dev)
    redesigned = hasattr(fast_ba, "sg_system")

    def line(name, fn, **info):
        first = fn()
        flat = lambda o: [t for t in o if isinstance(t, torch.Tensor)]  # noqa
        repro = all(all(torch.equal(a, b) for a, b in zip(flat(first),
                                                          flat(fn())))
                    for _ in range(3))
        _line("sg_times", name=name, tree="change" if redesigned
              else "parent", device_ms=selfcheck.device_time(fn),
              device_ops=selfcheck.graph_ops(fn),
              host_call_ms=_host_call_ms(fn), bitwise_repro=repro, **info)

    for tag in ("seeded", "bench"):
        r = rec[tag]
        poses, planes, rooms, doors = r["values"]
        fac = fast_ba.SgFactors(**r["fac"])
        S_kf, rhs_kf = r["S_kf"], r["rhs_kf"]
        kd = S_kf.shape[0]
        info = dict(live={k: int(getattr(fac, k).sum()) for k in (
            "ob_valid", "quad_valid", "room4_valid", "room2_valid",
            "door_valid")}, D=6 * poses.shape[0] + 3 * planes.shape[0]
            + 3 * rooms.shape[0] + 6 * doors.shape[0])
        if redesigned:
            L, P = poses.shape[0], planes.shape[0]
            plan = fast_ba.sg_plan(fac, L, P)
            line(f"K21_assembly@{tag}", lambda: fast_ba.sg_system(
                poses, planes, rooms, doors, fac, plan, S_kf, rhs_kf),
                n_pairs=int(plan.meta[1]), **info)
            # (the plan's scratch, M and G, is not compared)
            line(f"K21_plan@{tag}", lambda: fast_ba.sg_plan(fac, L, P)[:8],
                 **info)
        else:
            def assembly():
                S, g = fast_ba.sg_assemble(poses, planes, rooms, doors, fac)
                S[:kd, :kd] += S_kf
                rhs = -g
                rhs[:kd] += rhs_kf
                return S, rhs

            line(f"K21_assembly@{tag}", assembly, **info)
            line(f"K21_kernel@{tag}", lambda: fast_ba.sg_assemble(
                poses, planes, rooms, doors, fac), **info)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    detections = [("bench", tuple(rec["detection"]))]
    for frame in (21, 48):
        depth, sem, _, cam_K, hyp = selfcheck.keyframe_inputs(dev, frame)
        t = pointcloud.depth_cloud_torch(depth, sem, None, cam_K, 0.08, 2048)
        detections.append((f"seeded{frame}",
                           (t[4], t[5], t[6], hyp, 0.04, 150.0)))
    for tag, args in detections:
        coeffs, pvalid, assign = plane_fit.extract_planes(*args)
        line(f"K13@{tag}", lambda a=args: plane_fit.extract_planes(*a),
             planes_valid=pvalid.tolist(),
             winners=_implied_winners(*args[:4], assign, args[4]),
             coeffs_sha=sha(coeffs), assign_sha=sha(assign))
    _card_line()


def _record_place_operands(path: str) -> None:
    """The operands of ``bench_slice``'s eighth keyframe place query (the
    database before it, the keyframe's BoW row, the exclusion and
    covisibility masks, the map's keyframe validity, the slot, the extra
    scalar) and of its first loop verification's NN ratio (192 frames),
    with seeded K11 and NN-ratio operands, saved as plain tensors.  Needs
    a tree with ``selfcheck.watch_place``."""
    from visual_sgraphs_tpu_torch import main_path, selfcheck
    dev = torch.device("cuda")
    scene, frames = main_path.frames("cuda", main_path.BENCH_FRAMES)
    system = main_path.make_system(main_path.bench_config(scene), "cuda",
                                   True)
    with selfcheck.watch_place(which=8) as place_seen, \
            selfcheck.watch_nn(which=1) as nn_seen:
        for frame in frames:
            main_path.feed(system, frame)
        system.flush()
    del system
    db, q, exclude, covis, kf_valid, kf, extra, ratio, top_n = \
        place_seen["operands"]
    sdb, sq, sex, scov, skv, skf, sextra = selfcheck.place_query_inputs(dev)
    torch.save(dict(
        place=dict(db=list(db), q=q, exclude=exclude, covis=covis,
                   kf_valid=kf_valid, kf=kf, extra=extra, ratio=ratio,
                   top_n=top_n),
        place_seeded=dict(db=list(sdb), q=sq, exclude=sex, covis=scov,
                          kf_valid=skv, kf=skf, extra=sextra, ratio=0.8,
                          top_n=3),
        nn_bench=dict(operands=list(nn_seen["operands"]), **nn_seen["kw"]),
        nn_seeded=dict(operands=list(selfcheck.nn_inputs(dev)), ratio=0.85,
                       max_dist=50, angles=True, mutual=True),
        nn_1237=dict(operands=list(selfcheck.nn_inputs(dev, 1000,
                                                       n_b=1237)),
                     ratio=0.85, max_dist=50, angles=True, mutual=True)),
        path)


def place_times(path: str) -> None:
    """K11 and K5's NN ratio on the operands recorded in ``path``
    (recorded there first when it does not exist): the keyframe program's
    database step (this tree's: K11's insertion entry, one launch; or the
    former validity sync, query, insertion and packing), the
    relocalisation's query, on a ``bench_slice`` keyframe's operands and
    seeded ones; the NN ratio on ``bench_slice``'s first loop
    verification's operands, and seeded as the loop verification (1000 x
    1000, angles, 0.85), the relocalisation (no angles, 0.8) and at 1000 x
    1237: device ms (``selfcheck.device_time``), device operations
    (``selfcheck.graph_ops``), host ms (``_host_call_ms``), whether three
    calls agree bitwise, and digests of the outputs.  Run by path with
    ``PYTHONPATH`` set to another tree's root to time that tree on the
    same operands."""
    import os

    from visual_sgraphs_tpu_torch import cuda, selfcheck
    from visual_sgraphs_tpu_torch.features import match
    from visual_sgraphs_tpu_torch.place import database
    cuda.build()
    dev = torch.device("cuda")
    if not os.path.exists(path):
        _record_place_operands(path)
    rec = torch.load(path, map_location=dev)
    fused = hasattr(database, "place_query_insert")

    def sha(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def line(name, fn, fresh=None, **info):
        # ``fresh()`` gives each repeat its own copy of what fn updates
        outs = [fn(*(fresh() if fresh else ())) for _ in range(3)]
        flat = [[t for t in (o if isinstance(o, tuple) else (o,))
                 if isinstance(t, torch.Tensor)] for o in outs]
        repro = all(all(torch.equal(a, b) for a, b in zip(flat[0], f))
                    for f in flat[1:])
        args = fresh() if fresh else ()
        call = lambda: fn(*args)  # noqa: E731
        _line("place_times", name=name, tree="change" if fused else
              "parent", device_ms=selfcheck.device_time(call),
              device_ops=selfcheck.graph_ops(call),
              host_call_ms=_host_call_ms(call), bitwise_repro=repro,
              out_sha=sha(flat[0]), head=flat[0][0][:12].tolist(), **info)

    for tag in ("place", "place_seeded"):
        r = rec[tag]
        db0 = database.PlaceDB(*r["db"])
        q, ex, cov, kfv, kf, extra = (r["q"], r["exclude"], r["covis"],
                                      r["kf_valid"], r["kf"], r["extra"])
        ratio, top_n = r["ratio"], r["top_n"]

        def fresh(db0=db0):
            return (database.PlaceDB(*(t.clone() for t in db0)),)

        if fused:
            def step(db, q=q, ex=ex, cov=cov, kfv=kfv, kf=kf, extra=extra,
                     ratio=ratio, top_n=top_n):
                out_db, packed = database.place_query_insert(
                    db, q, ex, cov, kfv, kf, extra, ratio, top_n)
                return (packed, *out_db)
        else:
            def step(db, q=q, ex=ex, cov=cov, kfv=kfv, kf=kf, extra=extra,
                     ratio=ratio, top_n=top_n):
                db = db._replace(valid=db.valid & kfv)
                packed = database.place_query(db, q, ex, cov, ratio, top_n)
                db = database.add_keyframe(db, kf, q)
                return (torch.cat([packed, extra.to(torch.float32)
                                   .reshape(-1)]), *db)

        K, W = db0.bow.shape
        line(f"K11_keyframe@{tag}", step, fresh, K=K, W=W, kf=kf)
        # the relocalisation's masks: invalid keyframes, no covisibility
        masks = (~kfv, torch.zeros_like(kfv))
        line(f"K11_query@{tag}", lambda db0=db0, q=q, masks=masks,
             top_n=top_n: database.place_query(db0, q, *masks, 0.5, top_n),
             K=K, W=W)
    for tag in ("nn_bench", "nn_seeded", "nn_1237"):
        r = rec[tag]
        da, va, db_, vb, aa, ab = r["operands"]
        kw = dict(ratio=r["ratio"], max_dist=r["max_dist"],
                  mutual=r["mutual"])
        if r["angles"]:
            kw.update(angle_a=aa, angle_b=ab)
        line(f"K5_nn_ratio@{tag}", lambda da=da, va=va, db_=db_, vb=vb,
             kw=kw: match.match_nn_ratio(da, va, db_, vb, **kw),
             n_a=int(da.shape[0]), n_b=int(db_.shape[0]), **{
                 k: v for k, v in r.items() if k != "operands"})
        if tag == "nn_seeded":
            kw = dict(ratio=0.8, max_dist=r["max_dist"], mutual=True)
            line("K5_nn_ratio@reloc_seeded", lambda da=da, va=va, db_=db_,
                 vb=vb, kw=kw: match.match_nn_ratio(da, va, db_, vb, **kw),
                 n_a=int(da.shape[0]), n_b=int(db_.shape[0]), ratio=0.8,
                 angles=False, mutual=True)
    _card_line()


def _record_assoc_guided_operands(path: str) -> None:
    """The operands of ``bench_slice``'s first loop verification's guided
    count (K16) and of its eighth plane association (K24; 192 frames),
    with seeded ones of each, saved as plain tensors.  Needs a tree with
    ``selfcheck.watch_guided``."""
    from visual_sgraphs_tpu_torch import main_path, selfcheck
    dev = torch.device("cuda")
    scene, frames = main_path.frames("cuda", main_path.BENCH_FRAMES)
    system = main_path.make_system(main_path.bench_config(scene), "cuda",
                                   True)
    with selfcheck.watch_guided(which=1) as guided_seen, \
            selfcheck.watch_assoc(which=8) as assoc_seen:
        for frame in frames:
            main_path.feed(system, frame)
        system.flush()
    del system
    sg, dets, kf = assoc_seen["operands"]
    ssg, sdets, skf = selfcheck.assoc_operands(selfcheck.assoc_cases()[0],
                                               dev)
    torch.save(dict(
        guided_bench=list(guided_seen["operands"]),
        guided_seeded=list(selfcheck.guided_inputs(dev)),
        assoc_bench=dict(sg=list(sg), dets=list(dets), kf=kf),
        assoc_seeded=dict(sg=list(ssg), dets=list(sdets), kf=skf)), path)


def assoc_guided_times(path: str) -> None:
    """K16 and K24 on the operands recorded in ``path`` (recorded there
    first when it does not exist): loop verification's guided count from
    the refined Sim3 on (this tree's: K16's one launch; or the former
    rows' validity, Sim3 projection, gate and count kernel) on
    ``bench_slice``'s first loop verification's operands and at 1000 x
    1000 seeded, and the plane association on ``bench_slice``'s eighth
    keyframe association's operands and a seeded case: device ms
    (``selfcheck.device_time``), device operations
    (``selfcheck.graph_ops``), host ms (``_host_call_ms``), whether three
    calls agree bitwise, and digests of the outputs (for K24 also of its
    integer and bool tables).  Run by path with ``PYTHONPATH`` set to
    another tree's root to time that tree on the same operands."""
    import os

    from visual_sgraphs_tpu_torch import cuda, selfcheck
    from visual_sgraphs_tpu_torch.config import SceneGraphConfig
    from visual_sgraphs_tpu_torch.core import cameras, lie
    from visual_sgraphs_tpu_torch.features import match
    from visual_sgraphs_tpu_torch.scenegraph import manager as sgm
    from visual_sgraphs_tpu_torch.scenegraph.state import SceneGraphState
    cuda.build()
    dev = torch.device("cuda")
    if not os.path.exists(path):
        _record_assoc_guided_operands(path)
    rec = torch.load(path, map_location=dev)
    fused = hasattr(match, "guided_count_sim3")

    def sha(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def line(name, fn, **info):
        outs = [fn() for _ in range(3)]
        flat = [list(o) if isinstance(o, tuple) else [o] for o in outs]
        repro = all(all(torch.equal(a, b) for a, b in zip(flat[0], f))
                    for f in flat[1:])
        _line("assoc_guided_times", name=name,
              tree="change" if fused else "parent",
              device_ms=selfcheck.device_time(fn),
              device_ops=selfcheck.graph_ops(fn),
              host_call_ms=_host_call_ms(fn), bitwise_repro=repro,
              out_sha=sha(flat[0]), **info)

    for tag in ("guided_bench", "guided_seeded"):
        args = tuple(rec[tag])
        if fused:
            def fn(args=args):
                return match.guided_count_sim3(*args)
        else:
            def fn(args=args):
                S, p_a, obs_a, kva, ptv, da, uv_b, kvb, db_, cam = args
                pt_a = torch.clamp(obs_a, min=0).long()
                va_all = kva & (obs_a >= 0) & ptv[pt_a]
                p_cam = lie.sim3_apply(S, p_a)
                uv = cameras.project_pinhole(cam, p_cam).contiguous()
                return match.guided_count(uv, va_all & (p_cam[:, 2] > 0.05),
                                          da, uv_b, kvb, db_)
        line(f"K16@{tag}", fn, count=int(fn()), n_a=int(args[1].shape[0]),
             n_b=int(args[6].shape[0]))
    cfg = SceneGraphConfig()
    for tag in ("assoc_bench", "assoc_seeded"):
        r = rec[tag]
        sg, dets, kf = SceneGraphState(*r["sg"]), r["dets"], r["kf"]

        def fn(sg=sg, dets=dets, kf=kf):
            return tuple(sgm.associate_and_update(
                sg, *dets[:6], kf, det_quadric=dets[6], det_vox=dets[7],
                ominus_thresh=cfg.plane_assoc_ominus_thresh,
                dist_thresh=cfg.plane_assoc_dist_thresh))

        out = sgm.associate_and_update(
            sg, *dets[:6], kf, det_quadric=dets[6], det_vox=dets[7],
            ominus_thresh=cfg.plane_assoc_ominus_thresh,
            dist_thresh=cfg.plane_assoc_dist_thresh)
        ints = [getattr(out, f) for f in ("pl_valid", "pl_nobs", "n_planes",
                                           "pl_vox", "ob_kf", "ob_plane",
                                           "ob_valid", "n_obs")]
        line(f"K24@{tag}", fn, n_det=int(dets[0].shape[0]), P=sg.P,
             n_planes=[int(sg.n_planes), int(out.n_planes)],
             n_obs=[int(sg.n_obs), int(out.n_obs)], int_sha=sha(ints))
    _card_line()


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
                    help="device operations of one tracking call, one "
                    "scan batch and a keyframe's map maintenance on "
                    "bench_slice's map")
    ap.add_argument("--k20-sections", action="store_true",
                    help="K20's time by section (clock64)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="K9, K6, K6's prior, K5's window matcher, the "
                    "tracking pass and K20: CUDA-event and device times")
    ap.add_argument("--orb-times", action="store_true",
                    help="K2, K4 and extract_orb at B = 8 and B = 1: "
                    "device ms, host ms, device operations")
    ap.add_argument("--compact-times", metavar="PATH", default=None,
                    help="K7's two entries and fuse_observations' match: "
                    "device ms, device operations, host ms (operands "
                    "recorded into PATH, or loaded from it)")
    ap.add_argument("--other-times", action="store_true",
                    help="K1's blur, K17a and K22a's cost: device ms and "
                    "device operations")
    ap.add_argument("--schur-times", metavar="PATH", default=None,
                    help="K8 and K22a's reduction: times, device operations "
                    "and bitwise repeats (windows recorded into PATH)")
    ap.add_argument("--sg-times", metavar="PATH", default=None,
                    help="K21's assembly and plan and K13: device ms, "
                    "device operations, host ms (operands recorded into "
                    "PATH, or loaded from it)")
    ap.add_argument("--place-times", metavar="PATH", default=None,
                    help="K11's two entries and K5's NN ratio: device ms, "
                    "device operations, host ms (operands recorded into "
                    "PATH, or loaded from it)")
    ap.add_argument("--assoc-guided-times", metavar="PATH", default=None,
                    help="K16 and K24: device ms, device operations, host "
                    "ms (operands recorded into PATH, or loaded from it)")
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
    elif args.orb_times:
        from visual_sgraphs_tpu_torch import cuda
        cuda.build()
        orb_front_times(torch.device("cuda"))
        _card_line()
    elif args.compact_times:
        from visual_sgraphs_tpu_torch import cuda
        cuda.build()
        compact_fuse_times(torch.device("cuda"), args.compact_times)
        _card_line()
    elif args.other_times:
        from visual_sgraphs_tpu_torch import cuda, selfcheck
        cuda.build()
        dev = torch.device("cuda")
        other_device_times(dev, selfcheck.lm_problems(
            selfcheck.lm_window(dev)))
        _card_line()
    elif args.track_ops:
        track_ops()
    elif args.k20_sections:
        k20_sections()
    elif args.schur_times:
        schur_times(args.schur_times)
    elif args.sg_times:
        sg_times(args.sg_times)
    elif args.place_times:
        place_times(args.place_times)
    elif args.assoc_guided_times:
        assoc_guided_times(args.assoc_guided_times)
    elif args.loop_runs:
        loop_spread(args.loop_runs)
    else:
        profile(args.scenegraph, args.bench, args.inertial, args.freespace)


if __name__ == "__main__":
    main()
