#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, exit code != 0):

1. card and toolchain: nvidia-smi name + power limit, torch / CUDA
   versions, nvcc version;
2. build of the hand-written kernels (visual_sgraphs_tpu_torch/csrc) into
   build/kernels/libvsg_kernels.so, with the seconds it took;
3. every kernel against its plain PyTorch twin on the card, at the main
   path's shapes (K2 FAST+NMS, K4 ORB descriptor, K5 window matcher, K6
   pose-only GN, K8 Schur reduction and back-substitution, K12 depth cloud
   + voxel downsample, K13 weighted RANSAC, K14 plane statistics), with
   kernel and twin times (CUDA events, median of 20 after 3 warm-ups) and
   the bytes / operations each function needs, from which its bound is
   derived;
4. the port's main paths at full size through its public entry point
   (``SlamSystem.track_rgbd``), 640x480 RGB-D, 1000 ORB features,
   128 keyframes / 32768 points, serial path, loops off, 96 frames of the
   two-lap ``orbit2`` sequence rendered on the card:
   a. scene graph off (the tracking + local-mapping path);
   b. scene graph on (``SceneGraphManager`` attached, semantics provided
      per frame, plane covisibility and semantic point refinement on);
   c. path (b) again over frames 0-47 under ``torch.cuda.set_sync_debug_
      mode``: synchronising calls per frame against counted readbacks;
   the kernel launch counters are zeroed just before each of (a) and (b)
   and read just after;
5. the same 12 small frames through the port on the card (kernels) and on
   the CPU (twins), with the scene graph off and on, whose positions must
   agree;
6. the card's name and power limit, the JSON kernel table, and the
   result line.

Needs torch, numpy and nvcc; no JAX and no network.
"""

from __future__ import annotations

import collections
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


def _bound(r: dict) -> tuple[float, str]:
    """Least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger (ms)."""
    t_bytes = r["bytes"] / PEAK_BYTES_PER_S
    t_ops = r["ops"] / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _drive(system, frames, warm: int = WARM, sync_window=None) -> dict:
    """Feed ``frames`` [(gray, depth, sem, T_wc, ts)]; returns timing and
    readback figures over frames ``warm``.. (and, with ``sync_window``
    (lo, hi), the synchronising calls counted by sync-debug mode over
    frames lo..hi-1)."""
    torch.cuda.synchronize()
    t_warm = readbacks_warm = None
    syncs = None
    caught = None
    from visual_sgraphs_tpu_torch import main_path
    for i, frame in enumerate(frames):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
            readbacks_warm = system.host_readbacks
            system.timers.reset()
        if sync_window is not None and i == sync_window[0]:
            rb_lo = system.host_readbacks
            # switching the mode on warns once itself: record after it
            torch.cuda.set_sync_debug_mode(1)
            caught = warnings.catch_warnings(record=True)
            log = caught.__enter__()
            warnings.simplefilter("always")
        main_path.feed(system, frame)
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
                sync_sites=dict(sites.most_common(8)))
    system.flush()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    out = dict(fps=(len(frames) - warm) / (t_end - t_warm),
               readbacks_per_frame=(system.host_readbacks - readbacks_warm)
               / (len(frames) - warm))
    if syncs is not None:
        out.update(syncs)
    return out


def _accuracy(system, frames) -> dict:
    from visual_sgraphs_tpu_torch.core import geometry
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
    checks = {r["name"]: r for r in selfcheck.run_all(device)}
    for r in checks.values():
        bound_ms, bound_by = _bound(r)
        r.update(bound_ms=bound_ms, bound_by=bound_by)
        _line("kernel", **r)
    bad = [n for n, r in checks.items() if not r["ok"]]
    _check(not bad, f"kernels disagree with their twins: {bad}")
    _check(set(checks) == {k[0] for k in cuda.KERNELS},
           "a kernel has no check")

    # ---- 4. the main paths at full size
    scene, frames = main_path.frames(device)
    n_frames = len(frames)
    cfg, sg_cfg = main_path.configs(scene)
    counts = {}
    for tag, c, with_sg in (("slice", cfg, False),
                            ("scenegraph_slice", sg_cfg, True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_counts()
        system = main_path.make_system(c, device, with_sg)
        t0 = time.perf_counter()
        perf = _drive(system, frames)
        total_s = time.perf_counter() - t0
        counts[tag] = cuda.counts()
        acc = _accuracy(system, frames)
        extra = _scenegraph_summary(system) if with_sg else {}
        _line(tag, frames=n_frames, **acc, fps_16_95=perf["fps"],
              total_s=total_s,
              host_readbacks_per_frame=perf["readbacks_per_frame"],
              keyframes=system.events.count("keyframe"),
              kf_culled=system.events.count("kf_culled"),
              peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20, **extra)
        _line(tag + "_stages", **system.timers.summary())
        _line(tag + "_launches", **{
            k: {"launches": v[0], "twin_calls_on_cuda": v[1]}
            for k, v in counts[tag].items()})
        _check(acc["tracked"] >= 90,
               f"{tag}: tracked {acc['tracked']}/{n_frames}")
        _check(acc["n_kf"] >= 2, f"{tag}: n_kf {acc['n_kf']}")
        _check(acc["ate_m"] < 0.05, f"{tag}: ATE {acc['ate_m']:.4f} m")
        _check(all(v[1] == 0 for v in counts[tag].values()),
               f"{tag}: a twin ran on CUDA tensors: {counts[tag]}")
        if with_sg:
            _check(extra["n_planes"] >= 2,
                   f"{tag}: n_planes {extra['n_planes']}")
            _check(not extra["sign_duplicates"],
                   f"{tag}: sign-duplicate planes {extra['sign_duplicates']}")
            _check(all(v[0] > 0 for v in counts[tag].values()),
                   f"{tag}: a kernel was not launched: {counts[tag]}")
        else:
            sg_only = {"depth_cloud", "extract_planes", "plane_epilogue"}
            _check(all(v[0] > 0 for k, v in counts[tag].items()
                       if k not in sg_only),
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

    # ---- 6. result lines
    kernels = []
    for name, _, _, src, replaces in cuda.kernel_functions():
        r = checks[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts["scenegraph_slice"][name][0],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    print(_card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
