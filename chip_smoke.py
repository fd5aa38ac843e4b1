#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, exit code != 0):

1. card and toolchain: nvidia-smi name + power limit, torch / CUDA
   versions, nvcc version;
2. build of the hand-written kernels (visual_sgraphs_tpu_torch/csrc) into
   build/kernels/libvsg_kernels.so, with the seconds it took;
3. every kernel (K2 FAST+NMS, K4 ORB descriptor, K5 window matcher, K6
   pose-only GN) against its plain PyTorch twin on the card, at the
   slice's shapes, with kernel and twin times (CUDA events, median of 20
   after 3 warm-ups);
4. the slice at full size through the port's public entry point
   (``SlamSystem.track_rgbd``): 640x480 RGB-D, 1000 ORB features,
   128 keyframes / 32768 points, serial path, loops and scene graph off,
   96 frames of the two-lap ``orbit2`` sequence rendered on the card; the
   kernel launch counters are zeroed just before and read just after;
5. the same 12 small frames through the port on the card (kernels) and on
   the CPU (twins), whose positions must agree;
6. the card's name and power limit, the JSON kernel table, and the
   result line.

Needs torch, numpy and nvcc; no JAX and no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from visual_sgraphs_tpu_torch import cuda, selfcheck
    from visual_sgraphs_tpu_torch.config import (
        CapacityConfig,
        MappingConfig,
        OrbConfig,
        SystemConfig,
    )
    from visual_sgraphs_tpu_torch.core import geometry
    from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
    from visual_sgraphs_tpu_torch.slam.system import SlamSystem

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

    # ---- 3. each kernel against its twin at the slice's shapes
    checks = {r["name"]: r for r in selfcheck.run_all(device)}
    for r in checks.values():
        _line("kernel", **r)
    bad = [n for n, r in checks.items() if not r["ok"]]
    _check(not bad, f"kernels disagree with their twins: {bad}")

    # ---- 4. the slice at full size
    n_frames, warm = 96, 16
    scene = SyntheticScene(h=480, w=640, device=device)
    frames = list(scene.frames(n_frames, kind="orbit2"))
    gt = np.stack([T[4:7] for _, _, T, _ in frames])
    cfg = SystemConfig(
        camera=scene.cam, orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=128, max_points=32768),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
        profile=True)
    torch.cuda.synchronize()
    cuda.reset_counts()
    system = SlamSystem(cfg, device=device)
    t0 = time.perf_counter()
    t_warm = None
    for i, (gray, depth, _, ts) in enumerate(frames):
        if i == warm:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
            readbacks_warm = system.host_readbacks
            system.timers.reset()
        system.track_rgbd(gray, depth, ts)
    system.flush()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = cuda.counts()
    pos = system.positions()
    tracked = system.tracked_mask()
    ate = float(geometry.ate_rmse(torch.from_numpy(pos[tracked]),
                                  torch.from_numpy(gt[tracked]))[0])
    n_kf = int(system.map.n_kf)
    _line("slice", frames=n_frames, tracked=int(tracked.sum()), n_kf=n_kf,
          n_pt=int(system.map.n_pt), ate_m=ate,
          fps_16_95=(n_frames - warm) / (t_end - t_warm),
          total_s=t_end - t0,
          host_readbacks_per_frame=(system.host_readbacks - readbacks_warm)
          / (n_frames - warm),
          keyframes=system.events.count("keyframe"),
          kf_culled=system.events.count("kf_culled"),
          peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    _line("stages", **system.timers.summary())
    _line("launches", **{k: {"launches": v[0], "twin_calls_on_cuda": v[1]}
                         for k, v in counts.items()})
    _check(np.isfinite(pos).all() and pos.shape == (n_frames, 3),
           "positions not finite")
    _check(int(tracked.sum()) >= 90, f"tracked {int(tracked.sum())}/96")
    _check(n_kf >= 2, f"n_kf {n_kf}")
    _check(ate < 0.05, f"ATE {ate:.4f} m")
    _check(all(v[0] > 0 for v in counts.values()),
           f"a kernel was not launched on the main path: {counts}")
    _check(all(v[1] == 0 for v in counts.values()),
           f"a twin ran on CUDA tensors on the main path: {counts}")

    # ---- 5. the card's path against the CPU twins on a small input
    small = SyntheticScene(h=240, w=320)
    small_cfg = SystemConfig(
        camera=small.cam, orb=OrbConfig(n_features=300),
        capacity=CapacityConfig(32, 4096),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2))
    runs = {}
    for dev in ("cuda", "cpu"):
        s = SlamSystem(small_cfg, device=dev)
        for gray, depth, _, ts in small.frames(12, kind="arc"):
            s.track_rgbd(gray, depth, ts)
        runs[dev] = (s.positions(), int(s.map.n_kf))
    diff = float(np.abs(runs["cuda"][0] - runs["cpu"][0]).max())
    _line("small_vs_cpu_twins", max_pos_diff_m=diff,
          n_kf=[runs["cuda"][1], runs["cpu"][1]])
    _check(diff < 0.01 and runs["cuda"][1] == runs["cpu"][1],
           "card path disagrees with the CPU twin path")

    # ---- 6. result lines
    kernels = []
    for name, _, _, src, replaces in cuda.kernel_functions():
        r = checks[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=counts[name][0],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(_card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
