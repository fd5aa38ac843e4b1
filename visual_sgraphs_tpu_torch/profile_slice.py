"""Where the time goes on the card: one profiled window of the slice.

    python -m visual_sgraphs_tpu_torch.profile_slice [--scenegraph]
    python -m visual_sgraphs_tpu_torch.profile_slice --loop-runs N

Runs the main path of ``main_path`` (640x480, 1000 features, 96
``orbit2`` frames) through ``SlamSystem.track_rgbd`` on the card (with
``--scenegraph`` the scene graph attached, as ``chip_smoke.py`` phase 4b
runs it) and profiles frames 32-63 twice: under ``torch.profiler``
(device time by kernel, device busy share of the window, launches a
frame) and under ``cProfile`` (host time by Python function).  With ``--scenegraph`` it also times one plane-KF
factor linearisation (1024 items) with ``torch.func.jacfwd`` and, for
comparison, ``jacrev``.  With ``--loop-runs N`` it instead runs the loop
path (``chip_smoke.py``'s ``loop_slice``: scene graph and loop closing on)
N times and prints each run's loops, relocalisations and ATE: the spread
that the card's float summation order alone gives one configuration.
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


def _line(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=str), flush=True)


def _slice(with_sg: bool):
    from visual_sgraphs_tpu_torch import main_path
    scene, frames = main_path.frames("cuda")
    cfg, sg_cfg = main_path.configs(scene)
    return main_path.make_system(sg_cfg if with_sg else cfg, "cuda",
                                 with_sg), frames


def _feed(system, frames) -> None:
    from visual_sgraphs_tpu_torch import main_path
    for frame in frames:
        main_path.feed(system, frame)


def profile(with_sg: bool) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    lo, hi = WINDOW
    n = hi - lo
    # device view
    system, frames = _slice(with_sg)
    _feed(system, frames[:lo])
    torch.cuda.synchronize()
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
          top={e.key[:60]: [e.device_time_total, e.count] for e in top})
    # host view, without the profiler
    system, frames = _slice(with_sg)
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
    if with_sg:
        _line("linearize", **linearization_ms())


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenegraph", action="store_true",
                    help="attach the scene graph")
    ap.add_argument("--loop-runs", type=int, default=0,
                    help="run the loop path this many times instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.loop_runs:
        loop_spread(args.loop_runs)
    else:
        profile(args.scenegraph)


if __name__ == "__main__":
    main()
