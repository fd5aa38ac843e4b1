"""Synthetic RGB-D sequence renderer: textured plane-world with exact GT.

Port of ``visual_sgraphs_tpu/io/synthetic.py`` (``room_planes``,
``cell_texture``, ``render`` and the ``arc`` / ``forward`` / ``orbit`` /
``orbit2`` trajectories of the small room, and the IMU samples of a
trajectory): every pixel is one ray/plane
intersection over a small room, the texture is a procedural multi-scale 3D
cell pattern (piecewise constant, so FAST finds strong corners) and depth
is exact.  Frames render on the scene's device.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch.config import CameraConfig
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.cuda import resolve_device


@functools.lru_cache(maxsize=None)
def _libm_sinf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.sinf.restype = ctypes.c_float
    lib.sinf.argtypes = [ctypes.c_float]
    return np.frompyfunc(lib.sinf, 1, 1)


def _sin(x: torch.Tensor) -> torch.Tensor:
    """float32 sine.  The hash below turns a last-bit difference of the
    sine into a different texture value, so on CPU tensors it calls the C
    library's sinf, whose rounding the reference's CPU renderer has
    (PyTorch's vectorised CPU sine rounds differently in ~17% of cases);
    on the card it is the CUDA sine."""
    if x.device.type != "cpu":
        return torch.sin(x)
    out = _libm_sinf()(x.numpy()).astype(np.float32)
    return torch.from_numpy(out.reshape(x.shape))


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a, b, c):
    """a * b + c rounded once to float32 (exact float64 product and sum):
    the multiply-add contraction that XLA's CPU backend applies inside the
    reference's fused texture loop, reproduced so both renderers give the
    same image."""
    return (torch.as_tensor(a).double() * b + torch.as_tensor(c).double()
            ).float()


def _hash3(p: torch.Tensor) -> torch.Tensor:
    """Deterministic lattice hash -> [0, 1) (shader-style, batched)."""
    k0, k1, k2 = (_f32(v) for v in (127.1, 311.7, 74.7))
    d = _fma(p[..., 2], k2, _fma(p[..., 1], k1, p[..., 0] * k0))
    h = _sin(d) * _f32(43758.5453)
    return h - torch.floor(h)


def cell_texture(p: torch.Tensor) -> torch.Tensor:
    """Multi-scale piecewise-constant 3D texture in [0, 255]:
    (0.55 c1 + 0.3 c2 + 0.15 c3) * 235 + 10."""
    c1 = _hash3(torch.floor(p * 2.5))
    c2 = _hash3(torch.floor(p * 7.0))
    c3 = _hash3(torch.floor(p * 19.0))
    t = _fma(c1, _f32(0.55), c2 * _f32(0.3))
    t = _fma(c3, _f32(0.15), t)
    return _fma(t, 235.0, 10.0)


class PlaneSet(NamedTuple):
    coeffs: torch.Tensor  # (P, 4) world planes, |n| = 1, n·x + c = 0
    semantic: torch.Tensor  # (P,) 0 ground / 1 wall / 2 ceiling


def room_planes(half_x=2.5, half_y=1.6, z_back=7.0, z_front=-3.0,
                device=None) -> PlaneSet:
    """A rectangular room: floor (y=+half_y, camera convention y-down),
    ceiling, two side walls, front and back walls."""
    planes = np.array(
        [
            [0.0, -1.0, 0.0, half_y],
            [0.0, 1.0, 0.0, half_y],
            [1.0, 0.0, 0.0, half_x],
            [-1.0, 0.0, 0.0, half_x],
            [0.0, 0.0, -1.0, z_back],
            [0.0, 0.0, 1.0, -z_front],
        ],
        np.float32,
    )
    sem = np.array([0, 2, 1, 1, 1, 1], np.int32)
    return PlaneSet(torch.from_numpy(planes).to(device),
                    torch.from_numpy(sem).to(device))


def render(T_wc: torch.Tensor, planes: PlaneSet, cam_K: torch.Tensor,
           h: int = 480, w: int = 640):
    """Render (gray (h, w), depth (h, w), sem (h, w)) from camera pose T_wc.
    Rays are (x, y, 1) in the camera frame, so the intersection parameter
    is exactly the z-depth."""
    dev = T_wc.device
    fx, fy, cx, cy = cam_K[0], cam_K[1], cam_K[2], cam_K[3]
    us = (torch.arange(w, dtype=torch.float32, device=dev) - cx) / fx
    vs = (torch.arange(h, dtype=torch.float32, device=dev) - cy) / fy
    dirs_cam = torch.stack(
        [us[None, :].expand(h, w), vs[:, None].expand(h, w),
         torch.ones((h, w), dtype=torch.float32, device=dev)], dim=-1)
    R = lie.quat_to_matrix(T_wc[:4])
    origin = T_wc[4:7]
    dirs = torch.einsum("ij,hwj->hwi", R, dirs_cam)
    n = planes.coeffs[:, :3]
    c4 = planes.coeffs[:, 3]
    denom = torch.einsum("hwi,pi->hwp", dirs, n)
    num = -(torch.einsum("i,pi->p", origin, n) + c4)
    t = num[None, None, :] / torch.where(torch.abs(denom) < 1e-6, 1e-6, denom)
    t = torch.where((t > 0.2) & (torch.abs(denom) > 1e-6), t, torch.inf)
    tmin, pidx = torch.min(t, dim=-1)
    hit = torch.isfinite(tmin)
    tsafe = torch.where(hit, tmin, 1.0)
    pts = _fma(tsafe[..., None], dirs, origin[None, None, :])
    gray = cell_texture(pts)
    depth = torch.where(hit, tsafe, 0.0)
    sem = torch.where(hit, planes.semantic[pidx], -1)
    return torch.where(hit, gray, 0.0), depth, sem


class SyntheticScene:
    """A room + trajectory; yields (gray, depth, T_wc_gt, timestamp).
    Frames render on ``device`` (the card unless the caller asks for the
    CPU; raises when no card is there)."""

    def __init__(self, cam: CameraConfig | None = None, h: int = 240,
                 w: int = 320, device: torch.device | str = "cuda"):
        self.cam = cam or CameraConfig(
            fx=260.0, fy=260.0, cx=w / 2 - 0.5, cy=h / 2 - 0.5,
            width=w, height=h, k1=0.0, k2=0.0, k3=0.0,
            bf=0.08 * 260.0,
        )
        self.h, self.w = h, w
        self.device = resolve_device(device)
        self.planes = room_planes(device=self.device)
        self.cam_K = torch.from_numpy(self.cam.K).to(self.device)

    def trajectory(self, n_frames: int, kind: str = "arc") -> np.ndarray:
        """(T, 7) float32 ground-truth T_wc poses."""
        s = np.arange(n_frames) / max(n_frames - 1, 1)
        if kind == "arc":
            xi = np.stack(
                [
                    0.8 * np.sin(s * 2.0),
                    0.15 * np.sin(s * 6.0),
                    1.5 * s,
                    0.08 * np.sin(s * 5.0),
                    -0.35 * s,
                    0.04 * np.sin(s * 7.0),
                ],
                axis=-1,
            )
        elif kind == "forward":
            xi = np.stack([0 * s, 0 * s, 2.5 * s, 0 * s, 0 * s, 0 * s], -1)
        elif kind in ("orbit", "orbit2"):
            # closed loops with yaw following the tangent ("orbit2": two
            # laps)
            laps = {"orbit": 1.0, "orbit2": 2.0}[kind]
            r, z0 = 0.9, 0.0
            a = laps * 2.0 * np.pi * s
            q = np.stack([np.cos(a / 2), 0 * a, np.sin(a / 2), 0 * a],
                         axis=-1)
            t = np.stack([r * np.sin(a), 0.05 * np.sin(3 * a),
                          z0 + r * (1 - np.cos(a))], axis=-1)
            return np.concatenate([q, t], axis=-1).astype(np.float32)
        else:
            raise ValueError(kind)
        return lie.se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy()

    def render(self, T_wc: np.ndarray):
        return render(torch.from_numpy(np.asarray(T_wc, np.float32)).to(
            self.device), self.planes, self.cam_K, self.h, self.w)

    def frames(self, n_frames: int, kind: str = "arc", fps: float = 30.0):
        traj = self.trajectory(n_frames, kind)
        for i, T_wc in enumerate(traj):
            gray, depth, _ = self.render(T_wc)
            yield gray, depth, T_wc, i / fps

    def imu_samples(self, n_frames: int, kind: str = "arc",
                    fps: float = 30.0, imu_rate: float = 200.0,
                    g_world=(0.0, 9.81, 0.0), seed: int = 0,
                    noise_gyro: float = 0.0, noise_acc: float = 0.0):
        """(frame poses (n, 7) T_wc, [(omega, acc, t) per frame]): ideal,
        or with ``noise_*`` noisy, IMU samples between consecutive frames
        from a densely sampled version of the same trajectory, as numpy
        (the reference's ``frames_with_imu``).  Gyro is the body rate
        log(R_iᵀ R_{i+1}) / δt; the accelerometer the specific force
        R_wbᵀ (a_w - g_w), with ``g_world`` the true gravity (+y: the
        camera convention is y-down)."""
        sub = max(int(round(imu_rate / fps)), 1)
        dense = self.trajectory((n_frames - 1) * sub + 1, kind)
        dt = 1.0 / (fps * sub)
        q = torch.from_numpy(dense[:, :4])
        p = dense[:, 4:7]
        rel = lie.so3_log(lie.quat_multiply(lie.quat_conjugate(q[:-1]),
                                            q[1:])).numpy()
        omega = rel / dt
        a_w = np.zeros_like(p)
        a_w[1:-1] = (p[2:] - 2 * p[1:-1] + p[:-2]) / (dt * dt)
        a_w[0], a_w[-1] = a_w[1], a_w[-2]
        g = np.asarray(g_world, np.float32)
        R = lie.quat_to_matrix(q).numpy()
        f_b = np.einsum("dij,dj->di", R.transpose(0, 2, 1), a_w - g[None])
        rng = np.random.default_rng(seed)
        if noise_gyro:
            omega = omega + rng.normal(size=omega.shape) * noise_gyro
        if noise_acc:
            f_b = f_b + rng.normal(size=f_b.shape) * noise_acc
        samples = []
        for i in range(n_frames):
            if i == 0:
                samples.append((np.zeros((0, 3)), np.zeros((0, 3)),
                                np.zeros((0,))))
            else:
                lo, hi = (i - 1) * sub, i * sub
                samples.append((omega[lo:hi], f_b[lo:hi],
                                (np.arange(lo, hi) + 1) * dt))
        return dense[::sub], samples

    def frames_with_imu(self, n_frames: int, kind: str = "arc",
                        fps: float = 30.0, imu_rate: float = 200.0,
                        g_world=(0.0, 9.81, 0.0), seed: int = 0,
                        noise_gyro: float = 0.0, noise_acc: float = 0.0):
        """Yield (gray, depth, T_wc, ts, (omega, acc, t)): each frame of
        the dense trajectory's every ``imu_rate / fps``-th pose with the
        IMU samples since the previous frame (``imu_samples``)."""
        traj, samples = self.imu_samples(n_frames, kind, fps, imu_rate,
                                         g_world, seed, noise_gyro, noise_acc)
        for i, T_wc in enumerate(traj):
            gray, depth, _ = self.render(T_wc)
            yield gray, depth, T_wc, i / fps, samples[i]

    def frames_with_semantics(self, n_frames: int, kind: str = "arc",
                              fps: float = 30.0):
        """Like ``frames``, with the per-pixel class image: yields (gray,
        depth, sem (int32, -1 where no plane), T_wc_gt, timestamp)."""
        traj = self.trajectory(n_frames, kind)
        for i, T_wc in enumerate(traj):
            gray, depth, sem = self.render(T_wc)
            yield gray, depth, sem, T_wc, i / fps
