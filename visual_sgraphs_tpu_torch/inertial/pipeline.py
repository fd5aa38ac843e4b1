"""Host-side IMU pipeline and the per-frame visual-inertial solve (K20).

Port of ``visual_sgraphs_tpu/inertial/pipeline.py``: sample buffering, the
dead-reckoned prediction (Tracking::PredictStateIMU), the initialisation
schedule and the VI local BA dispatch (LocalMapping::InitializeIMU), and
``pose_inertial_gn``, the exact tracking-time inertial optimiser
(PoseInertialOptimizationLastFrame): a 15-dof Gauss-Newton over
[δpose (6), δv (3), δbg (3), δba (3)] with the frame's reprojection rows,
the preintegration residual to the last frame (held fixed) and the bias
random walks.  ``pose_inertial_gn`` is kernel K20 (``csrc/vi_pose.cu``,
one launch for the whole solve) on CUDA tensors and the plain twin
``pose_inertial_gn_torch`` on CPU tensors.

Each frame with samples is one launch of K18 (``preint_frame``): the
frame window, which the pipeline keeps packed for K20 (``frame_vec``),
its merge into the keyframe window, kept packed too, and, once
initialised, the dead-reckoned prediction (``predict_state``'s), which
``predict`` returns; ``predict_state`` itself is the CPU twin's.

The host keeps float32 mirrors of the frame's and the keyframe window's
integration times, summed in sample order as the preintegration sums them
on the device, so neither the bias-walk weights nor the keyframe window's
validity needs a device-to-host read.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.config import ImuConfig
from visual_sgraphs_tpu_torch.core import cameras, lie
from visual_sgraphs_tpu_torch.cuda import resolve_device
from visual_sgraphs_tpu_torch.inertial import init as iinit
from visual_sgraphs_tpu_torch.inertial import vi_ba
from visual_sgraphs_tpu_torch.inertial.factors import GRAVITY, _imu_residual
from visual_sgraphs_tpu_torch.inertial.preintegration import (
    PACKED,
    Preintegrated,
    identity_preint,
    pack,
    predict_state,  # noqa: F401  (the reference's pipeline holds it)
    preint_frame,
    unpack,
)

# static capacity of one inter-frame preintegration window (~7 samples a
# frame at 200 Hz and 30 fps; 64 covers dropped frames)
FRAME_IMU_CAP = 64
CHI2 = 7.815  # the per-frame solve's reprojection gate (3-dof)


def _gravity(dtype, device):
    """(0, 0, -9.81) on ``device``, made there: writing a Python number
    into one element of a CUDA tensor is a synchronising host copy."""
    return torch.cat([torch.zeros((2,), dtype=dtype, device=device),
                      torch.full((1,), -GRAVITY, dtype=dtype,
                                 device=device)])


def _visual_velocity(T_cw_prev, T_cw_curr, T_bc, dt: float):
    """World-frame body velocity from two camera poses."""
    p_prev = lie.se3_inverse(lie.se3_multiply(T_bc, T_cw_prev))[4:7]
    p_curr = lie.se3_inverse(lie.se3_multiply(T_bc, T_cw_curr))[4:7]
    return (p_curr - p_prev) / float(np.float32(dt))


def sample_window(samples, t_prev: float):
    """One frame's (FRAME_IMU_CAP, 8) float32 table [ω, a, dt, valid] from
    its samples [(omega, acc, t)] (the first FRAME_IMU_CAP of them), the
    intervals measured from ``t_prev``, and its integration time summed in
    float32 in sample order, as the preintegration sums it on the
    device."""
    tab = np.zeros((FRAME_IMU_CAP, 8), np.float32)
    dt_sum = np.float32(0.0)
    for i, (w, a, ti) in enumerate(samples[:FRAME_IMU_CAP]):
        tab[i, 0:3], tab[i, 3:6] = w, a
        tab[i, 6] = max(ti - t_prev, 0.0)
        tab[i, 7] = float(tab[i, 6] > 0)
        if tab[i, 7]:
            dt_sum = np.float32(dt_sum + tab[i, 6])
        t_prev = ti
    return tab, dt_sum


def walk_info(cfg: ImuConfig, dt: float) -> tuple[float, float]:
    """The per-frame solve's bias-walk weights 1 / (walk √Δt), float32."""
    s = np.sqrt(max(float(dt), 1e-3))
    return (float(np.float32(1.0 / (cfg.walk_gyro * s))),
            float(np.float32(1.0 / (cfg.walk_acc * s))))


# ---------------------------------------------------------------------------
# the per-frame visual-inertial solve
# ---------------------------------------------------------------------------


def _vi_observations(m, frame, slot_pt, cam_bf):
    """(xw (F, 3), uv (F, 2), ur_obs (F,), obs_ok (F,), has_d (F,))."""
    pt = torch.clamp(slot_pt, min=0).long()
    obs_ok = (slot_pt >= 0) & m.pt_valid[pt] & frame.valid
    has_d = obs_ok & (frame.depth > 0)
    ur_obs = frame.uv[:, 0] - cam_bf / torch.where(has_d, frame.depth, 1.0)
    return m.pt_pos[pt], frame.uv, ur_obs, obs_ok, has_d


def irls_weights(T_j, xw, uv_obs, obs_ok, cam_K):
    """Huber weights with the 4 χ² gate on the current reprojection."""
    p_c = lie.se3_apply(T_j, xw)
    chi2 = torch.sum((cameras.project_pinhole(cam_K, p_c) - uv_obs) ** 2, 1)
    return torch.where(obs_ok & (p_c[:, 2] > 0.05) & (chi2 < CHI2 * 4),
                       1.0, 0.0) * torch.clamp(
        torch.sqrt(CHI2 / torch.clamp(chi2, min=1e-9)), max=1.0)


def reproj_rows(T_j, xw, uv_obs, ur_obs, has_d, w, cam_K, cam_bf):
    """The weighted reprojection rows and their analytic Jacobian in the
    left pose perturbation: (r (F, 3), J (F, 3, 6)).  d p / d[ρ, ω] =
    [I | -[p]x] for p = exp(x) T_j X at x = 0."""
    p = lie.se3_apply(T_j, xw)
    fx, fy = cam_K[0], cam_K[1]
    z = p[:, 2]
    tiny = torch.abs(z) < 1e-9
    inv_z = 1.0 / torch.where(tiny, 1e-9, z)
    dinv = torch.where(tiny, 0.0, inv_z * inv_z)  # -d(inv_z)/dz
    zc = torch.clamp(z, min=1e-6)
    u_hat = fx * p[:, 0] * inv_z + cam_K[2]
    v_hat = fy * p[:, 1] * inv_z + cam_K[3]
    ur_hat = u_hat - cam_bf / zc
    r = torch.stack([(u_hat - uv_obs[:, 0]) * w, (v_hat - uv_obs[:, 1]) * w,
                     torch.where(has_d, ur_hat - ur_obs, 0.0) * w], 1)
    zero = torch.zeros_like(z)
    du = torch.stack([fx * inv_z, zero, -fx * p[:, 0] * dinv], 1)
    dv = torch.stack([zero, fy * inv_z, -fy * p[:, 1] * dinv], 1)
    dur = du + torch.stack([zero, zero, torch.where(
        z > 1e-6, cam_bf / (zc * zc), 0.0)], 1)
    Jp = torch.stack([du * w[:, None], dv * w[:, None],
                      dur * torch.where(has_d, w, 0.0)[:, None]], 1)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        p.shape[0], 3, 3)
    return r, Jp @ torch.cat([eye, -lie.hat(p)], dim=2)


def _imu_rows(x, T_j, v_j, bg, ba, T_i, v_i, g_w, const):
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return _imu_residual(T_i, lie.se3_boxplus(T_j, x[:6]), v_i, v_j + x[6:9],
                         bg + x[9:12], ba + x[12:15], g_w, one, const)


def pose_inertial_gn_torch(m, frame, slot_pt, T_j0, v_j0, T_i, v_i,
                           pre: Preintegrated | torch.Tensor, T_bc, cam_K,
                           cam_bf, walk: tuple, iters: int = 6):
    """Plain twin of K20, the kernel's arithmetic step for step: the
    analytic reprojection rows, the 9 preintegration rows by forward-mode
    AD (``torch.func.jacfwd``), the 6 bias-walk rows; the normal equations
    JᵀJ + 1e-6 I and Jᵀr assembled and solved in float64.  ``pre`` as
    ``pose_inertial_gn`` takes it.  Returns (T_j, v_j, bg, ba,
    n_inliers)."""
    if T_j0.is_cuda:
        pose_inertial_gn_torch.cuda_calls += 1
    if isinstance(pre, torch.Tensor):
        pre = unpack(pre)
    xw, uv_obs, ur_obs, obs_ok, has_d = _vi_observations(m, frame, slot_pt,
                                                         cam_bf)
    const = iinit.preint_const(pre)
    const["T_bc"] = T_bc
    g_w = _gravity(T_j0.dtype, T_j0.device)
    wg, wa = walk
    x0 = torch.zeros((15,), dtype=T_j0.dtype, device=T_j0.device)
    T_j, v_j, bg, ba = T_j0, v_j0, pre.bias_g, pre.bias_a
    for _ in range(iters):
        w = irls_weights(T_j, xw, uv_obs, obs_ok, cam_K)
        r, J = reproj_rows(T_j, xw, uv_obs, ur_obs, has_d, w, cam_K, cam_bf)
        Hpp = torch.einsum("fri,frj->ij", J, J)
        gp = torch.einsum("fri,fr->i", J, r)
        args = (T_j, v_j, bg, ba, T_i, v_i, g_w, const)
        r_imu = _imu_rows(x0, *args)
        J_imu = jacfwd(_imu_rows)(x0, *args).double()
        H = J_imu.T @ J_imu
        g = J_imu.T @ r_imu.double()
        H[:6, :6] += Hpp.double()
        g[:6] += gp.double()
        r_bg = (bg - pre.bias_g) * wg
        r_ba = (ba - pre.bias_a) * wa
        idx = torch.arange(3, device=H.device)
        H[9 + idx, 9 + idx] += wg * wg
        H[12 + idx, 12 + idx] += wa * wa
        g[9:12] += wg * r_bg.double()
        g[12:15] += wa * r_ba.double()
        H += torch.eye(15, dtype=H.dtype, device=H.device) * 1e-6
        dx = (-torch.linalg.solve_ex(H, g)[0]).to(T_j.dtype)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        T_j = lie.se3_normalize(lie.se3_boxplus(T_j, dx[:6]))
        v_j, bg, ba = v_j + dx[6:9], bg + dx[9:12], ba + dx[12:15]
    p_c = lie.se3_apply(T_j, xw)
    chi2 = torch.sum((cameras.project_pinhole(cam_K, p_c) - uv_obs) ** 2, 1)
    n_inl = (obs_ok & (chi2 < CHI2)).sum(dtype=torch.int32)
    return T_j, v_j, bg, ba, n_inl


pose_inertial_gn_torch.cuda_calls = 0


def _vi_pose_args(m, frame, slot_pt, T_j0, v_j0, T_i, v_i,
                  pre: Preintegrated | torch.Tensor, T_bc, cam_K, cam_bf,
                  walk: tuple, iters: int):
    """K20's outputs (out (16,), n_inl) and its C arguments up to them."""
    pre_vec = (pre if isinstance(pre, torch.Tensor)
               else pack(pre)).contiguous()
    tensors = [m.pt_pos, m.pt_valid, frame.uv, frame.depth, frame.valid,
               slot_pt, T_j0, v_j0, T_i, v_i, pre_vec, T_bc, cam_K, cam_bf]
    cuda.require_cuda("pose_inertial_gn", *tensors)
    F = slot_pt.shape[0]
    if (slot_pt.dtype != torch.int32 or frame.uv.shape != (F, 2)
            or pre_vec.shape != (PACKED,) or m.pt_valid.dtype != torch.bool
            or frame.valid.dtype != torch.bool):
        raise ValueError("pose_inertial_gn: unexpected shapes or dtypes")
    out = torch.empty((16,), dtype=torch.float32, device=T_j0.device)
    n_inl = torch.empty((), dtype=torch.int32, device=T_j0.device)
    return out, n_inl, (
        cuda.ptr(m.pt_pos), cuda.ptr(m.pt_valid), m.pt_pos.shape[0],
        cuda.ptr(frame.uv), cuda.ptr(frame.depth), cuda.ptr(frame.valid),
        cuda.ptr(slot_pt), F, cuda.ptr(T_j0), cuda.ptr(v_j0), cuda.ptr(T_i),
        cuda.ptr(v_i), cuda.ptr(pre_vec), cuda.ptr(T_bc), cuda.ptr(cam_K),
        cuda.ptr(cam_bf), float(walk[0]), float(walk[1]), iters,
        cuda.ptr(out), cuda.ptr(n_inl))


def pose_inertial_gn(m, frame, slot_pt, T_j0, v_j0, T_i, v_i,
                     pre: Preintegrated | torch.Tensor, T_bc, cam_K, cam_bf,
                     walk: tuple, iters: int = 6):
    """The per-frame visual-inertial solve from (T_j0, v_j0) and the
    preintegration's biases, with the last frame's (T_i, v_i) held fixed;
    ``pre`` the frame window, a ``Preintegrated`` or packed (PACKED,) as
    K18 writes it (``ImuPipeline.frame_vec``: then nothing is packed);
    ``walk`` = (gyro, accel) bias-walk weights (``walk_info``).  Kernel
    K20 on CUDA tensors, the twin on CPU tensors.  Returns (T_j, v_j, bg,
    ba, n_inliers)."""
    if T_j0.device.type == "cpu":
        return pose_inertial_gn_torch(m, frame, slot_pt, T_j0, v_j0, T_i,
                                      v_i, pre, T_bc, cam_K, cam_bf, walk,
                                      iters)
    out, n_inl, args = _vi_pose_args(m, frame, slot_pt, T_j0, v_j0, T_i, v_i,
                                     pre, T_bc, cam_K, cam_bf, walk, iters)
    cuda.call("vsg_vi_pose", *args, cuda.stream())
    pose_inertial_gn.launches += 1
    return out[0:7], out[7:10], out[10:13], out[13:16], n_inl


def pose_inertial_gn_sections(*args, iters: int = 6) -> torch.Tensor:
    """K20 instrumented (``pose_inertial_gn``'s CUDA arguments): the
    (4 + 5 iters,) int64 clock of its thread 0 at the kernel's section
    boundaries (``selfcheck.vi_pose_sections``).  Not the main path's
    launch: it is not counted."""
    out, n_inl, cargs = _vi_pose_args(*args, iters)
    prof = torch.zeros((4 + 5 * iters,), dtype=torch.int64,
                       device=out.device)
    cuda.call("vsg_vi_pose_sections", *cargs, cuda.ptr(prof), prof.numel(),
              cuda.stream())
    return prof


pose_inertial_gn.launches = 0


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


class ImuPipeline:
    """Owns the IMU sample buffer and the per-keyframe inertial state, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: ImuConfig, max_keyframes: int,
                 init_min_kfs: int = 8, fix_scale: bool = True,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.T_bc = torch.tensor(cfg.T_bc, dtype=torch.float32).to(
            self.device)
        self.state = vi_ba.empty_imu_state(max_keyframes, self.device)
        self.initialized = False
        self.init_min_kfs = init_min_kfs
        self.fix_scale = fix_scale
        self.q_wg = None  # gravity rotation found at initialisation
        self.scale = 1.0
        self._frame_samples: list[tuple] = []
        self._last_t: float | None = None
        zero3 = torch.zeros((3,), dtype=torch.float32, device=self.device)
        self._cur_bias_g = zero3
        self._cur_bias_a = zero3.clone()
        # the keyframe window, packed as K18 writes it
        self._since_kf_vec = pack(identity_preint(self._cur_bias_g,
                                                  self._cur_bias_a))
        self._since_kf_dt = np.float32(0.0)  # host mirror of its dt
        self.frame_dt = np.float32(0.0)  # host mirror of the last frame's
        self.vel = zero3.clone()  # the current frame's velocity
        # the last frame's velocity: v_i of the per-frame solve
        self.vel_prev = None
        # the last frame window, packed as K18 wrote it (K20 takes it)
        self.frame_vec = None
        # K18's prediction of the last preintegrated frame, with the pose
        # it started from
        self._pred = None
        self.windows = 0  # frames preintegrated (K18 launches on the card)

    @property
    def _since_kf(self) -> Preintegrated:
        """The keyframe window (views of the packed vector)."""
        return unpack(self._since_kf_vec)

    def add_samples(self, omega, acc, t) -> None:
        """Queue raw samples (rad/s, m/s², s) arriving before the next
        frame."""
        for w, a, ti in zip(np.atleast_2d(omega), np.atleast_2d(acc),
                            np.atleast_1d(t)):
            self._frame_samples.append((w, a, float(ti)))

    def preintegrate_frame(self, t_frame: float,
                           T_cw_last=None) -> Preintegrated | None:
        """Integrate everything queued up to ``t_frame`` into one frame
        window, folded into the running keyframe window in the same launch
        of K18 (Tracking::PreintegrateIMU); once initialised, the same
        launch predicts the frame's pose and velocity from the window and
        the last frame's pose ``T_cw_last``, which an initialised pipeline
        needs (``predict`` returns the prediction).  None without
        samples."""
        if self.initialized and T_cw_last is None:
            raise ValueError("ImuPipeline.preintegrate_frame: an "
                             "initialised pipeline predicts from the last "
                             "frame's pose: pass T_cw_last")
        self._pred = None
        self.frame_vec = None
        take = [s for s in self._frame_samples if s[2] <= t_frame]
        self._frame_samples = [s for s in self._frame_samples
                               if s[2] > t_frame]
        if not take:
            return None
        if self._last_t is None:
            self._last_t = take[0][2]
        tab, dt_sum = sample_window(take, self._last_t)
        self._last_t = t_frame
        samples = torch.from_numpy(tab)
        if self.device.type == "cuda":
            # pinned and asynchronous: no host synchronisation
            samples = samples.pin_memory().to(self.device, non_blocking=True)
        pose = (T_cw_last, self.vel, self.T_bc) if self.initialized else None
        self.frame_vec, self._since_kf_vec, pred = preint_frame(
            self._since_kf_vec, samples, self._cur_bias_g, self._cur_bias_a,
            self.cfg.noise_gyro, self.cfg.noise_acc, pose)
        if pred is not None:
            self._pred = (T_cw_last, pred)
        self.windows += 1
        self.frame_dt = dt_sum
        self._since_kf_dt = np.float32(self._since_kf_dt + dt_sum)
        return unpack(self.frame_vec)

    def on_keyframe(self, kf: int) -> None:
        """Bind the accumulated keyframe window to slot ``kf`` and restart
        it."""
        self.state = vi_ba.set_kf_imu(
            self.state, kf, self.vel, self._cur_bias_g, self._cur_bias_a,
            self._since_kf, float(self._since_kf_dt) > 1e-4)
        self._since_kf_vec = pack(identity_preint(self._cur_bias_g,
                                                  self._cur_bias_a))
        self._since_kf_dt = np.float32(0.0)

    def try_initialize(self, system) -> bool:
        """Gravity / scale / velocity / bias solve once enough keyframes
        exist (LocalMapping::InitializeIMU); rescales and rotates the map.
        One counted read per attempt (the costs and the scale)."""
        if self.initialized:
            return True
        n_kf = system.n_kf_host
        if n_kf < self.init_min_kfs:
            return False
        m = system.map
        n = min(n_kf, self.state.vel.shape[0])
        res = iinit.inertial_init(
            m.kf_pose[:n], m.kf_valid[:n],
            Preintegrated(*(f[:n] for f in self.state.preint)),
            self.state.preint_valid[:n], self.T_bc, fix_scale=self.fix_scale)
        cost, cost0, scale = system._read(torch.stack(
            [res.cost, res.cost0, res.scale]))
        if not np.isfinite(cost) or cost >= cost0:
            return False
        if not self.fix_scale and not (0.1 < scale < 10.0):
            return False  # the bad-scale guard
        system.map = iinit.apply_scaled_rotation(m, res.q_wg, res.scale)
        vel = iinit.rotate_velocities(res.vel, res.q_wg, res.scale)
        st = self.state
        K = st.vel.shape[0]
        new_vel = st.vel.clone()
        new_vel[:n] = vel
        self.state = st._replace(vel=new_vel,
                                 bias_g=res.bias_g.expand(K, 3).clone(),
                                 bias_a=res.bias_a.expand(K, 3).clone())
        self._cur_bias_g = res.bias_g
        self._cur_bias_a = res.bias_a
        self.vel = vel[min(n, vel.shape[0]) - 1]
        self.q_wg = res.q_wg
        self.scale = float(scale)
        system.last_pose = system.map.kf_pose[system.ref_kf_host]
        self.initialized = True
        return True

    def local_ba(self, system, kf: int, n_window: int = 10,
                 iters: int = 8) -> None:
        """The visual-inertial windowed BA after each keyframe
        (LocalInertialBA)."""
        system.map, self.state, _ = vi_ba.vi_local_ba(
            system.map, self.state, kf, system.cam_K, system.cam_bf,
            self.T_bc, walk_gyro=self.cfg.walk_gyro,
            walk_acc=self.cfg.walk_acc, n_window=n_window, iters=iters)
        self.vel = self.state.vel[kf]
        self._cur_bias_g = self.state.bias_g[kf]
        self._cur_bias_a = self.state.bias_a[kf]

    def predict(self, T_cw_last, pre: Preintegrated | None):
        """The incoming frame's predicted pose; None before
        initialisation or without samples.  The prediction K18 made in
        ``preintegrate_frame`` from ``T_cw_last``; raises when there is
        none from that pose."""
        if not self.initialized or pre is None:
            return None
        if self._pred is None or self._pred[0] is not T_cw_last:
            raise ValueError("ImuPipeline.predict: no prediction from this "
                             "pose; preintegrate_frame(t, T_cw_last) makes "
                             "it")
        self.vel_prev = self.vel
        T_pred, self.vel = self._pred[1]
        self._pred = None
        return T_pred

    def correct_velocity(self, T_cw_prev, T_cw_curr, dt: float) -> None:
        """Re-anchor the frame velocity on the accepted visual pose delta
        (Tracking.cc:2361-2380)."""
        if not self.initialized or dt <= 1e-6:
            return
        self.vel = _visual_velocity(T_cw_prev, T_cw_curr, self.T_bc, dt)

    def export_state(self) -> dict:
        """The pipeline's state (the reference's ``export_state`` keys);
        the transient sample buffer is left out, as there."""
        nan4 = torch.full((4,), float("nan"), dtype=torch.float32,
                          device=self.device)
        return {"state": self.state, "since_kf": self._since_kf,
                "vel": self.vel, "bias_g": self._cur_bias_g,
                "bias_a": self._cur_bias_a, "initialized": self.initialized,
                "scale": self.scale,
                "last_t": np.nan if self._last_t is None else self._last_t,
                "q_wg": self.q_wg if self.q_wg is not None else nan4}

    def import_state(self, tree: dict) -> None:
        self.state = tree["state"]
        self._since_kf_vec = pack(tree["since_kf"]).contiguous()
        self._since_kf_dt = np.float32(tree["since_kf"].dt.cpu())
        self._pred = None
        self.frame_vec = None
        self.vel = tree["vel"]
        self._cur_bias_g = tree["bias_g"]
        self._cur_bias_a = tree["bias_a"]
        self.initialized = bool(tree["initialized"])
        self.scale = float(tree["scale"])
        lt = float(tree["last_t"])
        self._last_t = None if np.isnan(lt) else lt
        q = tree["q_wg"]
        self.q_wg = None if bool(torch.isnan(q).any()) else q
        self._frame_samples = []
