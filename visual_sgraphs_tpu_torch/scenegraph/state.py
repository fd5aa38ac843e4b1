"""Scene-graph state: plane / room / door / marker tables + observations.

Port of ``visual_sgraphs_tpu/scenegraph/state.py``: the same field names,
shapes and dtypes, so a reference snapshot converts field for field
(``interop.scenegraph_from_numpy``).  A plane's semantic class is decided
by weighted voting with a minimum-vote gate (Plane.cc:148-197).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch.config import CapacityConfig

N_CLASSES = 3  # ground / wall / ceiling
GROUND, WALL, CEILING, UNDEFINED = 0, 1, 2, -1


class SceneGraphState(NamedTuple):
    # planes (P,)
    pl_coeffs: torch.Tensor  # (P, 4) world plane, |n| = 1
    pl_valid: torch.Tensor  # (P,) bool
    pl_centroid: torch.Tensor  # (P, 3) running centroid of support
    pl_npts: torch.Tensor  # (P,) supporting point count
    pl_votes: torch.Tensor  # (P, N_CLASSES) weighted semantic votes
    pl_nobs: torch.Tensor  # (P,) int32 observation count
    # plane observations (Q,)
    ob_kf: torch.Tensor  # (Q,) int32 keyframe slot
    ob_plane: torch.Tensor  # (Q,) int32 plane id
    ob_coeffs: torch.Tensor  # (Q, 4) plane in the keyframe's camera frame
    ob_conf: torch.Tensor  # (Q,) mean confidence of the observation
    ob_quadric: torch.Tensor  # (Q, 4, 4) Gij (camera frame)
    ob_valid: torch.Tensor  # (Q,) bool
    # rooms (R,)
    room_center: torch.Tensor  # (R, 3)
    room_walls: torch.Tensor  # (R, 4) int32 plane ids (corridor: 2, -1 -1)
    room_is_corridor: torch.Tensor  # (R,) bool
    room_valid: torch.Tensor  # (R,) bool
    room_marker: torch.Tensor  # (R,) int32 meta-marker id or -1
    room_ground: torch.Tensor  # (R,) int32 ground plane id or -1
    # doors (D,)
    door_pose: torch.Tensor  # (D, 7) world SE3
    door_marker: torch.Tensor  # (D,) int32
    door_valid: torch.Tensor  # (D,) bool
    # fiducial markers (M,)
    marker_pose: torch.Tensor  # (M, 7)
    marker_id: torch.Tensor  # (M,) int32
    marker_valid: torch.Tensor  # (M,) bool
    # counters () int32
    n_planes: torch.Tensor
    n_obs: torch.Tensor
    n_rooms: torch.Tensor
    n_doors: torch.Tensor
    n_markers: torch.Tensor
    # per-plane surface-membership voxel hash table (P, V) int32 or -1
    pl_vox: torch.Tensor

    @property
    def P(self) -> int:
        return self.pl_coeffs.shape[0]


def empty_scenegraph(cap: CapacityConfig = CapacityConfig(),
                     max_obs: int = 1024,
                     device: torch.device | str | None = None
                     ) -> SceneGraphState:
    P, R, D, M = cap.max_planes, cap.max_rooms, cap.max_doors, cap.max_markers
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    door_pose = full((D, 7), 0.0, f32)
    door_pose[:, 0] = 1.0
    marker_pose = full((M, 7), 0.0, f32)
    marker_pose[:, 0] = 1.0
    return SceneGraphState(
        pl_coeffs=full((P, 4), 0.0, f32),
        pl_valid=full((P,), False, torch.bool),
        pl_centroid=full((P, 3), 0.0, f32),
        pl_npts=full((P,), 0.0, f32),
        pl_votes=full((P, N_CLASSES), 0.0, f32),
        pl_nobs=full((P,), 0, i32),
        ob_kf=full((max_obs,), -1, i32),
        ob_plane=full((max_obs,), -1, i32),
        ob_coeffs=full((max_obs, 4), 0.0, f32),
        ob_conf=full((max_obs,), 0.0, f32),
        ob_quadric=full((max_obs, 4, 4), 0.0, f32),
        ob_valid=full((max_obs,), False, torch.bool),
        room_center=full((R, 3), 0.0, f32),
        room_walls=full((R, 4), -1, i32),
        room_is_corridor=full((R,), False, torch.bool),
        room_valid=full((R,), False, torch.bool),
        room_marker=full((R,), -1, i32),
        room_ground=full((R,), -1, i32),
        door_pose=door_pose,
        door_marker=full((D,), -1, i32),
        door_valid=full((D,), False, torch.bool),
        marker_pose=marker_pose,
        marker_id=full((M,), -1, i32),
        marker_valid=full((M,), False, torch.bool),
        n_planes=full((), 0, i32),
        n_obs=full((), 0, i32),
        n_rooms=full((), 0, i32),
        n_doors=full((), 0, i32),
        n_markers=full((), 0, i32),
        pl_vox=full((P, cap.plane_vox_slots), -1, i32),
    )


MEMBERSHIP_VOXEL = 0.3  # m, plane-surface membership resolution


def reciprocal_f32(v: float) -> float:
    """1 / v rounded to float32, as XLA folds a division by a constant
    inside the reference's jitted functions (x / c becomes x * (1 / c));
    the port multiplies by it on every device and in its kernels."""
    return float(np.float32(1.0) / np.float32(v))


def dot3(n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """((n0 p0 + n1 p1) + n2 p2) over the last axis, each product and sum
    its own rounded operation: the order the hand kernels (csrc/ransac.cu,
    csrc/plane_epilogue.cu) use, so their integer decisions match."""
    return (n[..., 0] * p[..., 0] + n[..., 1] * p[..., 1]) + n[..., 2] * p[..., 2]


def voxel_key(p: torch.Tensor, vox: float = MEMBERSHIP_VOXEL) -> torch.Tensor:
    """(..., 3) world points -> (...) int32 packed voxel keys (10 bits per
    axis, +-~150 m at 0.3 m)."""
    idx = torch.floor(p * reciprocal_f32(vox)).to(torch.int32) + 512
    idx = torch.clamp(idx, 0, 1023)
    return (idx[..., 0] << 20) | (idx[..., 1] << 10) | idx[..., 2]


def voxel_slot(key: torch.Tensor, V: int) -> torch.Tensor:
    """Hash slot of a voxel key in a (V,)-row table: Knuth multiplicative
    hash with uint32 wrap-around (computed in int64 and masked)."""
    h = ((key.to(torch.int64) & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    return ((h >> 16) % V).to(torch.int32)


def plane_semantics(sg: SceneGraphState, min_votes: float = 3.0
                    ) -> torch.Tensor:
    """(P,) expected class per plane: argmax of the weighted votes,
    UNDEFINED until the winner reaches ``min_votes``
    (Plane::getExpectedPlaneType, Plane.cc:148-164)."""
    best = torch.argmax(sg.pl_votes, dim=-1)  # first maximum on ties
    strength = torch.amax(sg.pl_votes, dim=-1)
    return torch.where(sg.pl_valid & (strength >= min_votes),
                       best.to(torch.int32), UNDEFINED)
