"""Visual-inertial subsystem of the port: preintegration (kernel K18),
inertial factors for the generic LM engine, gravity / scale
initialisation, the VI local BA, the per-frame visual-inertial solve
(kernel K20) and the host pipeline (``visual_sgraphs_tpu/inertial``)."""

from visual_sgraphs_tpu_torch.inertial.init import (
    apply_scaled_rotation,
    inertial_init,
    rotate_velocities,
)
from visual_sgraphs_tpu_torch.inertial.pipeline import (
    ImuPipeline,
    pose_inertial_gn,
    predict_state,
)
from visual_sgraphs_tpu_torch.inertial.preintegration import (
    Preintegrated,
    bias_corrected_delta,
    identity_preint,
    merge,
    preintegrate,
)
from visual_sgraphs_tpu_torch.inertial.vi_ba import (
    ImuKfState,
    empty_imu_state,
    set_kf_imu,
    vi_local_ba,
)

__all__ = [
    "apply_scaled_rotation",
    "inertial_init",
    "rotate_velocities",
    "ImuPipeline",
    "pose_inertial_gn",
    "predict_state",
    "Preintegrated",
    "bias_corrected_delta",
    "identity_preint",
    "merge",
    "preintegrate",
    "ImuKfState",
    "empty_imu_state",
    "set_kf_imu",
    "vi_local_ba",
]
