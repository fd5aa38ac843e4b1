"""Build, load and call the port's hand-written CUDA kernels.

All kernels live in ``csrc/*.cu`` with a plain C interface.  On first use
each source is compiled by its own ``nvcc`` for ``sm_90a`` (all started
together), the objects are linked into one shared library,
``build/kernels/libvsg_kernels.so`` at the repository root, and it is
loaded with ``ctypes``.  The library is rebuilt whenever the hash of the sources
changes.  Nothing here runs at import time: importing this module needs
neither a card nor a compiler.

Every kernel has a wrapper (which launches it on a CUDA tensor, counts the
launch in ``wrapper.launches``, and raises if the C entry point reports a
CUDA error) and a plain PyTorch twin in the same module (which counts the
calls it receives on CUDA tensors in ``twin.cuda_calls``).  ``KERNELS``
names them for the smoke test and the GPU tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
LIB_NAME = "libvsg_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# shared memory a CTA may use on the H100 (227 KB), for the launch plans
SMEM_LIMIT = 232448

# (name, module, wrapper, twin, source, TPU-path function it replaces)
KERNELS = (
    ("pyramid_resize", "visual_sgraphs_tpu_torch.features.pyramid",
     "build_pyramid", "build_pyramid_torch",
     "visual_sgraphs_tpu_torch/csrc/pyramid.cu",
     "visual_sgraphs_tpu/features/pyramid.py:56"),
    ("gaussian_blur", "visual_sgraphs_tpu_torch.features.pyramid",
     "gaussian_blur_levels", "gaussian_blur_levels_torch",
     "visual_sgraphs_tpu_torch/csrc/pyramid.cu",
     "visual_sgraphs_tpu/features/pyramid.py:27"),
    ("fast_nms", "visual_sgraphs_tpu_torch.features.fast", "fast_levels",
     "fast_levels_torch", "visual_sgraphs_tpu_torch/csrc/fast.cu",
     "visual_sgraphs_tpu/features/fast.py:36"),
    ("detect_level", "visual_sgraphs_tpu_torch.features.orb",
     "detect_levels", "detect_levels_torch",
     "visual_sgraphs_tpu_torch/csrc/detect.cu",
     "visual_sgraphs_tpu/features/orb.py:90"),
    ("orb_desc", "visual_sgraphs_tpu_torch.features.orb",
     "orb_describe_levels", "orb_describe_levels_torch",
     "visual_sgraphs_tpu_torch/csrc/orb_desc.cu",
     "visual_sgraphs_tpu/features/orb.py:121"),
    ("match_window", "visual_sgraphs_tpu_torch.features.match",
     "match_window", "match_window_torch",
     "visual_sgraphs_tpu_torch/csrc/match.cu",
     "visual_sgraphs_tpu/features/match.py:104"),
    ("track_pass", "visual_sgraphs_tpu_torch.features.match", "track_pass",
     "track_pass_torch", "visual_sgraphs_tpu_torch/csrc/track_pass.cu",
     "visual_sgraphs_tpu/slam/tracking.py:271"),
    ("pose_gn", "visual_sgraphs_tpu_torch.slam.tracking", "pose_only_gn",
     "pose_only_gn_torch", "visual_sgraphs_tpu_torch/csrc/pose_gn.cu",
     "visual_sgraphs_tpu/slam/tracking.py:73"),
    ("pose_gn_prior", "visual_sgraphs_tpu_torch.slam.tracking",
     "pose_only_gn_prior", "pose_only_gn_prior_torch",
     "visual_sgraphs_tpu_torch/csrc/pose_gn.cu",
     "visual_sgraphs_tpu/slam/tracking.py:183"),
    ("inlier_tail", "visual_sgraphs_tpu_torch.slam.tracking",
     "inlier_tail", "inlier_tail_torch",
     "visual_sgraphs_tpu_torch/csrc/scan_epilogue.cu",
     "visual_sgraphs_tpu/slam/tracking.py:320"),
    ("scan_prologue", "visual_sgraphs_tpu_torch.slam.tracking",
     "scan_prologue", "scan_prologue_torch",
     "visual_sgraphs_tpu_torch/csrc/scan_epilogue.cu",
     "visual_sgraphs_tpu/slam/tracking.py:475"),
    ("scan_epilogue", "visual_sgraphs_tpu_torch.slam.tracking",
     "scan_epilogue", "scan_epilogue_torch",
     "visual_sgraphs_tpu_torch/csrc/scan_epilogue.cu",
     "visual_sgraphs_tpu/slam/tracking.py:480"),
    ("compact_true", "visual_sgraphs_tpu_torch.slam.map_state",
     "compact_true", "compact_true_torch",
     "visual_sgraphs_tpu_torch/csrc/compact.cu",
     "visual_sgraphs_tpu/slam/tracking.py:67"),
    ("compact_observed", "visual_sgraphs_tpu_torch.slam.map_state",
     "compact_observed", "compact_observed_torch",
     "visual_sgraphs_tpu_torch/csrc/compact.cu",
     "visual_sgraphs_tpu/slam/map_state.py:156"),
    ("found_stats", "visual_sgraphs_tpu_torch.slam.mapping",
     "apply_found_stats", "apply_found_stats_torch",
     "visual_sgraphs_tpu_torch/csrc/kf_insert.cu",
     "visual_sgraphs_tpu/slam/mapping.py:194"),
    ("kf_insert", "visual_sgraphs_tpu_torch.slam.mapping",
     "insert_keyframe", "insert_keyframe_torch",
     "visual_sgraphs_tpu_torch/csrc/kf_insert.cu",
     "visual_sgraphs_tpu/slam/mapping.py:93"),
    ("fuse_prologue", "visual_sgraphs_tpu_torch.slam.mapping",
     "fuse_candidates", "fuse_candidates_torch",
     "visual_sgraphs_tpu_torch/csrc/fuse_obs.cu",
     "visual_sgraphs_tpu/slam/mapping.py:525"),
    ("fuse_writeback", "visual_sgraphs_tpu_torch.slam.mapping",
     "fuse_writeback", "fuse_writeback_torch",
     "visual_sgraphs_tpu_torch/csrc/fuse_obs.cu",
     "visual_sgraphs_tpu/slam/mapping.py:556"),
    ("map_cull", "visual_sgraphs_tpu_torch.slam.mapping", "cull_map",
     "cull_map_torch", "visual_sgraphs_tpu_torch/csrc/map_cull.cu",
     "visual_sgraphs_tpu/slam/mapping.py:685"),
    ("group_observations", "visual_sgraphs_tpu_torch.parallel.dist_ba",
     "group_observations", "group_observations_torch",
     "visual_sgraphs_tpu_torch/csrc/group_obs.cu",
     "visual_sgraphs_tpu/parallel/dist_ba.py:60"),
    ("schur_reduce", "visual_sgraphs_tpu_torch.parallel.dist_ba",
     "local_reduced_system", "local_reduced_system_torch",
     "visual_sgraphs_tpu_torch/csrc/schur.cu",
     "visual_sgraphs_tpu/parallel/dist_ba.py:148"),
    ("schur_backsub", "visual_sgraphs_tpu_torch.parallel.dist_ba",
     "back_substitute", "back_substitute_torch",
     "visual_sgraphs_tpu_torch/csrc/schur.cu",
     "visual_sgraphs_tpu/parallel/dist_ba.py:257"),
    ("ba_solve", "visual_sgraphs_tpu_torch.parallel.dist_ba", "ba_solve",
     "ba_solve_torch", "visual_sgraphs_tpu_torch/csrc/ba_solve.cu",
     "visual_sgraphs_tpu/optim/fast_ba.py:401"),
    ("depth_cloud", "visual_sgraphs_tpu_torch.scenegraph.pointcloud",
     "depth_cloud", "depth_cloud_torch",
     "visual_sgraphs_tpu_torch/csrc/voxel.cu",
     "visual_sgraphs_tpu/scenegraph/pointcloud.py:43"),
    ("extract_planes", "visual_sgraphs_tpu_torch.scenegraph.plane_fit",
     "extract_planes", "extract_planes_torch",
     "visual_sgraphs_tpu_torch/csrc/ransac.cu",
     "visual_sgraphs_tpu/scenegraph/plane_fit.py:24"),
    ("plane_epilogue", "visual_sgraphs_tpu_torch.scenegraph.epilogue",
     "plane_epilogue", "plane_epilogue_torch",
     "visual_sgraphs_tpu_torch/csrc/plane_epilogue.cu",
     "visual_sgraphs_tpu/scenegraph/manager.py:254"),
    ("bow_vectors", "visual_sgraphs_tpu_torch.place.vocab", "bow_vectors",
     "bow_vectors_torch", "visual_sgraphs_tpu_torch/csrc/bow.cu",
     "visual_sgraphs_tpu/place/vocab.py:138"),
    ("place_query", "visual_sgraphs_tpu_torch.place.database",
     "place_query", "place_query_torch",
     "visual_sgraphs_tpu_torch/csrc/bow.cu",
     "visual_sgraphs_tpu/place/database.py:75"),
    ("match_nn_ratio", "visual_sgraphs_tpu_torch.features.match",
     "match_nn_ratio", "match_nn_ratio_torch",
     "visual_sgraphs_tpu_torch/csrc/match.cu",
     "visual_sgraphs_tpu/features/match.py:62"),
    ("guided_count", "visual_sgraphs_tpu_torch.features.match",
     "guided_count_sim3", "guided_count_sim3_torch",
     "visual_sgraphs_tpu_torch/csrc/match.cu",
     "visual_sgraphs_tpu/place/loop_closer.py:86"),
    ("verify_sim3", "visual_sgraphs_tpu_torch.place.sim3_ransac",
     "verify_sim3", "verify_sim3_torch",
     "visual_sgraphs_tpu_torch/csrc/sim3.cu",
     "visual_sgraphs_tpu/place/sim3_ransac.py:28"),
    ("pnp_hypotheses", "visual_sgraphs_tpu_torch.place.pnp",
     "pnp_hypotheses", "pnp_hypotheses_torch",
     "visual_sgraphs_tpu_torch/csrc/sim3.cu",
     "visual_sgraphs_tpu/place/pnp.py:65"),
    ("pgo_assemble", "visual_sgraphs_tpu_torch.place.pgo", "pgo_assemble",
     "pgo_assemble_torch", "visual_sgraphs_tpu_torch/csrc/pgo.cu",
     "visual_sgraphs_tpu/place/pgo.py:125"),
    ("pgo_cost", "visual_sgraphs_tpu_torch.place.pgo", "pgo_cost",
     "pgo_cost_torch", "visual_sgraphs_tpu_torch/csrc/pgo.cu",
     "visual_sgraphs_tpu/optim/solve.py:69"),
    ("preint", "visual_sgraphs_tpu_torch.inertial.preintegration",
     "preint_frame", "preint_frame_torch",
     "visual_sgraphs_tpu_torch/csrc/preint.cu",
     "visual_sgraphs_tpu/inertial/preintegration.py:62"),
    ("vi_pose", "visual_sgraphs_tpu_torch.inertial.pipeline",
     "pose_inertial_gn", "pose_inertial_gn_torch",
     "visual_sgraphs_tpu_torch/csrc/vi_pose.cu",
     "visual_sgraphs_tpu/inertial/pipeline.py:266"),
    ("freespace_carve", "visual_sgraphs_tpu_torch.scenegraph.freespace",
     "accumulate_freespace", "accumulate_freespace_torch",
     "visual_sgraphs_tpu_torch/csrc/freespace.cu",
     "visual_sgraphs_tpu/scenegraph/freespace.py:41"),
    ("freespace_components", "visual_sgraphs_tpu_torch.scenegraph.freespace",
     "freespace_components", "freespace_components_torch",
     "visual_sgraphs_tpu_torch/csrc/freespace.cu",
     "visual_sgraphs_tpu/scenegraph/freespace.py:75"),
    ("sg_assemble", "visual_sgraphs_tpu_torch.optim.fast_ba", "sg_system",
     "sg_system_torch", "visual_sgraphs_tpu_torch/csrc/sg_assemble.cu",
     "visual_sgraphs_tpu/optim/fast_ba.py:46"),
    ("sg_plan", "visual_sgraphs_tpu_torch.optim.fast_ba", "sg_plan",
     "sg_plan_torch", "visual_sgraphs_tpu_torch/csrc/sg_assemble.cu",
     "visual_sgraphs_tpu/optim/fast_ba.py:46"),
    ("lm_reproj_reduce", "visual_sgraphs_tpu_torch.optim.lm_kernels",
     "lm_reproj_reduce", "lm_reproj_reduce_torch",
     "visual_sgraphs_tpu_torch/csrc/lm_reproj.cu",
     "visual_sgraphs_tpu/optim/solve.py:85"),
    ("lm_reproj_plan", "visual_sgraphs_tpu_torch.optim.lm_kernels",
     "lm_reproj_plan", "lm_reproj_plan_torch",
     "visual_sgraphs_tpu_torch/csrc/lm_reproj.cu",
     "visual_sgraphs_tpu/optim/solve.py:85"),
    ("lm_reproj_cost", "visual_sgraphs_tpu_torch.optim.lm_kernels",
     "lm_reproj_cost", "lm_reproj_cost_torch",
     "visual_sgraphs_tpu_torch/csrc/lm_reproj.cu",
     "visual_sgraphs_tpu/optim/solve.py:69"),
    ("lm_inertial_plan", "visual_sgraphs_tpu_torch.optim.lm_kernels",
     "lm_inertial_plan", "lm_inertial_plan_torch",
     "visual_sgraphs_tpu_torch/csrc/lm_inertial.cu",
     "visual_sgraphs_tpu/inertial/init.py:44"),
    ("lm_inertial_assemble", "visual_sgraphs_tpu_torch.optim.lm_kernels",
     "lm_inertial_assemble", "lm_inertial_assemble_torch",
     "visual_sgraphs_tpu_torch/csrc/lm_inertial.cu",
     "visual_sgraphs_tpu/inertial/factors.py:58"),
    ("lm_inertial_cost", "visual_sgraphs_tpu_torch.optim.lm_kernels",
     "lm_inertial_cost", "lm_inertial_cost_torch",
     "visual_sgraphs_tpu_torch/csrc/lm_inertial.cu",
     "visual_sgraphs_tpu/inertial/factors.py:84"),
    ("lm_solve", "visual_sgraphs_tpu_torch.optim.lm_kernels", "lm_solve",
     "lm_solve_torch", "visual_sgraphs_tpu_torch/csrc/lm_solve.cu",
     "visual_sgraphs_tpu/optim/solve.py:158"),
    ("rooms_walls", "visual_sgraphs_tpu_torch.scenegraph.manager",
     "detect_rooms", "detect_rooms_torch",
     "visual_sgraphs_tpu_torch/csrc/rooms.cu",
     "visual_sgraphs_tpu/scenegraph/manager.py:310"),
    ("rooms_freespace", "visual_sgraphs_tpu_torch.scenegraph.freespace",
     "detect_rooms_freespace", "detect_rooms_freespace_torch",
     "visual_sgraphs_tpu_torch/csrc/rooms.cu",
     "visual_sgraphs_tpu/scenegraph/freespace.py:122"),
    ("plane_assoc", "visual_sgraphs_tpu_torch.scenegraph.manager",
     "associate_and_update", "associate_and_update_torch",
     "visual_sgraphs_tpu_torch/csrc/plane_assoc.cu",
     "visual_sgraphs_tpu/scenegraph/manager.py:51"),
)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# host arrays of device pointers / ints (the LM kernels' family tables)
_PP, _PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_ROWS = [_VP, _I, _VP, _I] + [_VP] * 5 + [_I, _VP, _VP, _F, _F]
# the plane table (5 pointers, P) and the room table (6 pointers, R)
_ROOMS = [_VP] * 5 + [_I] + [_VP] * 6 + [_I]
_ARGTYPES = {
    "vsg_blur_levels": [_PP, _PP, _PI, _I, _I, _I,
                        ctypes.POINTER(ctypes.c_float), _VP],
    "vsg_pyramid": [_VP, _VP, _I, _VP, _PI] + [_I] * 4 + [_VP],
    "vsg_fast_levels": [_PP, _PP, _PI, _I, _I, _I, _VP],
    "vsg_detect_levels": [_PP, _PI, ctypes.POINTER(ctypes.c_float)]
                         + [_I] * 4 + [_F] + [_VP] * 6,
    "vsg_orb_desc_levels": [_PP, _PI, _I, _I, _VP, _I, _I] + [_VP] * 5,
    "vsg_compact": [_VP, _I, _I, _I, _I, _VP, _VP],
    "vsg_compact_observed": [_VP, _VP, _I, _I, _VP, _VP, _I, _VP, _I, _I,
                             _I, _I, _I, _VP, _VP],
    "vsg_found_stats": [_VP, _VP, _I, _VP, _I, _I, _VP, _I, _I, _VP, _F,
                        _VP, _VP, _VP],
    "vsg_kf_insert": [_PP, _PP, _PP] + [_I] * 6 + [_VP, _I, _VP, _I, _I,
                                                   _VP],
    "vsg_fuse_prologue": [_VP] * 4 + [_I] * 6 + [_VP] * 3,
    "vsg_fuse_writeback": [_VP, _I, _I, _I, _VP, _VP, _VP, _I, _VP, _VP],
    "vsg_map_cull": [_PP, _PP] + [_I] * 6 + [_F, _F, _VP, _VP],
    "vsg_group_obs": [_VP] * 4 + [_I] * 8 + [_VP] * 7,
    "vsg_match_window": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                         _F, _I, _F, _I, _VP, _VP, _VP, _VP],
    "vsg_track_pass": [_VP, _VP, _I, _VP, _I] + [_VP] * 6
                      + [_I, _I] + [_F] * 5 + [_I, _I, _F] + [_I] * 4
                      + [_VP] * 11,
    "vsg_pose_gn": [_VP] * 7 + [_I] * 6 + [_F] * 4 + [_VP, _F, _VP, _VP,
                                                        _VP],
    "vsg_preint": [_VP, _VP, _I, _VP, _VP, _F, _F] + [_VP] * 5,
    "vsg_vi_pose": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I] + [_VP] * 8
                   + [_F, _F, _I, _VP, _VP, _VP],
    "vsg_vi_pose_sections": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I]
                            + [_VP] * 8 + [_F, _F, _I, _VP, _VP, _VP, _I,
                                           _VP],
    "vsg_schur_reduce": [_VP] * 7 + [_I, _I, _I, _F, _F] + [_VP] * 8,
    "vsg_schur_backsub": [_VP] * 6 + [_I, _I, _I] + [_VP] * 4,
    "vsg_ba_solve": [_VP, _VP, _VP, _I, ctypes.c_double]
                    + [_VP, _I] * 4 + [_VP, _VP, _VP],
    "vsg_scan_prologue": [_VP] * 4,
    "vsg_scan_epilogue": [_VP] * 14 + [_I, _I, _VP, _I] + [_VP] * 10,
    "vsg_inlier_tail": [_VP] * 6 + [_I, _I, _I] + [_VP] * 4,
    "vsg_depth_cloud": [_VP] * 4 + [_I, _I, _I, _F, _I, _I] + [_VP] * 10,
    "vsg_extract_planes": [_VP] * 4 + [_I, _I, _I, _F, _F] + [_VP] * 4,
    "vsg_plane_epilogue": [_VP] * 7 + [_I, _I, _F, _F, _I] + [_VP] * 7,
    "vsg_bow_vectors": [_VP] * 3 + [_I] * 13 + [_VP] * 5,
    "vsg_place_query": [_VP] * 7 + [_I, _I, _F, _I, _I, _VP, _I, _VP, _VP],
    "vsg_match_nn_ratio": [_VP] * 6 + [_I, _I, _F, _I, _I] + [_VP] * 4,
    "vsg_guided_count_sim3": [_VP] * 10 + [_I, _I, _I, _F, _I] + [_VP] * 2,
    "vsg_verify_sim3": [_VP] * 4 + [_I, _I, _F, _I, _I] + [_VP] * 6,
    "vsg_pnp_hypotheses": [_VP] * 5 + [_I, _I, _F] + [_VP] * 4,
    "vsg_pgo_assemble": [_VP] * 5 + [_I, _I, _I] + [_VP] * 3,
    "vsg_pgo_cost": [_VP] * 5 + [_I] + [_VP] * 2,
    "vsg_freespace_carve": [_VP, _I, _I, _I] + [_VP] * 4 + [_F, _I, _VP,
                                                            _VP],
    "vsg_freespace_components": [_VP, _I, _VP, _F, _I, _I] + [_VP] * 6,
    "vsg_sg_plan": [_VP] * 4 + [_I] + [_VP] * 3 + [_I] + [_VP] * 2
                   + [_I] * 5 + [_VP] * 9,
    "vsg_sg_system": [_VP, _I] * 4 + [_VP] * 5 + [_I] + [_VP] * 5
                     + [_F] * 5 + [_VP] * 15,
    "vsg_lm_reproj_plan": [_VP, _VP, _I, _I, _VP, _VP, _VP],
    "vsg_lm_reproj_reduce": _ROWS + [_VP, _F, _I] + [_VP] * 12,
    "vsg_lm_reproj_cost": _ROWS + [_VP] * 9 + [_I, _I, _VP, _VP, _I, _VP],
    "vsg_lm_inertial_plan": [_VP] * 3 + [_I, _I] + [_VP] * 6,
    "vsg_lm_inertial_assemble": [_VP, _PP, _VP, _VP, _I, _VP],
    "vsg_lm_inertial_cost": [_VP, _PP, _VP, _I, _VP],
    "vsg_lm_solve": [_VP] * 4 + [_I, _VP, _I, _VP, _F] + [_VP] * 7
                    + [_PI, _VP, _VP],
    "vsg_rooms_walls": _ROOMS + [_F] * 4 + [_I] + [_VP] * 7,
    "vsg_rooms_freespace": _ROOMS + [_VP, _VP, _I] + [_F] * 5 + [_VP] * 7,
    "vsg_plane_assoc": [_PP, _PP, _PP] + [_I] * 5 + [_F] * 3 + [_VP],
}

# host-side plan queries: (argument types, return type)
_QUERIES = {
    "vsg_schur_scratch_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "vsg_lm_reproj_scratch_bytes": ([_I, _I], ctypes.c_longlong),
    "vsg_ba_solve_scratch": ([_I], ctypes.c_longlong),
    "vsg_map_cull_smem": ([_I, _I], ctypes.c_longlong),
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False, verbose: bool = False) -> tuple[Path, float]:
    """Compile ``csrc/*.cu`` into the shared library unless an up-to-date
    build exists: one ``nvcc -c`` per source, all started together, then
    one link (``verbose``: print ptxas's registers, shared memory and
    spills per kernel).  Returns (library path, seconds spent)."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if (not force and lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib_path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, logs = [], []
    for obj, proc in procs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"{obj.name} ({proc.returncode}):\n{err}")
    objs = [obj for obj, _ in procs]
    try:
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = BUILD_DIR / (LIB_NAME + f".tmp{os.getpid()}")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    dt = time.perf_counter() - t0
    if verbose:
        print("".join(logs))
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path, dt


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in _QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib.vsg_error_string.argtypes = [ctypes.c_int]
        lib.vsg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Call C entry point ``name``; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.vsg_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def query(name: str, *args) -> int:
    """The value host-side plan query ``name`` returns (no launch)."""
    return getattr(library(), name)(*args)


def stream() -> int:
    """The current CUDA stream of the current device, as an int (without
    building a ``torch.cuda.Stream``: a wrapper's host time counts)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def ptr_array(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (None -> null)."""
    return (ctypes.c_void_p * len(tensors))(*map(ptr, tensors))


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when no card is
    available (entry points default to the card and never fall back to
    the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (by device index: a wrapper's host time counts)."""
    dev = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != dev or dev < 0:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def kernel_functions():
    """[(name, wrapper, twin, source, replaces)] for every kernel."""
    out = []
    for name, mod, wrapper, twin, src, replaces in KERNELS:
        m = importlib.import_module(mod)
        out.append((name, getattr(m, wrapper), getattr(m, twin), src,
                    replaces))
    return out


def reset_counts() -> None:
    for _, wrapper, twin, _, _ in kernel_functions():
        wrapper.launches = 0
        twin.cuda_calls = 0


def counts() -> dict:
    """{name: (launches, twin calls on CUDA tensors)}."""
    return {name: (wrapper.launches, twin.cuda_calls)
            for name, wrapper, twin, _, _ in kernel_functions()}
