"""Essential-graph (Sim3 pose-graph) optimisation and loop-closure map
correction, with kernel K19 assembling the pose graph's normal equations.

Port of ``visual_sgraphs_tpu/place/pgo.py`` (Optimizer::
OptimizeEssentialGraph and the correction half of LoopClosing::
CorrectLoop): the edge set is mined from the covisibility matrix in one
masked top-k (plus consecutive-keyframe links standing in for the
spanning tree), the loop edge carries the verified Sim3 with information
100, and the solve is the shared LM engine (``optim/solve.py``) over a
``sim3`` family.  Points move with their reference keyframe's correction
X' = S_new^-1 . S_old . X (LoopClosing.cc:1010-1035); planes, rooms,
doors and markers follow the same per-keyframe Sim3.

Not ported: the scene-graph-weighted edge mining (``sg=`` of
``build_covis_edges``, which the loop closer never passes) and the
inertial 4-dof solve.

``pgo_assemble`` / ``pgo_cost`` launch the hand kernels in ``csrc/pgo.cu``
on CUDA tensors; their plain twins are the generic engine
(``optim/solve.py::_assemble`` / ``problem_cost``, forward-mode autodiff)
on the same problem, used on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.core import plane as plane_mod
from visual_sgraphs_tpu_torch.optim import factors
from visual_sgraphs_tpu_torch.optim.graph import (
    FactorBatch,
    GraphProblem,
    sim3_family,
)
from visual_sgraphs_tpu_torch.optim.solve import (
    _assemble,
    optimize,
    problem_cost,
)
from visual_sgraphs_tpu_torch.slam.map_state import MapState
from visual_sgraphs_tpu_torch.slam.tracking import topk_stable


class EssentialEdges(NamedTuple):
    idx: torch.Tensor  # (E, 2) int32 keyframe pairs
    valid: torch.Tensor  # (E,) bool


def build_covis_edges(m: MapState, min_weight: int = 30,
                      max_edges: int = 512) -> EssentialEdges:
    """Covisibility pairs with at least ``min_weight`` shared points plus
    each keyframe's insertion-order predecessor, the strongest
    ``max_edges`` kept (lax.top_k's tie order)."""
    K, N = m.K, m.N
    dev = m.kf_pose.device
    obs = torch.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_obs_pt, -1)
    member = torch.zeros((K, N + 1), dtype=torch.float32, device=dev)
    member[torch.arange(K, device=dev)[:, None], obs.long() + 1] = \
        torch.ones((), device=dev)
    # culled-point slots must not bridge unrelated keyframes (slot reuse)
    member = member[:, 1:] * m.pt_valid.to(torch.float32)[None, :]
    covis = member @ member.T  # (K, K) shared-point counts (exact)
    i_idx = torch.arange(K, device=dev)[:, None].expand(K, K)
    j_idx = torch.arange(K, device=dev)[None, :].expand(K, K)
    upper = j_idx > i_idx
    # temporal predecessor keyed on the insertion sequence (slots are
    # reused): pred[j] = valid keyframe with the largest seq below seq[j]
    seq = torch.where(m.kf_valid, m.kf_seq, -1)
    cand = torch.where((seq[:, None] < seq[None, :]) & (seq[:, None] >= 0),
                       seq[:, None], -1)
    pred = torch.argmax(cand, dim=0)
    has_pred = (torch.amax(cand, dim=0) >= 0) & (seq >= 0)
    consecutive = ((i_idx == pred[None, :]) & has_pred[None, :]
                   & m.kf_valid[None, :] & m.kf_valid[:, None])
    strong = upper & (covis >= min_weight)
    score = (torch.where(strong, covis, 0.0)
             + torch.where(consecutive, 1e6, 0.0))
    top_vals, top_flat = topk_stable(score.reshape(-1), max_edges)
    idx = torch.stack([top_flat // K, top_flat % K], dim=1).to(torch.int32)
    return EssentialEdges(idx=idx, valid=top_vals > 0)


class PgoResult(NamedTuple):
    kf_pose: torch.Tensor  # (K, 7) corrected T_cw
    S_old: torch.Tensor  # (K, 8) pre-correction Sim3 (scale 1)
    S_new: torch.Tensor  # (K, 8) optimised Sim3 poses
    cost0: torch.Tensor
    cost: torch.Tensor


def _retract_fixed_scale(v, d):
    """sim3_boxplus with the scale component of the update zeroed
    (bFixScale)."""
    return lie.sim3_boxplus(v, torch.cat([d[..., :6],
                                          torch.zeros_like(d[..., 6:])],
                                         dim=-1))


def pgo_problem(S, var_idx, S_meas, info, valid, fixed=None,
                fix_scale: bool = False) -> GraphProblem:
    """The essential graph as a generic problem: one ``relative_sim3``
    batch over a ``sim3`` family."""
    fam = sim3_family(S, fixed)
    if fix_scale:
        fam = dataclasses.replace(fam, retract=_retract_fixed_scale)
    batch = FactorBatch(("kf", "kf"), factors.relative_sim3, 7, var_idx,
                        {"S_ji": S_meas}, info, valid)
    return GraphProblem(families={"kf": fam}, factors=[batch])


def pgo_assemble_torch(S, var_idx, S_meas, info, valid,
                       fix_scale: bool = False):
    """Plain twin of K19's assembly: the generic linearisation and scatter
    of ``optim/solve.py::_assemble``.  Returns (H (7K, 7K), g (7K,))."""
    if S.is_cuda:
        pgo_assemble_torch.cuda_calls += 1
    problem = pgo_problem(S, var_idx, S_meas, info, valid,
                          fix_scale=fix_scale)
    H, g, _, _, _ = _assemble(problem, {"kf": S})
    return H, g


pgo_assemble_torch.cuda_calls = 0


def _check(name, S, var_idx, S_meas, info, valid):
    cuda.require_cuda(name, S, var_idx, S_meas, info, valid)
    if any(t.dtype != torch.float32 for t in (S, S_meas, info)) \
            or var_idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"{name}: float32 values, int32 indices, bool mask")


def pgo_assemble(S, var_idx, S_meas, info, valid, fix_scale: bool = False):
    """Pose-graph normal equations (kernel K19 on CUDA tensors, the twin
    on CPU)."""
    if S.device.type == "cpu":
        return pgo_assemble_torch(S, var_idx, S_meas, info, valid, fix_scale)
    _check("pgo_assemble", S, var_idx, S_meas, info, valid)
    K, E = S.shape[0], var_idx.shape[0]
    H = torch.zeros((7 * K, 7 * K), dtype=torch.float32, device=S.device)
    g = torch.zeros((7 * K,), dtype=torch.float32, device=S.device)
    cuda.call("vsg_pgo_assemble", cuda.ptr(S), cuda.ptr(var_idx),
              cuda.ptr(S_meas), cuda.ptr(info), cuda.ptr(valid), E, K,
              int(fix_scale), cuda.ptr(H), cuda.ptr(g), cuda.stream())
    pgo_assemble.launches += 1
    return H, g


pgo_assemble.launches = 0


def pgo_cost_torch(S, var_idx, S_meas, info, valid):
    """Plain twin of K19's cost: ``problem_cost`` of the pose graph."""
    if S.is_cuda:
        pgo_cost_torch.cuda_calls += 1
    return problem_cost(pgo_problem(S, var_idx, S_meas, info, valid),
                        {"kf": S})


pgo_cost_torch.cuda_calls = 0


def pgo_cost(S, var_idx, S_meas, info, valid):
    """Pose-graph cost sum info * |r|^2 over valid edges (kernel K19's
    second entry on CUDA tensors, the twin on CPU)."""
    if S.device.type == "cpu":
        return pgo_cost_torch(S, var_idx, S_meas, info, valid)
    _check("pgo_cost", S, var_idx, S_meas, info, valid)
    out = torch.empty((), dtype=torch.float32, device=S.device)
    cuda.call("vsg_pgo_cost", cuda.ptr(S), cuda.ptr(var_idx),
              cuda.ptr(S_meas), cuda.ptr(info), cuda.ptr(valid),
              var_idx.shape[0], cuda.ptr(out), cuda.stream())
    pgo_cost.launches += 1
    return out


pgo_cost.launches = 0


def essential_graph(kf_pose, kf_valid, edges: EssentialEdges, loop_i: int,
                    loop_j: int, S_loop_ji):
    """(S_old, var_idx, S_meas, info, valid) of the Sim3 pose graph: the
    current relative poses on the mined edges, and the loop edge."""
    dev = kf_pose.device
    S_old = lie.sim3_from_se3(kf_pose)
    ei, ej = edges.idx[:, 0].long(), edges.idx[:, 1].long()
    rel = lie.sim3_multiply(S_old[ej], lie.sim3_inverse(S_old[ei]))
    e_valid = edges.valid & kf_valid[ei] & kf_valid[ej]
    loop = torch.stack([torch.full((), loop_i, dtype=torch.int32,
                                   device=dev),
                        torch.full((), loop_j, dtype=torch.int32,
                                   device=dev)])
    var_idx = torch.cat([edges.idx, loop[None]])
    S_meas = torch.cat([rel, S_loop_ji[None]]).contiguous()
    valid = torch.cat([e_valid, torch.ones((1,), dtype=torch.bool,
                                           device=dev)])
    info = torch.cat([torch.ones((ei.shape[0],), dtype=torch.float32,
                                 device=dev),
                      torch.full((1,), 100.0, dtype=torch.float32,
                                 device=dev)])
    return S_old, var_idx, S_meas, info, valid


def optimize_essential_graph(kf_pose, kf_valid, edges: EssentialEdges,
                             loop_i: int, loop_j: int, S_loop_ji, fixed,
                             iters: int = 20,
                             fix_scale: bool = False) -> PgoResult:
    """Sim3 pose-graph solve: non-loop edges hold the current relative
    poses, the loop edge the verified Sim3; ``fixed`` keyframes (the loop
    candidate) are the gauge; ``fix_scale`` freezes every keyframe's scale
    (RGB-D / stereo).  K19 linearises and scores each LM iteration."""
    S_old, var_idx, S_meas, info, valid = essential_graph(
        kf_pose, kf_valid, edges, loop_i, loop_j, S_loop_ji)
    problem = pgo_problem(S_old, var_idx, S_meas, info, valid,
                          fixed=fixed | ~kf_valid, fix_scale=fix_scale)
    res = optimize(
        problem, iters=iters,
        assemble=lambda v: pgo_assemble(v["kf"].contiguous(), var_idx,
                                        S_meas, info, valid, fix_scale),
        cost=lambda v: pgo_cost(v["kf"].contiguous(), var_idx, S_meas,
                                info, valid))
    S_new = lie.sim3_normalize(res.values["kf"])
    # Sim3 -> SE3 as [R, t/s] (CorrectedSiw -> Tiw)
    kf_new = torch.cat([S_new[:, :4], S_new[:, 4:7] / S_new[:, 7:8]], dim=1)
    kf_new = torch.where(kf_valid[:, None], kf_new, kf_pose)
    return PgoResult(kf_pose=kf_new, S_old=S_old, S_new=S_new,
                     cost0=res.initial_cost, cost=res.cost)


def _corrections(pgo: PgoResult):
    """(K, 8) world-space correction S_new^-1 . S_old per keyframe."""
    return lie.sim3_multiply(lie.sim3_inverse(pgo.S_new), pgo.S_old)


def correct_map(m: MapState, pgo: PgoResult) -> MapState:
    """Corrected keyframe poses; every valid point moved with its
    reference (creating) keyframe's correction."""
    ref = torch.clamp(m.pt_first_kf, 0, m.K - 1).long()
    new_pos = lie.sim3_apply(_corrections(pgo)[ref], m.pt_pos)
    new_pos = torch.where(m.pt_valid[:, None], new_pos, m.pt_pos)
    return m._replace(kf_pose=pgo.kf_pose, pt_pos=new_pos)


def correct_scenegraph(sg, pgo: PgoResult, m: MapState):
    """Carry the loop correction into the scene graph: each plane through
    its earliest observing keyframe, rooms through their first wall's,
    doors and markers through the nearest keyframe by camera centre."""
    K = m.K
    dev = m.kf_pose.device
    S_corr = _corrections(pgo)
    P = sg.pl_coeffs.shape[0]
    ob_pl = torch.where(sg.ob_valid & (sg.ob_plane >= 0), sg.ob_plane, P)
    pl_ref = torch.full((P + 1,), K, dtype=torch.int32, device=dev)
    pl_ref = pl_ref.scatter_reduce(0, ob_pl.long(),
                                   torch.clamp(sg.ob_kf, 0, K - 1), "amin")[:P]
    pl_has_ref = pl_ref < K
    pl_ref = torch.clamp(pl_ref, 0, K - 1).long()
    S_pl = S_corr[pl_ref]
    upd_pl = (sg.pl_valid & pl_has_ref)[:, None]
    new_coeffs = torch.where(upd_pl, plane_mod.transform_sim3(
        S_pl, sg.pl_coeffs), sg.pl_coeffs)
    new_centroid = torch.where(upd_pl, lie.sim3_apply(S_pl, sg.pl_centroid),
                               sg.pl_centroid)

    w0 = torch.clamp(sg.room_walls[:, 0], 0, P - 1).long()
    room_ok = sg.room_valid & (sg.room_walls[:, 0] >= 0) & pl_has_ref[w0]
    new_rc = torch.where(room_ok[:, None], lie.sim3_apply(
        S_corr[pl_ref[w0]], sg.room_center), sg.room_center)

    cam_c = lie.se3_inverse(m.kf_pose)[:, 4:7]

    def nearest_kf(p):
        d2 = torch.sum((cam_c[None, :, :] - p[:, None, :]) ** 2, dim=-1)
        return torch.argmin(torch.where(m.kf_valid[None, :], d2, torch.inf),
                            dim=1)

    def corr_pose(T_we, S):
        R_new = lie.quat_multiply(S[:, :4], T_we[:, :4])
        t_new = lie.sim3_apply(S, T_we[:, 4:7])
        return lie.se3_normalize(torch.cat([R_new, t_new], dim=-1))

    new_door = torch.where(sg.door_valid[:, None], corr_pose(
        sg.door_pose, S_corr[nearest_kf(sg.door_pose[:, 4:7])]),
        sg.door_pose)
    new_mk = torch.where(sg.marker_valid[:, None], corr_pose(
        sg.marker_pose, S_corr[nearest_kf(sg.marker_pose[:, 4:7])]),
        sg.marker_pose)
    return sg._replace(pl_coeffs=new_coeffs, pl_centroid=new_centroid,
                       room_center=new_rc, door_pose=new_door,
                       marker_pose=new_mk)
