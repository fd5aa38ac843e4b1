"""Free-space room segmentation: the reference's primary room method.

Port of ``visual_sgraphs_tpu/scenegraph/freespace.py``
(SemanticsManager::detectMapRoomCandidateVoxblox, SemanticsManager.cc:
302-403): the voxblox skeleton's free-space clusters, computed on the card.

1. ``accumulate_freespace`` (kernel K17a, ``csrc/freespace.cu``): every
   ``stride``-th pixel's viewing ray is sampled at 5 interior fractions of
   its measured depth and the samples' voxels of a (G, G, G) grid are
   marked free.
2. ``freespace_cluster_centers`` (kernel K17b, ``freespace_components``):
   6-connected components by 48 synchronous (Jacobi) sweeps of min-label
   propagation, their sizes, the 4 largest (lower label first on ties) and
   their centroids.
3. ``detect_rooms_freespace`` (kernel K23's free-space entry,
   ``csrc/rooms.cu``, which it shares with ``manager.detect_rooms``): per
   cluster, the walls near its centre compete in the facing-pair
   analysis; room / corridor candidates are upserted.

Each kernel's wrapper launches it on CUDA tensors (counting the launch in
``wrapper.launches``) and takes its plain twin only for CPU tensors (the
twin counts calls on CUDA tensors in ``twin.cuda_calls``).  Nothing here
reads the device back.
"""

from __future__ import annotations

import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.scenegraph.manager import (
    _take,
    launch_rooms,
    upsert_room,
)
from visual_sgraphs_tpu_torch.scenegraph.state import (
    GROUND,
    WALL,
    SceneGraphState,
    plane_semantics,
)
from visual_sgraphs_tpu_torch.slam.tracking import topk_stable

FRACS = (0.2, 0.4, 0.55, 0.7, 0.85)  # interior fractions of each ray
MIN_DEPTH = 0.3  # m: shallower depth samples carve nothing
MAX_LABEL_GRID = 32  # K17b holds 6 G^3 bytes of labels in shared memory


def _camera_to_world(T_cw):
    """(R (3, 3), C (3,)) of T_wc = se3_inverse(T_cw), as the reference
    forms them.  Kernel and twin both take these from here, so they map
    the samples with the same rotation bit for bit."""
    T_wc = lie.se3_inverse(T_cw)
    return lie.quat_to_matrix(T_wc[:4]).contiguous(), T_wc[4:7].contiguous()


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add
    rounds it (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def accumulate_freespace_torch(grid, origin, voxel: float, depth_img, T_cw,
                               cam_K, stride: int = 8):
    """Plain twin of K17a (reference ``freespace.py:41``).  Marks, in
    place, the voxels of ``grid`` ((G, G, G) bool) that the samples fall
    in and returns it.  Every operation rounds where the reference's (XLA's
    CPU build) does: the rotation of a sample is a chain of two fused
    multiply-adds after its first product, then the centre is added."""
    if grid.is_cuda:
        accumulate_freespace_torch.cuda_calls += 1
    G = grid.shape[0]
    dev = grid.device
    h, w = depth_img.shape
    R, C = _camera_to_world(T_cw)
    vs = torch.arange(0, h, stride, dtype=torch.float32, device=dev)
    us = torch.arange(0, w, stride, dtype=torch.float32, device=dev)
    z = depth_img[::stride, ::stride]  # (hs, ws)
    rx = ((us - cam_K[2]) / cam_K[0])[None, :]
    ry = ((vs - cam_K[3]) / cam_K[1])[:, None]
    fracs = torch.tensor(FRACS, dtype=torch.float32).to(dev)
    s = z[None] * fracs[:, None, None]  # (5, hs, ws): depth along the ray
    p = (rx * s, ry * s, s)
    vox = torch.full((), voxel, dtype=torch.float32, device=dev)
    idx = []
    for i in range(3):
        p_w = _fma(R[i, 2], p[2], _fma(R[i, 1], p[1], R[i, 0] * p[0])) + C[i]
        idx.append(torch.floor((p_w - origin[i]) / vox).to(torch.int32))
    inb = (z > MIN_DEPTH)[None]
    for k in idx:
        inb = inb & (k >= 0) & (k < G)
    flat = (idx[0].clamp(0, G - 1) * G + idx[1].clamp(0, G - 1)) * G \
        + idx[2].clamp(0, G - 1)
    g = grid.reshape(-1).to(torch.int32)
    g.scatter_reduce_(0, torch.where(inb, flat, 0).reshape(-1).long(),
                      inb.reshape(-1).to(torch.int32), "amax")
    grid.copy_(g.reshape(G, G, G) > 0)
    return grid


accumulate_freespace_torch.cuda_calls = 0


def accumulate_freespace(grid, origin, voxel: float, depth_img, T_cw, cam_K,
                         stride: int = 8):
    """Mark, in place, the voxels of ``grid`` ((G, G, G) bool) crossed by
    this view's rays (kernel K17a on CUDA tensors, the twin on CPU) and
    return it.  ``origin``: (3,) world min corner; ``voxel``: edge length;
    ``depth_img``: (h, w) metres; ``T_cw``: (7,) pose; ``cam_K``: (4,)."""
    if grid.device.type == "cpu":
        return accumulate_freespace_torch(grid, origin, voxel, depth_img,
                                          T_cw, cam_K, stride)
    cuda.require_cuda("accumulate_freespace", grid, origin, depth_img,
                      cam_K)
    if (grid.dtype != torch.bool or grid.ndim != 3
            or any(t.dtype != torch.float32
                   for t in (origin, depth_img, T_cw, cam_K))):
        raise ValueError("accumulate_freespace: (G, G, G) bool grid, "
                         "float32 operands")
    R, C = _camera_to_world(T_cw)
    h, w = depth_img.shape
    cuda.call("vsg_freespace_carve", cuda.ptr(depth_img), h, w, stride,
              cuda.ptr(cam_K), cuda.ptr(R), cuda.ptr(C), cuda.ptr(origin),
              float(voxel), grid.shape[0], cuda.ptr(grid), cuda.stream())
    accumulate_freespace.launches += 1
    return grid


accumulate_freespace.launches = 0


def freespace_components_torch(grid, origin, voxel: float,
                               n_clusters: int = 4, iters: int = 48):
    """Plain twin of K17b (reference ``freespace.py:75``).  Returns
    (centers (C, 3), valid (C,), top sizes (C,) int32, top labels (C,)
    int32, labels (G, G, G) int32, BIG where not free)."""
    if grid.is_cuda:
        freespace_components_torch.cuda_calls += 1
    G = grid.shape[0]
    dev = grid.device
    big = G * G * G + 1
    lab = torch.where(grid, torch.arange(G ** 3, dtype=torch.int32,
                                         device=dev).reshape(G, G, G), big)
    for _ in range(iters):
        m = lab
        for ax in range(3):
            for d in (1, -1):
                sh = torch.roll(lab, d, dims=ax)
                edge = [slice(None)] * 3
                edge[ax] = 0 if d > 0 else -1
                sh[tuple(edge)] = big
                m = torch.minimum(m, sh)
        lab = torch.where(grid, torch.minimum(lab, m), big)
    flat = lab.reshape(-1)
    occ = grid.reshape(-1)
    sizes = torch.zeros((G ** 3 + 2,), dtype=torch.int32, device=dev)
    sizes.index_add_(0, torch.where(occ, flat, G ** 3 + 1).long(),
                     occ.to(torch.int32))
    top_sz, top_lab = topk_stable(sizes[:G ** 3], n_clusters)
    ar = torch.arange(G, dtype=torch.float32, device=dev)
    coords = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                         dim=-1).reshape(-1, 3)
    vox = torch.full((), voxel, dtype=torch.float32, device=dev)
    centers = []
    for c in range(n_clusters):
        msk = occ & (flat == top_lab[c])
        cnt = torch.clamp(msk.sum(), min=1).to(torch.float32)
        ctr = torch.where(msk[:, None], coords, 0.0).sum(0) / cnt
        # one rounding for the affine map, as the reference's fused
        # multiply-add
        centers.append(_fma(ctr + 0.5, vox, origin))
    return (torch.stack(centers), top_sz > 8, top_sz.to(torch.int32),
            top_lab.to(torch.int32), lab)


freespace_components_torch.cuda_calls = 0


def freespace_components(grid, origin, voxel: float, n_clusters: int = 4,
                         iters: int = 48, with_labels: bool = True):
    """Components of the free grid (kernel K17b on CUDA tensors, the twin
    on CPU); returns as ``freespace_components_torch`` (the kernel writes
    the labels only ``with_labels``, else returns None for them)."""
    if grid.device.type == "cpu":
        out = freespace_components_torch(grid, origin, voxel, n_clusters,
                                         iters)
        return out if with_labels else out[:4] + (None,)
    cuda.require_cuda("freespace_components", grid, origin)
    G = grid.shape[0]
    if (grid.dtype != torch.bool or grid.shape != (G, G, G)
            or G > MAX_LABEL_GRID or origin.dtype != torch.float32
            or not 1 <= n_clusters <= 8):
        raise ValueError("freespace_components: (G, G, G) bool grid with "
                         f"G <= {MAX_LABEL_GRID}, float32 origin, 1-8 "
                         "clusters")
    dev = grid.device
    centers = torch.empty((n_clusters, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((n_clusters,), dtype=torch.bool, device=dev)
    top_sz = torch.empty((n_clusters,), dtype=torch.int32, device=dev)
    top_lab = torch.empty((n_clusters,), dtype=torch.int32, device=dev)
    labels = (torch.empty((G, G, G), dtype=torch.int32, device=dev)
              if with_labels else None)
    cuda.call("vsg_freespace_components", cuda.ptr(grid), G,
              cuda.ptr(origin), float(voxel), n_clusters, iters,
              cuda.ptr(centers), cuda.ptr(valid), cuda.ptr(top_sz),
              cuda.ptr(top_lab), cuda.ptr(labels), cuda.stream())
    freespace_components.launches += 1
    return centers, valid, top_sz, top_lab, labels


freespace_components.launches = 0


def freespace_cluster_centers(grid, origin, voxel: float,
                              n_clusters: int = 4, iters: int = 48):
    """(C, 3) world centroids of the ``n_clusters`` largest 6-connected
    free components and (C,) validity (size > 8 voxels)."""
    centers, valid, _, _, _ = freespace_components(
        grid, origin, voxel, n_clusters, iters, with_labels=False)
    return centers, valid


def detect_rooms_freespace_torch(sg: SceneGraphState, centers,
                                 centers_valid, min_votes: float = 3.0,
                                 wall_dist: float = 4.0,
                                 min_gap: float = 0.8, max_gap: float = 12.0,
                                 perp_tol: float = 0.2) -> SceneGraphState:
    """Plain twin of K23's free-space entry (reference
    ``freespace.py:122``).  The reference's ``lax.scan`` over the clusters
    is a Python loop; every selection stays on the device."""
    if sg.pl_coeffs.is_cuda:
        detect_rooms_freespace_torch.cuda_calls += 1
    sem = plane_semantics(sg, min_votes)
    P = sg.P
    dev = sg.pl_coeffs.device
    n = sg.pl_coeffs[:, :3]
    d = sg.pl_coeffs[:, 3]
    is_ground = sg.pl_valid & (sem == GROUND)
    is_wall_all = sg.pl_valid & (sem == WALL)
    ar = torch.arange(P, device=dev)
    pi = ar.repeat_interleave(P)
    pj = ar.repeat(P)
    # the cluster-independent pair geometry
    dot = n @ n.T
    cdiff = sg.pl_centroid[None, :, :] - sg.pl_centroid[:, None, :]
    gap = torch.abs(torch.einsum("pi,pqi->pq", n, cdiff))
    pair_ok = (dot < -0.9) & (gap > min_gap) & (gap < max_gap) \
        & (ar[:, None] < ar[None, :])
    pc_flat = (0.5 * (sg.pl_centroid[:, None, :]
                      + sg.pl_centroid[None, :, :])).reshape(P * P, 3)
    npair = sg.pl_npts[pi] + sg.pl_npts[pj]
    for c in range(centers.shape[0]):
        center_c, ok_c = centers[c], centers_valid[c]
        plane_d = torch.abs(n @ center_c + d)
        lat_c = torch.linalg.norm(sg.pl_centroid - center_c[None, :], dim=-1)
        near = (plane_d < wall_dist) & (lat_c < 2.0 * wall_dist)
        is_wall = is_wall_all & near & ok_c
        fac_flat = (is_wall[:, None] & is_wall[None, :]
                    & pair_ok).reshape(-1)
        support = torch.where(fac_flat, npair, -1.0)
        b1 = torch.argmax(support)
        i1, j1 = _take(pi, b1), _take(pj, b1)
        have1 = _take(support, b1) > 0
        n1 = _take(n, i1)
        perp = torch.abs(n[pi] @ n1) < perp_tol
        score2 = torch.where(
            fac_flat & perp,
            -torch.linalg.norm(pc_flat - center_c[None, :], dim=-1),
            -torch.inf)
        b2 = torch.argmax(score2)
        i2, j2 = _take(pi, b2), _take(pj, b2)
        have2 = torch.isfinite(_take(score2, b2))

        c1 = _take(pc_flat, b1)
        room_found = have1 & have2
        room_center = 0.5 * (c1 + _take(pc_flat, b2))
        neg = torch.full_like(i1, -1)
        room_walls = torch.stack([i1, j1, i2, j2]).to(torch.int32)
        corridor_found = have1 & ~have2
        corr_walls = torch.stack([i1, j1, neg, neg]).to(torch.int32)
        found = room_found | corridor_found
        center = torch.where(room_found, room_center, c1)
        walls = torch.where(room_found, room_walls, corr_walls)

        sg = upsert_room(sg, found, center, walls, corridor_found,
                         is_ground, max_gap)
    return sg


detect_rooms_freespace_torch.cuda_calls = 0


def detect_rooms_freespace(sg: SceneGraphState, centers, centers_valid,
                           min_votes: float = 3.0, wall_dist: float = 4.0,
                           min_gap: float = 0.8, max_gap: float = 12.0,
                           perp_tol: float = 0.2) -> SceneGraphState:
    """Room / corridor candidates seeded by free-space cluster centres
    ((C, 3), validity (C,)): per cluster, only the walls within
    ``wall_dist`` of its centre compete in the facing-pair analysis, so
    adjacent rooms with parallel walls cannot cross-pair.  Kernel K23
    (``rooms_freespace``) on CUDA tensors, the twin on CPU."""
    if sg.pl_coeffs.device.type == "cpu":
        return detect_rooms_freespace_torch(sg, centers, centers_valid,
                                            min_votes, wall_dist, min_gap,
                                            max_gap, perp_tol)
    C = centers.shape[0]
    if (centers.shape != (C, 3) or centers.dtype != torch.float32
            or centers_valid.shape != (C,)
            or centers_valid.dtype != torch.bool):
        raise ValueError("detect_rooms_freespace: (C, 3) float32 centres, "
                         "(C,) bool validity")
    out = launch_rooms("vsg_rooms_freespace", sg, centers, centers_valid, C,
                       float(min_votes), float(wall_dist), float(min_gap),
                       float(max_gap), float(perp_tol))
    detect_rooms_freespace.launches += 1
    return out


detect_rooms_freespace.launches = 0
