"""ORB extractor: grid-distributed FAST + IC angle + steered rBRIEF.

Port of ``visual_sgraphs_tpu/features/orb.py``:

- FAST score + NMS is kernel K2 (``features/fast.py``): ``fast_levels``
  scores every budgeted level of an extraction in one launch;
- keypoint selection (K3: per-32x32-cell top-2, then per-level
  top-budget) is the kernel in ``csrc/detect.cu``: ``detect_levels``
  selects every budgeted level of an extraction in one launch, straight
  into the extraction's concatenated arrays (``detect_level`` is the same
  kernel on one level), with the plain twin ``detect_levels_torch`` over
  ``detect_level_torch``, whose stable descending sorts reproduce
  ``lax.top_k``'s lower-index-first tie order;
- ``orb_describe_levels`` is kernel K4 (IC angle over the r=15 disc +
  steered BRIEF-256 from the blurred levels, ``csrc/orb_desc.cu``) over
  every budgeted level's keypoints of an extraction in one launch,
  straight into the extraction's angles and descriptors, with the plain
  twin ``orb_describe_levels_torch`` over ``orb_describe_torch``;
  ``orb_describe`` is the same kernel on one level's rows.

The BRIEF pattern is the reference's seeded numpy pattern, drawn with the
same numpy call.  All keypoint tensors are fixed capacity with validity
masks.  ``extract_orb`` takes one frame or a (B, H, W) batch: K1's resize
chain, K2, K3, K1's blur (``pyramid.gaussian_blur_levels``) and K4 launch
once an extraction each, for the whole batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.features.fast import fast_levels
from visual_sgraphs_tpu_torch.features.pyramid import (
    build_pyramid,
    gaussian_blur_levels,
)

PATCH_RADIUS = 15  # IC-angle circular patch
GATHER_RADIUS = 20  # descriptor sampling patch (covers rotated +-13 offsets)


@dataclasses.dataclass(frozen=True)
class OrbParams:
    n_features: int = 1000
    n_levels: int = 8
    scale: float = 1.2
    ini_thresh: float = 20.0
    min_thresh: float = 7.0
    cell_size: int = 32
    pattern_seed: int = 42


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one image (K = n_features)."""

    uv: torch.Tensor  # (K, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (K,) FAST score
    level: torch.Tensor  # (K,) int32 pyramid level
    angle: torch.Tensor  # (K,) radians
    valid: torch.Tensor  # (K,) bool
    desc: torch.Tensor  # (K, 32) uint8 packed 256-bit descriptors


def level_budgets(params: OrbParams) -> list[int]:
    """Geometric per-level feature budget (ORBextractor.cc ctor)."""
    inv = 1.0 / params.scale
    per0 = params.n_features * (1 - inv) / (1 - inv**params.n_levels)
    budgets = [int(round(per0 * inv**lv)) for lv in range(params.n_levels)]
    budgets[-1] = max(0, params.n_features - sum(budgets[:-1]))
    return budgets


def _brief_pattern(seed: int) -> np.ndarray:
    """(256, 4) int8 sampling offsets (x1, y1, x2, y2), Gaussian sigma=S/5."""
    rng = np.random.default_rng(seed)
    sigma = 31 / 5.0
    pts = rng.normal(0.0, sigma, size=(256, 4))
    return np.clip(np.round(pts), -13, 13).astype(np.int8)


def _circular_mask(radius: int) -> np.ndarray:
    ys, xs = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    return (xs * xs + ys * ys) <= radius * radius


@functools.lru_cache(maxsize=None)
def _ic_weights(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    mask = _circular_mask(PATCH_RADIUS)
    ys, xs = np.mgrid[-PATCH_RADIUS: PATCH_RADIUS + 1,
                      -PATCH_RADIUS: PATCH_RADIUS + 1]
    return (torch.from_numpy(np.asarray(xs * mask, np.float32)).to(device),
            torch.from_numpy(np.asarray(ys * mask, np.float32)).to(device))


@functools.lru_cache(maxsize=None)
def brief_pattern_tensor(seed: int, device: torch.device) -> torch.Tensor:
    """(256, 4) float32 pattern on ``device`` (made once per device)."""
    return torch.from_numpy(_brief_pattern(seed).astype(np.float32)).to(device)


def _topk_stable(x: torch.Tensor, k: int, dim: int = -1):
    """Top-k values/indices with lax.top_k's tie order (lower index first)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def detect_level_torch(score: torch.Tensor, budget: int, params: OrbParams):
    """Plain twin of K3: per-cell top-2, then the level's top-``budget``
    keypoints of an (H, W) score image or a (B, H, W) batch.

    Returns (rc (..., budget, 2) int32, resp (..., budget), valid
    (..., budget))."""
    if score.is_cuda:
        detect_level_torch.cuda_calls += 1
    h, w = score.shape[-2:]
    x = score.reshape(-1, h, w)
    B = x.shape[0]
    cs = params.cell_size
    ncy, ncx = -(-h // cs), -(-w // cs)
    padded = torch.nn.functional.pad(x, (0, ncx * cs - w, 0, ncy * cs - h))
    cells = padded.reshape(B, ncy, cs, ncx, cs).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, ncy * ncx, cs * cs)
    vals, idx = _topk_stable(cells, 2, dim=2)  # (B, C, 2)
    cell_ids = torch.arange(ncy * ncx, device=score.device)
    cy, cx = cell_ids // ncx, cell_ids % ncx
    rr = cy[:, None] * cs + idx // cs
    cc = cx[:, None] * cs + idx % cs
    cand_r = rr.reshape(B, -1)
    cand_c = cc.reshape(B, -1)
    cand_v = vals.reshape(B, -1)
    k = min(budget, cand_v.shape[1])
    top_v, top_i = _topk_stable(cand_v, k, dim=1)
    rc = torch.stack([torch.gather(cand_r, 1, top_i),
                      torch.gather(cand_c, 1, top_i)], dim=-1).to(torch.int32)
    valid = top_v >= params.min_thresh
    if k < budget:  # tiny levels: pad to static budget
        pad = budget - k
        dev = score.device
        rc = torch.cat([rc, torch.zeros((B, pad, 2), dtype=torch.int32,
                                        device=dev)], dim=1)
        top_v = torch.cat([top_v, torch.zeros((B, pad), dtype=top_v.dtype,
                                              device=dev)], dim=1)
        valid = torch.cat([valid, torch.zeros((B, pad), dtype=torch.bool,
                                              device=dev)], dim=1)
    lead = score.shape[:-2]
    return (rc.reshape(*lead, budget, 2), top_v.reshape(*lead, budget),
            valid.reshape(*lead, budget))


detect_level_torch.cuda_calls = 0


class LevelKeypoints(NamedTuple):
    """Every budgeted level's selected keypoints, concatenated in level
    order (N = the budgets' sum; leading batch dimensions as the
    scores')."""

    rc: torch.Tensor  # (..., N, 2) int32 (row, col) on the keypoint's level
    response: torch.Tensor  # (..., N) FAST score
    valid: torch.Tensor  # (..., N) bool
    uv: torch.Tensor  # (..., N, 2) float32 level-0 pixel (x, y)
    level: torch.Tensor  # (..., N) int32


def detect_levels_torch(scores, budgets, params: OrbParams) -> LevelKeypoints:
    """Plain twin of K3 over an extraction: ``detect_level_torch`` on each
    level with a positive budget (``scores[lv]``, (H_lv, W_lv) or
    (B, H_lv, W_lv)), the level-0 pixels float32(c) * float32(scale ** lv)
    and the level indices, concatenated in level order."""
    if any(s is not None and s.is_cuda for s in scores):
        detect_levels_torch.cuda_calls += 1
    out = {k: [] for k in LevelKeypoints._fields}
    for lv, (score, budget) in enumerate(zip(scores, budgets)):
        if budget <= 0:
            continue
        rc, resp, valid = detect_level_torch(score, budget, params)
        out["rc"].append(rc)
        out["response"].append(resp)
        out["valid"].append(valid)
        out["uv"].append(torch.stack([rc[..., 1].to(torch.float32),
                                      rc[..., 0].to(torch.float32)],
                                     dim=-1) * (params.scale**lv))
        out["level"].append(torch.full(resp.shape, lv, dtype=torch.int32,
                                       device=resp.device))
    dim = out["response"][0].dim() - 1
    return LevelKeypoints(**{k: torch.cat(v, dim=dim)
                             for k, v in out.items()})


detect_levels_torch.cuda_calls = 0


def detect_levels(scores, budgets, params: OrbParams) -> LevelKeypoints:
    """Keypoint selection on every level with a positive budget of one
    extraction (``scores[lv]``: (H_lv, W_lv) or (B, H_lv, W_lv) float32
    FAST scores; levels without a budget may be None), in
    ``lax.top_k``'s order, into the concatenated arrays of
    ``LevelKeypoints``: kernel K3 (one launch; the levels' descriptors a
    by-value kernel parameter) on CUDA tensors, the plain twin on CPU
    tensors."""
    live = [(lv, s, b) for lv, (s, b) in enumerate(zip(scores, budgets))
            if b > 0]
    if live[0][1].device.type == "cpu":
        return detect_levels_torch(scores, budgets, params)
    lead = live[0][1].shape[:-2]
    cuda.require_cuda("detect_levels", *(s for _, s, _ in live))
    if any(s.dtype != torch.float32 or s.dim() not in (2, 3)
           or s.shape[:-2] != lead for _, s, _ in live):
        raise ValueError("detect_levels: expected float32 (H, W) or "
                         "(B, H, W) scores of one batch")
    B = int(np.prod(lead, dtype=np.int64))
    n_out = sum(b for _, _, b in live)
    dev = live[0][1].device
    rc = torch.empty((*lead, n_out, 2), dtype=torch.int32, device=dev)
    resp = torch.empty((*lead, n_out), dtype=torch.float32, device=dev)
    valid = torch.empty((*lead, n_out), dtype=torch.bool, device=dev)
    uv = torch.empty((*lead, n_out, 2), dtype=torch.float32, device=dev)
    level = torch.empty((*lead, n_out), dtype=torch.int32, device=dev)
    _detect_launch(live, B, n_out, params, rc, resp, valid, uv, level)
    return LevelKeypoints(rc, resp, valid, uv, level)


detect_levels.launches = 0


# K3's candidates a level at most, two a cell (their keys and pixels fill
# a CTA's 227 KB of shared memory; 3840x2160 at 32-pixel cells has 16320)
K3_MAX_CANDIDATES = 232448 // 12


def _detect_launch(live, B, n_out, params, rc, resp, valid, uv, level):
    """One launch of K3 over ``live`` [(level, scores, budget)]."""
    cs = params.cell_size
    dims, off = [], 0
    for lv, s, b in live:
        h, w = s.shape[-2:]
        if 2 * (-(-h // cs)) * (-(-w // cs)) > K3_MAX_CANDIDATES:
            raise ValueError(f"detect_levels: more than {K3_MAX_CANDIDATES} "
                             "candidates on a level")
        dims += [h, w, b, off, lv]
        off += b
    cuda.call("vsg_detect_levels", cuda.ptr_array([s for _, s, _ in live]),
              (ctypes.c_int * len(dims))(*dims),
              (ctypes.c_float * len(live))(
                  *(params.scale**lv for lv, _, _ in live)),
              len(live), B, n_out, cs, float(params.min_thresh),
              cuda.ptr(rc), cuda.ptr(resp), cuda.ptr(valid), cuda.ptr(uv),
              cuda.ptr(level), cuda.stream())
    detect_levels.launches += 1


def detect_level(score: torch.Tensor, budget: int, params: OrbParams):
    """Keypoint selection on one level (``lax.top_k``'s order: value
    descending, lower index first) of an (H, W) score image or a
    (B, H, W) batch: kernel K3 with one level's descriptor on CUDA
    tensors, the plain twin on CPU tensors.  Returns (rc (..., budget, 2)
    int32, resp (..., budget), valid (..., budget) bool)."""
    if score.device.type == "cpu":
        return detect_level_torch(score, budget, params)
    cuda.require_cuda("detect_level", score)
    if score.dtype != torch.float32 or score.dim() not in (2, 3):
        raise ValueError("detect_level: expected 2D or 3D float32 scores")
    lead = score.shape[:-2]
    dev = score.device
    rc = torch.empty((*lead, budget, 2), dtype=torch.int32, device=dev)
    resp = torch.empty((*lead, budget), dtype=torch.float32, device=dev)
    valid = torch.empty((*lead, budget), dtype=torch.bool, device=dev)
    if budget > 0:
        _detect_launch([(0, score, budget)], score.numel() // (
            score.shape[-2] * score.shape[-1]), budget, params, rc, resp,
            valid, None, None)
    return rc, resp, valid


def _patch_index(img: torch.Tensor, rc: torch.Tensor):
    """Row/col index grids (K, 41, 41) of each keypoint's patch: origin
    clipped into the image, reads past a too-small level clamped to its
    last row/column (the reference's edge pad)."""
    size = 2 * GATHER_RADIUS + 1
    h, w = img.shape
    hp, wp = max(h, size), max(w, size)
    r0 = torch.clamp(rc[:, 0].long() - GATHER_RADIUS, 0, hp - size)
    c0 = torch.clamp(rc[:, 1].long() - GATHER_RADIUS, 0, wp - size)
    ar = torch.arange(size, device=img.device)
    rows = torch.clamp(r0[:, None] + ar[None, :], max=h - 1)  # (K, 41)
    cols = torch.clamp(c0[:, None] + ar[None, :], max=w - 1)
    return rows, cols


def _gather_patches(img: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    rows, cols = _patch_index(img, rc)
    return img[rows[:, :, None], cols[:, None, :]]  # (K, 41, 41)


@functools.lru_cache(maxsize=None)
def _ic_terms(axis: int) -> tuple[tuple[int, int], ...]:
    """Row-major (row, col) positions of the r=15 disc whose moment weight
    along ``axis`` (0: x, 1: y) is non-zero."""
    mask = _circular_mask(PATCH_RADIUS)
    r = PATCH_RADIUS
    return tuple((i, j) for i in range(2 * r + 1) for j in range(2 * r + 1)
                 if mask[i, j] and (j - r if axis == 0 else i - r) != 0)


def _ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle over the r=15 disc.  The moments are
    summed term by term in row-major float32 order — the order of XLA's
    CPU reduction in the reference and of the K4 kernel — so the angle
    reproduces exactly; zero-weight terms add +0 and are skipped."""
    d = GATHER_RADIUS - PATCH_RADIUS
    sz = 2 * PATCH_RADIUS + 1
    central = patches[:, d:d + sz, d:d + sz]
    xs, ys = _ic_weights(patches.device)
    moments = []
    for axis, wgt in ((0, xs), (1, ys)):
        prod = central * wgt
        m = torch.zeros(patches.shape[0], dtype=patches.dtype,
                        device=patches.device)
        for i, j in _ic_terms(axis):
            m = m + prod[:, i, j]
        moments.append(m)
    return torch.atan2(moments[1], moments[0])


def _steered_brief(patches: torch.Tensor, angles: torch.Tensor,
                   pattern: torch.Tensor) -> torch.Tensor:
    ca, sa = torch.cos(angles), torch.sin(angles)
    px1, py1, px2, py2 = pattern.unbind(1)

    def rot_rc(px, py):
        x = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        y = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        r = torch.clamp(torch.round(y) + GATHER_RADIUS, 0, 2 * GATHER_RADIUS)
        c = torch.clamp(torch.round(x) + GATHER_RADIUS, 0, 2 * GATHER_RADIUS)
        return r.long(), c.long()

    r1, c1 = rot_rc(px1, py1)
    r2, c2 = rot_rc(px2, py2)
    flat = patches.reshape(patches.shape[0], -1)
    wdt = 2 * GATHER_RADIUS + 1
    v1 = torch.gather(flat, 1, r1 * wdt + c1)
    v2 = torch.gather(flat, 1, r2 * wdt + c2)
    bits = (v1 < v2).to(torch.uint8).reshape(-1, 32, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=patches.device)
    return torch.sum(bits << shifts, dim=-1, dtype=torch.uint8)


def orb_describe_torch(blurred: torch.Tensor, rc: torch.Tensor,
                       pattern: torch.Tensor, angle: torch.Tensor | None = None):
    """Plain PyTorch twin of K4: (angle (K,), desc (K, 32) uint8) of the
    keypoints ``rc`` (K, 2) int32 (row, col) on one blurred level, or
    (B, K) / (B, K, 32) for a (B, H, W) batch with ``rc`` (B, K, 2).
    Given ``angle``, the IC angle is not recomputed."""
    if blurred.is_cuda:
        orb_describe_torch.cuda_calls += 1
    if blurred.dim() == 3:
        outs = [_describe(blurred[b], rc[b], pattern,
                          None if angle is None else angle[b])
                for b in range(blurred.shape[0])]
        return (torch.stack([a for a, _ in outs]),
                torch.stack([d for _, d in outs]))
    return _describe(blurred, rc, pattern, angle)


def _describe(blurred, rc, pattern, angle):
    patches = _gather_patches(blurred, rc)
    if angle is None:
        angle = _ic_angle(patches)
    return angle, _steered_brief(patches, angle, pattern)


orb_describe_torch.cuda_calls = 0


def orb_describe_levels_torch(blurred, rc: torch.Tensor, budgets,
                              pattern: torch.Tensor,
                              angle: torch.Tensor | None = None):
    """Plain twin of K4 over an extraction: ``orb_describe_torch`` on each
    budgeted level's rows of the concatenated keypoints ``rc`` (..., N, 2)
    (N the budgets' sum, in level order), with ``blurred[lv]`` its blurred
    level; returns (angle (..., N), desc (..., N, 32))."""
    if rc.is_cuda:
        orb_describe_levels_torch.cuda_calls += 1
    angles, descs, off = [], [], 0
    for bl, b in zip(blurred, budgets):
        if b <= 0:
            continue
        rows = slice(off, off + b)
        a, d = orb_describe_torch(bl, rc[..., rows, :], pattern,
                                  None if angle is None else angle[..., rows])
        angles.append(a)
        descs.append(d)
        off += b
    return torch.cat(angles, dim=-1), torch.cat(descs, dim=-2)


orb_describe_levels_torch.cuda_calls = 0

# levels a K4 launch takes (the kernel's descriptor table)
K4_MAX_LEVELS = 8


def orb_describe_levels(blurred, rc: torch.Tensor, budgets,
                        pattern: torch.Tensor,
                        angle: torch.Tensor | None = None,
                        out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """IC angle + steered BRIEF of every keypoint of an extraction: ``rc``
    (N, 2) or (B, N, 2) int32, the budgeted levels' keypoints concatenated
    in level order (N the budgets' sum, as ``detect_levels`` writes them),
    ``blurred[lv]`` the (H_lv, W_lv) or (B, H_lv, W_lv) blurred level (None
    for a level without a budget).  Kernel K4, one launch for every level
    and frame, on CUDA tensors, the plain twin on CPU tensors.  Writes the
    extraction's (..., N) angles and (..., N, 32) descriptors (into ``out``
    when given) and returns them; given ``angle``, the IC angle is not
    recomputed."""
    if rc.device.type == "cpu":
        a, d = orb_describe_levels_torch(blurred, rc, budgets, pattern, angle)
        if out is None:
            return a, d
        out[0].copy_(a)
        out[1].copy_(d)
        return out
    lead, n = rc.shape[:-2], rc.shape[-2]
    if out is None:
        out = (torch.empty((*lead, n), dtype=torch.float32,
                           device=rc.device),
               torch.empty((*lead, n, 32), dtype=torch.uint8,
                           device=rc.device))
    live = [(bl, b) for bl, b in zip(blurred, budgets) if b > 0]
    levels = [bl for bl, _ in live]
    cuda.require_cuda("orb_describe_levels", rc, pattern, *out, *levels,
                      *(() if angle is None else (angle,)))
    if (rc.dtype != torch.int32 or rc.dim() not in (2, 3)
            or rc.shape[-1] != 2 or n != sum(b for _, b in live)
            or len(live) > K4_MAX_LEVELS
            or any(bl.dtype != torch.float32 or bl.shape[:-2] != lead
                   or bl.dim() != rc.dim() for bl in levels)
            or out[0].dtype != torch.float32 or out[0].shape != (*lead, n)
            or out[1].dtype != torch.uint8 or out[1].shape != (*lead, n, 32)
            or (angle is not None and (angle.dtype != torch.float32
                                       or angle.shape != (*lead, n)))):
        raise ValueError("orb_describe_levels: bad dtype or shape")
    _desc_launch(levels, desc_plan([bl.shape[-2:] for bl in levels],
                                   [b for _, b in live]),
                 rc, n, n, pattern, angle, *out)
    return out


orb_describe_levels.launches = 0


def desc_plan(shapes, budgets) -> list[int]:
    """K4's level table over the budgeted levels of ``shapes`` [(h, w)]
    and positive ``budgets``: (h, w, first row) per level, its rows of the
    concatenated keypoints running to the next level's first row (a row's
    level is the last whose first row is <= the row)."""
    plan, off = [], 0
    for (h, w), b in zip(shapes, budgets):
        plan += [h, w, off]
        off += b
    return plan


def _desc_launch(levels, plan, rc, n, stride, pattern, angle, angle_out,
                 desc):
    """One launch of K4 over ``levels`` (``plan``: ``desc_plan``'s) for
    rows 0..n-1 of every frame, frames ``stride`` rows apart."""
    if pattern.shape != (256, 4) or pattern.dtype != torch.float32 or (
            pattern.data_ptr() % 16 or desc.data_ptr() % 4):
        raise ValueError("K4: expected a (256, 4) float32 pattern on 16 "
                         "bytes and descriptors on 4")
    B = rc.shape[0] if rc.dim() == 3 else 1
    cuda.call("vsg_orb_desc_levels", cuda.ptr_array(levels),
              (ctypes.c_int * len(plan))(*plan), len(levels), B,
              cuda.ptr(rc), n, stride, cuda.ptr(pattern), cuda.ptr(angle),
              cuda.ptr(angle_out), cuda.ptr(desc), cuda.stream())
    orb_describe_levels.launches += 1


def orb_describe(blurred: torch.Tensor, rc: torch.Tensor,
                 pattern: torch.Tensor, angle: torch.Tensor | None = None,
                 out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """IC angle + steered BRIEF of one level's keypoints, of one frame
    ((H, W) level, (K, 2) rc) or a batch ((B, H, W), (B, K, 2)): K4 with
    one level's descriptor on CUDA tensors, the plain twin on CPU
    tensors.  ``rc`` may be a level's rows of the extraction's keypoints
    (a view whose frames are ``S`` keypoints apart); with ``out`` = (angle
    (..., K), desc (..., K, 32)), views with the same frame stride, the
    results are written there and returned."""
    if blurred.device.type == "cpu":
        a, d = orb_describe_torch(blurred, rc, pattern, angle)
        if out is None:
            return a, d
        out[0].copy_(a)
        out[1].copy_(d)
        return out
    lead = rc.shape[:-1]
    n = rc.shape[-2]
    if out is None:
        out = (torch.empty(lead, dtype=torch.float32, device=blurred.device),
               torch.empty((*lead, 32), dtype=torch.uint8,
                           device=blurred.device))
    angle_out, desc = out
    cuda.require_cuda("orb_describe", blurred, pattern)
    batched = blurred.dim() == 3
    S = rc.stride(0) // 2 if batched else n
    views = [(rc, 2), (angle_out, 1), (desc, 32)] + (
        [(angle, 1)] if angle is not None else [])
    if (blurred.dtype != torch.float32 or rc.dtype != torch.int32
            or angle_out.dtype != torch.float32 or desc.dtype != torch.uint8
            or (angle is not None and angle.dtype != torch.float32)
            or blurred.dim() not in (2, 3) or rc.dim() != blurred.dim()
            or rc.shape[-1] != 2 or angle_out.shape != lead
            or desc.shape != (*lead, 32)
            or (angle is not None and angle.shape != lead)
            or any(t.get_device() != blurred.get_device()
                   # a keypoint's row contiguous, keypoints adjacent, the
                   # frames S keypoints apart
                   or t.stride(-1) != 1 or (w > 1 and t.stride(-2) != w)
                   or (batched and t.stride(0) != S * w)
                   for t, w in views)):
        raise ValueError("orb_describe: bad dtype, shape, device or strides")
    if n > 0:
        _desc_launch([blurred], [*blurred.shape[-2:], 0], rc, n, S, pattern,
                     angle, angle_out, desc)
    return angle_out, desc


def extract_orb(img: torch.Tensor, params: OrbParams = OrbParams()) -> Keypoints:
    """Full ORB extraction on a grayscale image (H, W) float32 [0, 255], or
    on a (B, H, W) batch (every field then gains a leading B; each frame's
    result equals its extraction alone): K1's resize chain, K2 over every
    budgeted level, K3 over every level into the concatenated keypoints,
    K1's blur over every budgeted level, then K4 over every level's
    keypoints into the extraction's angles and descriptors; every launch
    for the whole batch, each of K1's chain, K2, K3, K1's blur and K4
    once an extraction."""
    pattern = brief_pattern_tensor(params.pattern_seed, img.device)
    levels = build_pyramid(img, params.n_levels, params.scale)
    budgets = level_budgets(params)
    live = [lv if b > 0 else None for lv, b in zip(levels, budgets)]
    kp = detect_levels(fast_levels(live), budgets, params)
    blurred = gaussian_blur_levels(live)
    angle, desc = orb_describe_levels(blurred, kp.rc, budgets, pattern)
    return Keypoints(uv=kp.uv, response=kp.response, level=kp.level,
                     angle=angle, valid=kp.valid, desc=desc)
