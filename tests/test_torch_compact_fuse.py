"""Port parity of K7's two entries and of ``fuse_observations`` on the
tracking pass, on seeded small maps.

- ``compact_observed_torch`` (the plain twin of K7's observed entry)
  against the reference's ``observed_mask(...) & pt_valid`` compacted by
  ``jnp.nonzero(..., size=, fill_value=-1)``, exactly: duplicate keyframe
  ids, masked keyframes, invalid keypoints, -1 observations, ``size`` below
  and above the count, int64 and int32 ids;
- K7's launch plan (``map_state.compact_plan``: the words a thread of the
  one CTA owns, the shared bytes of the bitmap and the staged ids, the
  cap) and a numpy
  model of the kernel's arithmetic (``csrc/compact.cu``: the byte-to-bit
  packing, the bitmap with dropped out-of-range ids, the block scan and
  the truncated writes) against the twin and the reference;
- ``fuse_observations`` (its match now one tracking pass, the twin
  ``track_pass_torch`` here) against the reference's, with ``kf_obs_pt``
  exactly equal, on a map whose keyframe has free keypoints near the
  projections of its covisible keyframes' points (ties and duplicate
  claimants included).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu import config as rcfg
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.slam import map_state as rms
from visual_sgraphs_tpu.slam import mapping as rmap
from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.slam import map_state as pms
from visual_sgraphs_tpu_torch.slam import mapping as pmap

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

K, F, N, L = 16, 64, 1024, 5


def _maps(fields: dict, n_features: int = F):
    """(reference map, port map) of capacity (K, n_features, N) with
    ``fields`` (numpy) written over the empty map."""
    ref = rms.empty_map(rcfg.CapacityConfig(K, N),
                        rcfg.OrbConfig(n_features=n_features))
    ref = ref._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    return ref, tp.port_map(ref)


@pytest.fixture(scope="module")
def obs_maps():
    """A seeded observation table: 40 % of the entries -1, the rest ids
    below N; 10 % of the keypoints and 15 % of the points invalid."""
    rng = np.random.default_rng(0)
    obs = rng.integers(0, N, (K, F)).astype(np.int32)
    obs[rng.uniform(size=(K, F)) < 0.4] = -1
    return _maps(dict(kf_obs_pt=obs,
                      kf_kp_valid=rng.uniform(size=(K, F)) > 0.1,
                      pt_valid=rng.uniform(size=N) > 0.15))


# (keyframe ids, mask): a repeated id and a masked keyframe; distinct ids,
# all kept; every keyframe masked
KF_CASES = {
    "dup_masked": ([3, 7, 3, 11, 0], [True, True, True, False, True]),
    "distinct": ([1, 2, 5, 9, 15], [True] * 5),
    "all_masked": ([4, 4, 6, 8, 10], [False] * 5),
}
SIZES = (64, 512)  # below and above the observed counts (87, 135)


@functools.partial(jax.jit, static_argnames="size")
def _ref_compact(m, kf_ids, kf_mask, size):
    mask = rms.observed_mask(m, kf_ids, kf_mask) & m.pt_valid
    return jnp.nonzero(mask, size=size, fill_value=-1)[0]


@pytest.fixture(scope="module")
def ref_compacted(obs_maps):
    ref = obs_maps[0]
    out = {}
    for name, (ids, mask) in KF_CASES.items():
        for size in SIZES:
            out[name, size] = np.asarray(_ref_compact(
                ref, jnp.asarray(ids, jnp.int32), jnp.asarray(mask), size))
    return out


@pytest.mark.parametrize("dtype", ["int64", "int32"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(KF_CASES))
def test_compact_observed_twin_matches_reference(obs_maps, ref_compacted,
                                                 case, size, dtype):
    ids, mask = KF_CASES[case]
    dt = getattr(torch, dtype)
    got = pms.compact_observed(obs_maps[1], torch.tensor(ids),
                               torch.tensor(mask), size, dt)
    want = ref_compacted[case, size]
    assert got.dtype == dt and got.shape == (size,)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "dup_masked":
        # the size below the count truncates, the one above pads
        assert (want >= 0).all() if size == SIZES[0] else (want < 0).any()
    if case == "all_masked":
        assert (want == -1).all()
    # the plain composition the main path no longer runs, equal too
    plain = pms.compact_true(pms.observed_mask(
        obs_maps[1], torch.tensor(ids), torch.tensor(mask))
        & obs_maps[1].pt_valid, size)
    np.testing.assert_array_equal(plain.numpy(), want)


# ---------------------------------------------------------------------------
# K7's launch plan and a numpy model of the kernel's arithmetic
# ---------------------------------------------------------------------------

# the most entries whose bitmap fits one CTA beside 4096 staged ids
CAP = 8 * cuda.SMEM_LIMIT - 32 * 4096


@pytest.mark.parametrize("n,size", [(0, 8), (1, 1), (31, 4096), (32, 4096),
                                    (1000, 1000), (4096, 4096),
                                    (32768, 4096), (32768, 8192),
                                    (32769, 4096), (100_000, 8192),
                                    (CAP, 4096)])
def test_compact_plan_covers_every_word_once(n, size):
    plan = pms.compact_plan(n, size)
    assert plan.words == -(-n // 32) and plan.smem_true == 4 * size
    assert plan.smem_observed == 4 * (plan.words + size)
    assert plan.smem_observed <= cuda.SMEM_LIMIT
    assert plan.wpt in pms.COMPACT_WPT
    covered = np.zeros(plan.words, int)
    for t in range(pms.COMPACT_THREADS):
        lo = t * plan.wpt
        covered[lo:min(lo + plan.wpt, plan.words)] += 1
    assert (covered == 1).all()
    # the least of the kernel's instantiations that covers the words
    smaller = [w for w in pms.COMPACT_WPT if w < plan.wpt]
    assert all(w * pms.COMPACT_THREADS < plan.words for w in smaller)


def test_compact_plan_cap_raises():
    pms.compact_plan(CAP, 4096)
    with pytest.raises(ValueError, match="shared memory"):
        pms.compact_plan(CAP + 1, 4096)
    with pytest.raises(ValueError, match="shared memory"):
        pms.compact_plan(32768, cuda.SMEM_LIMIT // 4)


def _pack4(x: np.ndarray) -> np.ndarray:
    """The kernel's ``pack4``: 4 bool bytes (any nonzero is True) of a
    little-endian uint32 -> 4 bits (``__vcmpne4``, then the multiply)."""
    x = x.astype(np.uint32)
    ne = np.zeros_like(x)
    for b in range(4):
        ne |= np.where((x >> (8 * b)) & 0xFF, np.uint32(0xFF << (8 * b)), 0
                       ).astype(np.uint32)
    return (((ne & np.uint32(0x01010101)) * np.uint32(0x01020408))
            >> np.uint32(24)).astype(np.uint32)


def test_pack4_gathers_each_byte_to_its_bit():
    bytes_ = np.array(np.meshgrid(*[[0, 1, 2, 255]] * 4)).reshape(4, -1).T
    words = (bytes_.astype(np.uint32) << (8 * np.arange(4, dtype=np.uint32))
             ).sum(1).astype(np.uint32)
    want = ((bytes_ != 0) << np.arange(4)).sum(1)
    np.testing.assert_array_equal(_pack4(words), want)


def _model_words(mask: np.ndarray) -> np.ndarray:
    """The 32-entry words of a bool mask as the kernel packs them: 4
    bytes at a time through ``pack4``."""
    n = mask.shape[0]
    padded = np.zeros(-(-n // 32) * 32, np.uint8)
    padded[:n] = mask
    quads = padded.view("<u4").reshape(-1, 8)
    nib = _pack4(quads)
    return (nib << (4 * np.arange(8, dtype=np.uint32))).sum(
        1, dtype=np.uint64).astype(np.uint32)


def _model_scan_write(words: np.ndarray, n: int, size: int) -> np.ndarray:
    """The kernel's block: thread t owns words [t wpt, (t + 1) wpt), counts
    their bits, takes its exclusive scan as its first position and stages
    its set bits' indices below ``size``; the block writes the staged
    slots below min(total, size) and -1 past them."""
    plan = pms.compact_plan(n, size)
    out = np.full(size, -7, np.int64)  # unwritten slots stay -7
    counts = []
    for t in range(pms.COMPACT_THREADS):
        own = words[t * plan.wpt:(t + 1) * plan.wpt]
        counts.append(sum(bin(int(w)).count("1") for w in own))
    start = np.concatenate([[0], np.cumsum(counts)])
    for t in range(pms.COMPACT_THREADS):
        pos = int(start[t])
        for k in range(plan.wpt):
            w = t * plan.wpt + k
            if w >= words.shape[0]:
                break
            for b in range(32):
                if (int(words[w]) >> b) & 1 and pos < size:
                    out[pos] = 32 * w + b
                    pos += 1
    out[min(int(start[-1]), size):] = -1
    return out


@pytest.mark.parametrize("n,p,size", [(1000, 0.9, 1000), (4096, 0.08, 512),
                                      (1000, 0.3, 64), (33, 0.5, 40),
                                      (40000, 0.2, 9000), (0, 0.5, 8)])
def test_kernel_model_matches_twin(n, p, size):
    mask = np.random.default_rng(n).uniform(size=n) < p
    got = _model_scan_write(_model_words(mask), n, size)
    want = pms.compact_true_torch(torch.from_numpy(mask), size).numpy()
    np.testing.assert_array_equal(got, want)


def _model_observed(obs, kp_valid, kf_ids, kf_mask, pt_valid) -> np.ndarray:
    """The observed entry's bitmap: every id of an unmasked row whose
    keypoint is valid sets its bit when it lies in [0, N) (ids past N are
    dropped, as the reference's scatter drops them), ANDed with pt_valid's
    words."""
    n = pt_valid.shape[0]
    bits = np.zeros(-(-n // 32), np.uint32)
    for kf, keep in zip(kf_ids, kf_mask):
        if not keep:
            continue
        for i, ok in zip(obs[kf], kp_valid[kf]):
            if ok and 0 <= i < n:
                bits[i >> 5] |= np.uint32(1 << (i & 31))
    return bits & _model_words(pt_valid)


@pytest.mark.parametrize("case", list(KF_CASES))
def test_observed_model_matches_reference(obs_maps, ref_compacted, case):
    ids, mask = KF_CASES[case]
    p = obs_maps[1]
    words = _model_observed(p.kf_obs_pt.numpy(), p.kf_kp_valid.numpy(), ids,
                            mask, p.pt_valid.numpy())
    for size in SIZES:
        np.testing.assert_array_equal(_model_scan_write(words, N, size),
                                      ref_compacted[case, size])


def test_observed_model_drops_ids_past_n_as_the_reference():
    # an observation id of N (past the table) is dropped by the reference's
    # scatter and by the kernel's range test
    rng = np.random.default_rng(3)
    obs = rng.integers(-1, N, (K, F)).astype(np.int32)
    obs[2, :5] = N
    ref, port = _maps(dict(kf_obs_pt=obs, kf_kp_valid=np.ones((K, F), bool),
                           pt_valid=np.ones(N, bool)))
    ids, mask = [2, 4, 2, 6, 9], [True, True, True, True, False]
    want = np.asarray(_ref_compact(ref, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(mask), SIZES[1]))
    words = _model_observed(obs, np.ones((K, F), bool), ids, mask,
                            np.ones(N, bool))
    np.testing.assert_array_equal(_model_scan_write(words, N, SIZES[1]), want)


# ---------------------------------------------------------------------------
# fuse_observations on the tracking pass
# ---------------------------------------------------------------------------

CAM = np.array([200.0, 200.0, 160.0, 120.0], np.float32)  # 320 x 240
KF = 2  # the fusing keyframe
F_FUSE = 160  # keypoints a keyframe


def _fuse_fields(seed: int = 0) -> dict:
    """Six keyframes near the identity pose, 400 points in front of them.
    Keyframe KF observes points 0-59 (keypoints 0-59); its keypoints 60-119
    are free, 40 of them near (within 3 px) the projections of points
    60-99 that keyframes 1 and 3-5 observe, with a few descriptor bits
    flipped, the rest random; keypoint 120 repeats keypoint 60 half a
    pixel off (a tie) and points 100-101 copy point 61's position and
    descriptor (duplicate claimants of keypoint 61); points 102-104 lie
    behind the camera."""
    rng = np.random.default_rng(seed)
    n_kf, n_pt = 6, 400
    q = np.concatenate([np.ones((n_kf, 1)), rng.normal(size=(n_kf, 3))
                        * 0.01], 1)
    pose = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                           rng.normal(size=(n_kf, 3)) * 0.05], 1)
    kf_pose = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (K, 1))
    kf_pose[:n_kf] = pose
    z = rng.uniform(2.0, 6.0, n_pt)
    pc = np.stack([rng.uniform(-140, 140, n_pt) * z / 200,
                   rng.uniform(-100, 100, n_pt) * z / 200, z], 1)
    pt_pos = np.zeros((N, 3), np.float32)
    pt_pos[:n_pt] = pc
    pt_desc = np.zeros((N, 32), np.uint8)
    pt_desc[:n_pt] = rng.integers(0, 256, (n_pt, 32))
    pt_pos[100:102] = pt_pos[61]
    pt_desc[100:102] = pt_desc[61]
    pt_pos[102:105, 2] = -1.0
    pt_valid = np.zeros(N, bool)
    pt_valid[:n_pt] = True

    kf_obs_pt = np.full((K, F_FUSE), -1, np.int32)
    kf_kp_valid = np.zeros((K, F_FUSE), bool)
    kf_uv = rng.uniform((0, 0), (320, 240), (K, F_FUSE, 2)).astype(
        np.float32)
    kf_desc = rng.integers(0, 256, (K, F_FUSE, 32)).astype(np.uint8)
    kf_valid = np.zeros(K, bool)
    kf_valid[:n_kf] = True
    for j in range(n_kf):
        if j == KF:
            continue
        # the shared points 0-59, the fusion targets 60-105 and a few
        # others each
        seen = np.concatenate([np.arange(0, 106), rng.choice(
            np.arange(106, n_pt), 20, replace=False)])
        kf_obs_pt[j, :seen.size] = seen
        kf_kp_valid[j, :seen.size] = True
    kf_obs_pt[KF, :60] = np.arange(60)
    kf_kp_valid[KF, :121] = True
    # keypoints 60-99 near the projections of points 60-99
    p_cam = np.asarray(rlie.se3_apply(jnp.asarray(pose[KF], jnp.float64),
                                      jnp.asarray(pc[60:100], jnp.float64)))
    uv = p_cam[:, :2] / p_cam[:, 2:] * CAM[:2] + CAM[2:]
    kf_uv[KF, 60:100] = uv + rng.uniform(-3, 3, (40, 2))
    flips = (rng.uniform(size=(40, 32)) < 0.08) * rng.integers(1, 256,
                                                               (40, 32))
    kf_desc[KF, 60:100] = pt_desc[60:100] ^ flips.astype(np.uint8)
    kf_desc[KF, 120], kf_uv[KF, 120] = kf_desc[KF, 60], kf_uv[KF, 60] + 0.5
    return dict(kf_pose=kf_pose, kf_valid=kf_valid, kf_uv=kf_uv,
                kf_desc=kf_desc, kf_kp_valid=kf_kp_valid,
                kf_obs_pt=kf_obs_pt, pt_pos=pt_pos, pt_desc=pt_desc,
                pt_valid=pt_valid)


@pytest.fixture(scope="module")
def fuse_case():
    ref, port = _maps(_fuse_fields(), F_FUSE)
    out = rmap.fuse_observations(ref, jnp.asarray(KF, jnp.int32),
                                 jnp.asarray(CAM))
    return ref, port, np.asarray(out.kf_obs_pt)


def test_fuse_observations_matches_reference(fuse_case):
    ref, port, want = fuse_case
    got = pmap.fuse_observations(port, KF, torch.from_numpy(CAM))
    np.testing.assert_array_equal(got.kf_obs_pt.numpy(), want)
    # the keyframe gained links (not a vacuous match), and only its row
    # changed
    before = np.asarray(ref.kf_obs_pt)
    gained = int(((before[KF] < 0) & (want[KF] >= 0)).sum())
    assert gained >= 30
    np.testing.assert_array_equal(np.delete(want, KF, 0),
                                  np.delete(before, KF, 0))


def test_fuse_candidates_are_the_reference_ids(fuse_case):
    # fuse_candidates' ids are the reference's compacted points of the
    # top-8 covisible keyframes, cast to int32; its keypoints are valid
    # where still unassociated
    ref, port, _ = fuse_case
    counts = rms.covisibility_counts(ref, jnp.asarray(KF, jnp.int32))
    _, top = jax.lax.top_k(counts, 8)
    want = np.asarray(_ref_compact(ref, top, counts[top] > 0, 4096))
    ids, kp = pmap.fuse_candidates(port, KF)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(
        kp.valid.numpy(), np.asarray(ref.kf_kp_valid[KF]
                                     & (ref.kf_obs_pt[KF] < 0)))
