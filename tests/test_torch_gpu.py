"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test skips (inside the fixture, never at import) when
``torch.cuda.is_available()`` is false, as on the CPU-only test machine.
``python3 chip_smoke.py`` runs the same comparisons on the card.
"""

import numpy as np
import pytest
import torch

from visual_sgraphs_tpu_torch import cuda, selfcheck
from visual_sgraphs_tpu_torch.parallel import dist_ba


# kernels that only the loop path (loop_closing=True) launches
LOOP_ONLY = ("bow_vectors", "place_query", "match_nn_ratio", "guided_count",
             "verify_sim3", "pnp_hypotheses", "pgo_assemble", "pgo_cost")
# the LM engine's kernel route (K22a / K22b / K22c): the inertial path's
# local BAs and initialisation (elsewhere only a recovery keyframe's local
# BA or a loop weld)
LM_KERNELS = ("lm_reproj_plan", "lm_reproj_reduce", "lm_reproj_cost",
              "lm_inertial_plan", "lm_inertial_assemble", "lm_inertial_cost",
              "lm_solve")
# K22b's entries on the initialisation problem and on it tiled to 100
# edges and to 1500 (the rows launch reads its edge index from global
# memory there, from shared memory below ~1400 edges)
K22B_TAGGED = tuple(f"{k}@{tag}" for tag in ("init", "init_x100",
                                              "init_x1500")
                    for k in ("lm_inertial_plan", "lm_inertial_assemble",
                              "lm_inertial_cost"))
# kernels that only the inertial path (Sensor.IMU_RGBD) launches
INERTIAL_ONLY = ("pose_gn_prior", "preint", "vi_pose") + LM_KERNELS
# kernels that only the free-space room method launches
FREESPACE_ONLY = ("freespace_carve", "freespace_components",
                  "rooms_freespace")
# kernels no main path launches (K5's standalone window matcher: since
# fuse_observations runs on the tracking pass, only its checks call it;
# K7's plain entry: since the keyframe insertion's free ids are K27's,
# likewise)
CHECK_ONLY = ("match_window", "compact_true")
# K25's scan entries: only the B-frame pipeline's scan launches them
PIPELINE_ONLY = ("scan_prologue", "scan_epilogue")
# K27's stats entry folds a cycle's batch or a frame the serial step
# tracks (the inertial path, a frame after a loss); the serial visual path
# folds its frames' stats inside K27's insertion instead
FOLD_ONLY = ("found_stats",)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    cuda.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def front_k2_k4(device):
    return {r["name"]: r for r in selfcheck.check_front_k2_k4(device)}


FRONT_CASES = ("", "@B1", "@240x320", "@720x1280", "@tiny")


@pytest.mark.gpu
@pytest.mark.parametrize("case", FRONT_CASES)
def test_fast_nms_kernel(front_k2_k4, case):
    # K2 over every level of an extraction in one launch (one device
    # operation), bitwise equal to the twin and from launch to launch, on
    # a batch of 8 480x640 frames, one frame, 240x320, 720x1280 and levels
    # smaller than FAST's ring; fast_nms (one level) equal on each level
    r = front_k2_k4["fast_nms" + case]
    assert r["ok"] and r["device_ops"] == 1, r


@pytest.mark.gpu
@pytest.mark.parametrize("case", FRONT_CASES)
def test_orb_desc_kernel(front_k2_k4, case):
    # K4 over every keypoint of an extraction in one launch: angles within
    # 1e-5 rad of the twin, descriptors bitwise given the twin's angles,
    # bitwise from launch to launch, on the same cases (the tiny levels
    # are smaller than the 41x41 patch); orb_describe (one level's rows)
    # likewise
    r = front_k2_k4["orb_desc" + case]
    assert r["ok"] and r["device_ops"] == 1, r


@pytest.mark.gpu
def test_match_window_kernel(device):
    r = selfcheck.check_match_window(device)
    assert r["ok"] and r["n_matched"] > 500, r


@pytest.fixture(scope="module")
def track_pass_args(device):
    return selfcheck.track_pass_inputs(device)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", selfcheck.TRACK_RADII
                         + (selfcheck.FUSE_RADIUS,))
def test_track_pass_kernel(device, track_pass_args, radius):
    # the tracking pass (K5's redesign) at the main path's four tracking
    # radii and at fuse_observations' (no image gate, no depths): every
    # integer and bool output equal to the twin's, the predicted and
    # gathered pixels and depths bitwise
    fuse = radius == selfcheck.FUSE_RADIUS
    args = track_pass_args
    if fuse:
        args = args[:5] + (None,) + args[6:]
    r = selfcheck.check_track_pass(device, args, radius,
                                   want_depth=not fuse)
    assert r["ok"] and r["n_matched"] > 100, r


@pytest.mark.gpu
def test_track_pass_bitwise_reproducible(device, track_pass_args):
    # the claims resolve by atomicMin on integers, the best two by
    # (distance, index): launch order does not reach the outputs
    from visual_sgraphs_tpu_torch.features import match

    args = track_pass_args
    first = match.track_pass(*args[:6], 60.0, args[6], full=True)
    for _ in range(4):
        again = match.track_pass(*args[:6], 60.0, args[6], full=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_vi_pose_sections(device):
    # K20's clock stamps: every section non-negative, the iterations'
    # sections within the whole launch
    r = selfcheck.vi_pose_sections(device)
    assert all(v >= 0 for v in r["per_iteration_cycles"].values()), r
    assert 0 < 6 * r["iteration_cycles"] <= r["total_cycles"], r


@pytest.mark.gpu
def test_pose_gn_kernel(device):
    r = selfcheck.check_pose_gn(device)
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("prior", [False, True], ids=["plain", "prior"])
@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("M", selfcheck.POSE_GN_SIZES)
def test_pose_gn_cases(device, M, stereo, prior):
    # K6 (one CTA up to 512 matches, a cluster above) within POSE_TOL of
    # the twin, inlier flags on >= INLIER_AGREE of rows, two launches
    # bitwise equal, one launch a call
    r = selfcheck.check_pose_gn_case(device, M, stereo, prior)
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("prior", [False, True], ids=["plain", "prior"])
def test_pose_gn_bitwise_reproducible(device, prior):
    # the cluster's sums are taken in a fixed order, with no float atomics
    kernel, _ = selfcheck.pose_gn_case(device, 4096, True, prior)
    first = kernel()
    for _ in range(4):
        again = kernel()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [11, 32])
def test_schur_kernels(device, L):
    # L = 11: the local BA's window; L = 32: a wider window on the same
    # shared-memory accumulator (the global BA's L = 128 is in
    # test_loop_kernels); within SCHUR_TOL of the float64 twin, S and rhs
    # bitwise equal over repeated launches, S symmetric, one launch a call
    for r in selfcheck.check_schur(device, n=8192 if L <= 16 else 2048,
                                   L=L):
        assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("L", [11, 128])
def test_schur_bitwise_one_launch(device, L):
    # K8's sums are taken in an order fixed by the data (no float atomics):
    # every output equal over repeated launches, S exactly symmetric, one
    # device operation a call (the local BA's and the global BA's shapes)
    n, O = (8192, 12) if L == 11 else (32768, 8)
    args = selfcheck.schur_inputs(device, n, O, L)

    def kernel():
        return dist_ba.local_reduced_system(*args, lam=1e-4, huber=2.45)

    first = kernel()
    for _ in range(4):
        again = kernel()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(first[0], first[0].T)
    assert selfcheck.device_ops(kernel)["ops"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("L", [11, 128])
def test_schur_backsub_points(device, L):
    # K8's back-substitution as the Schur BAs launch it, with the points'
    # update: masked points bitwise unmoved, the moved points within
    # REL_TOL (of the largest point step) of the float32 twin's, bitwise
    # from launch to launch, at the local and the global BA's shapes
    n, O = (8192, 12) if L == 11 else (32768, 8)
    args = selfcheck.schur_inputs(device, n, O, L)
    _, _, Hinv, bx, W, _ = dist_ba.local_reduced_system(
        *args, lam=1e-4, huber=2.45)
    dx6 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(L, 6)).astype(np.float32) * 1e-3).to(device)
    pts, pt_ok = selfcheck.backsub_points(device, args[1])
    sub = (Hinv, bx, W, args[2], args[4], dx6, pts, pt_ok)
    first = dist_ba.back_substitute(*sub)
    for _ in range(3):
        assert torch.equal(first, dist_ba.back_substitute(*sub))
    assert (~pt_ok).any()
    assert torch.equal(first[~pt_ok], pts[~pt_ok])
    twin = dist_ba.back_substitute_torch(*sub)
    step = float((twin - pts).abs().max())
    assert float((first - twin).abs().max()) <= selfcheck.REL_TOL * step


@pytest.fixture(scope="module")
def scenegraph_checks(device):
    return {r["name"]: r for r in selfcheck.check_scenegraph(device)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["depth_cloud", "extract_planes",
                                  "plane_epilogue"])
def test_scenegraph_kernels(scenegraph_checks, name):
    r = scenegraph_checks[name]
    assert r["ok"], r


@pytest.fixture(scope="module")
def loop_checks(device):
    return {r["name"]: r for r in selfcheck.run_loop_seeded(device)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "bow_vectors", "place_query", "match_nn_ratio", "guided_count",
    "verify_sim3", "pnp_hypotheses", "pgo_assemble", "pgo_cost",
    "schur_reduce@L128", "schur_backsub@L128"])
def test_loop_kernels(loop_checks, name):
    # K10, K11, K5's NN ratio, K16, K15 (both halves), K19 and K8 at the
    # global BA's L = 128, on seeded inputs of the loop path's shapes
    r = loop_checks[name]
    assert r["ok"], r


@pytest.fixture(scope="module")
def place_nn_checks(device):
    return {r["name"]: r for r in (
        selfcheck.run_place_cases(device) + selfcheck.run_nn_cases(device)
        + [selfcheck.check_match_nn(device, ratio=0.8, angles=False,
                                    name="match_nn_ratio@reloc_seeded"),
           selfcheck.check_match_nn(device, selfcheck.nn_inputs(
               device, 1000, n_b=1237), name="match_nn_ratio@1000x1237")])}


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    *(f"place_query@{c}" for c in ("ties", "all_excluded", "top1", "top8",
                                   "reused_slot", "covis_top",
                                   "odd_width")),
    *(f"match_nn_ratio@{c}" for c in ("tie", "nb1", "all_a_invalid",
                                      "na_ne_nb", "no_mutual", "no_angles",
                                      "angle_wrap", "reloc_seeded", "1000x1237"))])
def test_place_query_and_nn_ratio_cases(place_nn_checks, name):
    # K11's two entries and K5's NN ratio against their twins on the CPU
    # parity test's cases (and the NN ratio's relocalisation and
    # n_a != n_b shapes at 1000 descriptors): integers and the database
    # exact, one device operation a call, bitwise from launch to launch
    r = place_nn_checks[name]
    assert r["ok"], r


@pytest.mark.gpu
def test_slice_on_card_uses_every_kernel(device):
    from visual_sgraphs_tpu_torch.config import (
        CapacityConfig, MappingConfig, OrbConfig, SystemConfig)
    from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
    from visual_sgraphs_tpu_torch.slam.system import SlamSystem

    scene = SyntheticScene(h=240, w=320, device=device)
    cfg = SystemConfig(camera=scene.cam, orb=OrbConfig(n_features=300),
                       capacity=CapacityConfig(32, 4096),
                       mapping=MappingConfig(lba_iters=6, lba_interval=2,
                                             cull_interval=2))
    sg_only = ("depth_cloud", "extract_planes", "plane_epilogue",
               "sg_assemble", "sg_plan", "plane_assoc", "rooms_walls")
    cuda.reset_counts()
    system = SlamSystem(cfg, device=device)
    gt = []
    for g, d, T, ts in scene.frames(12, kind="arc"):
        system.track_rgbd(g, d, ts)
        gt.append(T[4:7])
    pos = system.positions()
    counts = cuda.counts()
    assert all(launches > 0 and twin == 0
               for name, (launches, twin) in counts.items()
               if name not in sg_only + LOOP_ONLY + INERTIAL_ONLY
               + FREESPACE_ONLY + CHECK_ONLY + PIPELINE_ONLY
               + FOLD_ONLY), counts
    assert np.isfinite(pos).all() and system.tracked_mask().all()
    err = np.linalg.norm(pos - pos[0] - (np.stack(gt) - gt[0]), axis=1)
    assert err.max() < 0.1


@pytest.mark.gpu
def test_scenegraph_slice_on_card_uses_every_kernel(device):
    import dataclasses

    from visual_sgraphs_tpu_torch.config import (
        CapacityConfig, MappingConfig, OrbConfig, SystemConfig)
    from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
    from visual_sgraphs_tpu_torch.scenegraph import SceneGraphManager
    from visual_sgraphs_tpu_torch.scenegraph.manager import sign_duplicates
    from visual_sgraphs_tpu_torch.slam.system import SlamSystem

    scene = SyntheticScene(h=240, w=320, device=device)
    cfg = SystemConfig(camera=scene.cam, orb=OrbConfig(n_features=300),
                       capacity=CapacityConfig(32, 4096),
                       mapping=MappingConfig(lba_iters=6, lba_interval=2,
                                             cull_interval=2))
    cfg = dataclasses.replace(cfg, scenegraph=dataclasses.replace(
        cfg.scenegraph, plane_covis_enabled=True, refine_map_points=True))
    cuda.reset_counts()
    system = SlamSystem(cfg, device=device)
    system.scenegraph = SceneGraphManager(cfg.scenegraph, cfg.capacity,
                                          device=device)
    for g, d, s, _, ts in scene.frames_with_semantics(12, kind="arc"):
        system.scenegraph.provide_semantics(ts, s)
        system.track_rgbd(g, d, ts)
    pos = system.positions()
    counts = cuda.counts()
    assert all(launches > 0 and twin == 0
               for name, (launches, twin) in counts.items()
               if name not in LOOP_ONLY + INERTIAL_ONLY + FREESPACE_ONLY
               + CHECK_ONLY + PIPELINE_ONLY + FOLD_ONLY), counts
    assert np.isfinite(pos).all() and system.tracked_mask().all()
    planes = system.scenegraph.planes()
    assert len(planes["coeffs"]) >= 2
    assert not sign_duplicates(planes["coeffs"])


@pytest.fixture(scope="module")
def front_end_checks(device):
    grays = selfcheck.batch_frames(device)
    out = selfcheck.check_pyramid(grays) + [selfcheck.check_detect(grays)]
    one = selfcheck.check_pyramid(grays[:1])[1]
    one["name"] += "@B1"
    out += [one] + selfcheck.check_blur_cases(device)
    out += selfcheck.check_front_end_small(device)
    out += selfcheck.check_detect_cases(device)
    return {r["name"]: r for r in out}


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    n + size for size in ("", "@240x320")
    for n in ("pyramid_resize", "gaussian_blur", "detect_level")]
    + ["gaussian_blur@B1", "gaussian_blur@720x1280", "gaussian_blur@tiny",
       "detect_level@B1", "detect_level@ties", "detect_level@720x1280",
       "detect_level@cell48"])
def test_front_end_kernels(front_end_checks, name):
    # K1's resize within 1e-4 of the twin (expected bitwise) with no FAST
    # keypoint flipped downstream; K1's blur over every level in one launch
    # (one device operation) a call, bitwise equal to the twin and from
    # launch to launch; K3 bitwise on all five fields (rc, response, valid,
    # uv, level) in one launch a call, bitwise from launch to launch; on a
    # batch of 8 frames at 480x640 / 1000 features, on one frame, on the
    # batch's tie-heavy quantised scores, at 240x320 / 600 features, where
    # K3's deepest levels are shorter than their budget, on a 720x1280
    # frame (1840 candidates on level 0), with 48-pixel cells and (the
    # blur) on levels smaller than its taps
    r = front_end_checks[name]
    assert r["ok"], r
    if name.startswith("pyramid_resize"):
        assert sum(r["fast_keypoints_differ_per_level"]) == 0, r
    if name.startswith("gaussian_blur"):
        assert r["bitwise"] and r["bitwise_repro"], r
        assert r["launches_per_call"] == 1 and r["device_ops"] == 1, r
    if name.startswith("detect_level"):
        assert r["launches_per_call"] == 1 and r["bitwise_repro"], r
    if name == "detect_level@240x320":
        assert r["padded_levels"] >= 1, r
    if name == "detect_level@720x1280":
        assert r["max_candidates"] > 1024, r


def _extract_orb_one_k3_launch(img):
    from visual_sgraphs_tpu_torch.features import orb
    cuda.reset_counts()
    k = orb.extract_orb(img)
    counts = cuda.counts()
    t = orb.extract_orb(img.cpu())
    assert counts["detect_level"] == (1, 0)
    assert counts["pyramid_resize"] == (1, 0)
    assert counts["gaussian_blur"] == (1, 0)
    assert counts["orb_desc"] == (1, 0) and counts["fast_nms"] == (1, 0)
    for f in ("uv", "response", "level", "valid"):
        assert torch.equal(getattr(k, f).cpu(), getattr(t, f)), f
    assert float((k.angle.cpu() - t.angle).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8])
def test_extract_orb_one_k3_launch(device, B):
    # extract_orb on the card: K1's chain, K2, K3, K1's blur and K4 launch
    # once each; the selected keypoints (uv, response,
    # level, valid) equal to the extraction on the CPU twins of the same
    # frames, the angles within 1e-5 rad (atan2 on two devices; the
    # descriptors, which follow the angles, are held bitwise given the
    # same angles by test_orb_desc_kernel)
    grays = selfcheck.batch_frames(device, B=B)
    _extract_orb_one_k3_launch(grays if B > 1 else grays[0])


@pytest.mark.gpu
def test_extract_orb_720x1280(device):
    # the same at 720x1280 (1840 candidates on level 0, past a fixed
    # 1024-candidate table)
    _extract_orb_one_k3_launch(
        selfcheck.batch_frames(device, B=1, h=720, w=1280)[0])


@pytest.fixture(scope="module", params=[(480, 640), (240, 320)],
                ids=lambda s: f"{s[0]}x{s[1]}")
def chain_frames(device, request):
    return selfcheck.batch_frames(device, h=request.param[0],
                                  w=request.param[1])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8])
def test_pyramid_chain_bitwise(chain_frames, B):
    # K1's resize chain, one launch a build_pyramid call (on the batch and
    # on its first frame as an (H, W) image), bitwise equal to the twin's
    # chain at every level, with every level's FAST keypoints identical
    r = selfcheck.check_pyramid(chain_frames[:B])[0]
    assert r["max_abs_err"] == 0, r
    assert r["launches_per_call"] == 1, r
    assert sum(r["fast_keypoints_differ_per_level"]) == 0, r


@pytest.mark.gpu
def test_compact_kernel(device):
    # K7's plain entry at the main path's three shapes, an empty mask and
    # one off a 16-byte boundary, and its observed entry on a seeded map
    # (duplicate and masked keyframes): bitwise equal to the twins, one
    # device operation a call, bitwise from launch to launch
    for r in (selfcheck.check_compact(device),
              selfcheck.check_compact_observed(device)):
        assert r["ok"] and r["graph_ops"] == 1, r


@pytest.mark.gpu
def test_group_observations_kernel(device):
    r = selfcheck.check_group(device)
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(selfcheck.GROUP_CASES))
def test_group_observations_cases(device, name):
    # K9 exactly equal to the twin (kf, valid and n_dropped; uvr bitwise) in
    # one launch, valid out-of-range ids included
    r = selfcheck.check_group_case(device, name)
    assert r["ok"], r


@pytest.mark.gpu
def test_bench_path_on_card_uses_every_kernel(device):
    # the headline configuration (bench.py:64-91: the B-frame pipeline,
    # loops and scene graph on) over the first 96 of its 192 frames: every
    # kernel but those only a relocalisation or a loop launches runs, no
    # twin sees a CUDA tensor, and the batches read back less than once a
    # frame
    from visual_sgraphs_tpu_torch import main_path

    scene, frames = main_path.frames(device, main_path.BENCH_FRAMES)
    cfg = main_path.bench_config(scene)
    cuda.reset_counts()
    system = main_path.make_system(cfg, device, True)
    for frame in frames[:96]:
        main_path.feed(system, frame)
    system.flush()
    counts = cuda.counts()
    assert all(twin == 0 for _, twin in counts.values()), counts
    assert all(launches > 0 for name, (launches, _) in counts.items()
               if name not in ("pnp_hypotheses", "verify_sim3",
                               "match_nn_ratio", "guided_count",
                               "pgo_assemble", "pgo_cost")
               + INERTIAL_ONLY + FREESPACE_ONLY + CHECK_ONLY), counts
    assert system.tracked_mask().sum() >= 0.9 * 96
    assert system.host_readbacks < 96
    assert np.isfinite(system.positions()).all()


@pytest.fixture(scope="module")
def inertial_checks(device):
    return {r["name"]: r for r in selfcheck.run_inertial(device)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["preint", "vi_pose", "pose_gn_prior"])
def test_inertial_kernels(inertial_checks, name):
    # K18 (one launch, with and without the pose prediction) within 1e-5
    # of each field's largest entry (the covariance 1e-4), the integration
    # time exactly, the predicted pose and velocity within 1e-5, bitwise
    # from launch to launch; K20 with the inlier count exact, pose
    # and biases within 1e-4, velocity within 1e-3 m/s; K6's prior branch
    # within 1e-4 at the main path's weight 10, at 1e5 and at 1e9, where
    # the prior must move the pose by >= 0.01 as it moves the twin's
    r = inertial_checks[name]
    assert r["ok"], r


@pytest.mark.gpu
def test_inertial_path_on_card_matches_cpu(device):
    # 72 small arc frames with their IMU samples, rendered on the CPU:
    # the card's run launches K18, K20, K6's prior branch and K22a / K22b /
    # K22c, no twin sees a CUDA tensor, nothing is linearised by the
    # generic engine on the card, and positions agree with the CPU twins'
    # run within 0.01 m, with the same keyframe count and initialisation
    # frame
    from visual_sgraphs_tpu_torch import main_path
    from visual_sgraphs_tpu_torch.config import CapacityConfig
    from visual_sgraphs_tpu_torch.inertial import preintegration
    from visual_sgraphs_tpu_torch.optim import graph

    scene, frames = main_path.inertial_frames("cpu", 72, 240, 320, "arc")
    cfg = main_path.inertial_config(scene, 300, CapacityConfig(32, 4096))
    runs = {}
    for dev in ("cuda", "cpu"):
        cuda.reset_counts()
        graph.linearize_batch.cuda_calls = 0
        preintegration.predict_state.cuda_calls = 0
        system = main_path.make_system(cfg, dev, False)
        init = None
        for i, frame in enumerate(frames):
            main_path.feed_inertial(system, frame)
            if init is None and system.imu.initialized:
                init = i
        runs[dev] = (system.positions(), int(system.map.n_kf), init,
                     cuda.counts(), graph.linearize_batch.cuda_calls,
                     preintegration.predict_state.cuda_calls)
    counts = runs["cuda"][3]
    assert runs["cuda"][4] == 0
    assert all(counts[k][0] > 0 for k in INERTIAL_ONLY), counts
    assert all(twin == 0 for _, twin in counts.values()), counts
    # the prediction comes from K18's launch: no predict_state on the card
    assert runs["cuda"][5] == 0
    assert runs["cuda"][2] is not None
    assert runs["cuda"][1:3] == runs["cpu"][1:3]
    assert np.abs(runs["cuda"][0] - runs["cpu"][0]).max() < 0.01


@pytest.fixture(scope="module")
def lm_checks(device):
    return {r["name"]: r for r in selfcheck.run_lm(device)}


@pytest.mark.gpu
def test_lm_reduce_bitwise_few_ops(lm_checks):
    # K22a's reduction on the VI window, given the solve's row plan: its
    # outputs equal over repeated launches, <= 2 device operations a call
    r = lm_checks["lm_reproj_reduce"]
    assert r["bitwise_repro"], r
    assert r["device_ops"] <= 2, r


@pytest.mark.gpu
@pytest.mark.parametrize("name", LM_KERNELS + tuple(
    f"{k}@{tag}" for tag in ("lba", "lba_x2", "lba_x4")
    for k in ("lm_reproj_reduce", "lm_reproj_cost")) + ("lm_solve@lba",)
    + K22B_TAGGED)
def test_lm_kernels(lm_checks, name):
    # on the third VI local BA window and the last generic local BA window
    # of a small inertial run (the latter also tiled to 22 and 44 slots):
    # K22a's reduced pose block and rhs within 2e-4 (diagonally scaled) of
    # the float64 twin at lambda 1e-4 and 1, its point steps within 1e-3 of
    # the largest and its cost within 1e-5; K22b's plan (W within 1e-10 of
    # the float64 twin's, the edge index equal), H, g within 1e-3 scaled
    # and its cost within 1e-5 on the VI problem, the initialisation
    # problem and that problem tiled to 100 and 1500 edges; K22c's step
    # within 1e-6
    # of the twin's float64 solve, its candidates within 1e-5; K22a's
    # back-substitution and cost one device operation a call (the nodes
    # of a CUDA graph captured from the call, with a step and without),
    # its points and cost bitwise equal over repeated launches
    r = lm_checks[name]
    assert r["ok"], r
    if name.startswith("lm_reproj_cost"):
        assert r["device_ops"] == 1 and r["device_ops_no_step"] == 1, r
        assert r["bitwise_repro"], r


@pytest.mark.gpu
@pytest.mark.parametrize("name", (
    "lm_inertial_plan", "lm_inertial_assemble", "lm_inertial_cost")
    + K22B_TAGGED)
def test_lm_inertial_bitwise_one_op(lm_checks, name):
    # K22b: one device operation a call (no memset; the nodes of a CUDA
    # graph captured from the call), and the rows and the cost bitwise
    # equal over repeated launches (no float atomics)
    r = lm_checks[name]
    assert r["device_ops"] == 1, r
    assert r.get("bitwise_repro", True), r


@pytest.fixture(scope="module")
def lm_seeded(device):
    return selfcheck.check_lm_solve_seeded(device)


@pytest.mark.gpu
@pytest.mark.parametrize("D", list(selfcheck.LM_SEEDED_LAYOUTS))
def test_lm_solve_seeded(lm_seeded, D):
    # K22c on the seeded systems (H's diagonal spanning ~1e-10 to 1e7, the
    # gauge fixed) from one tile to past the shared-memory tiles (D = 225,
    # 264 run on global scratch): the step within 1e-6 of the twin's
    # float64 solve, the candidates within 1e-5
    e = lm_seeded["errs"][D]
    assert e["dx"] <= selfcheck.LM_SOLVE_TOL, e
    assert e["cand"] <= selfcheck.LM_CAND_TOL, e


@pytest.mark.gpu
def test_lm_solve_not_positive_definite(lm_seeded):
    # a system whose Cholesky fails gives a zero step (kernel and twin)
    # and candidates equal to the inputs
    assert all(lm_seeded["non_pd"].values()), lm_seeded["non_pd"]


@pytest.fixture(scope="module")
def freespace_checks(device):
    return {r["name"]: r for r in selfcheck.run_freespace(device)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["freespace_carve",
                                  "freespace_components@snake",
                                  "sg_assemble", "sg_plan"])
def test_freespace_and_sg_assemble_kernels(freespace_checks, name):
    # K17a on a rendered 480x640 frame at a non-identity pose and K17b on
    # the serpentine grid, both exactly equal to their twins; K21's system
    # on seeded operands with live items of all five factor types, S and
    # rhs (with a seeded keyframe block) within 1e-4 of the float64 twin's
    # largest entries, and its plan exactly its twin's
    r = freespace_checks[name]
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sg_assemble", "sg_plan",
                                  "extract_planes"])
def test_sg_system_plan_and_ransac_one_launch(freespace_checks,
                                              scenegraph_checks, name):
    # K21's system and plan and K13's extraction: one device operation a
    # call (the nodes of a CUDA graph captured from it), outputs bitwise
    # equal from launch to launch
    r = {**freespace_checks, **scenegraph_checks}[name]
    assert r["device_ops"] == 1 and r["bitwise_repro"], r


@pytest.mark.gpu
def test_freespace_slice_on_card_uses_every_kernel(device):
    # the free-space path at 240x320 on CPU-rendered frames, clustering
    # every second keyframe: K17a launched once per keyframe, K17b once
    # per clustering pass, K21 on every scene-graph BA iteration, no twin
    # on a CUDA tensor; free voxels within 1 % of the CPU twins' run and
    # the same rooms; K17b on the card's grid exact; a whole scene-graph
    # BA with a seeded room, corridor and door within 1e-4 of the float64
    # twin's
    import dataclasses

    from visual_sgraphs_tpu_torch import main_path
    from visual_sgraphs_tpu_torch.config import CapacityConfig

    scene, frames = main_path.frames("cpu", 24, 240, 320, "arc")
    _, sg_cfg = main_path.configs(scene, 300, CapacityConfig(32, 4096))
    cfg = dataclasses.replace(sg_cfg, scenegraph=dataclasses.replace(
        sg_cfg.scenegraph, room_method="freespace"))
    runs = {}
    for dev in ("cuda", "cpu"):
        cuda.reset_counts()
        system = main_path.make_system(cfg, dev, True)
        system.scenegraph.maintenance_interval = 2
        for frame in frames:
            main_path.feed(system, frame)
        runs[dev] = (system, cuda.counts())
    system, counts = runs["cuda"]
    mgr = system.scenegraph
    fused = [e for e in system.events.of_kind("keyframe")
             if "joint_ba" not in e]
    n_lba = sum(bool(e["lba"]) for e in fused)
    assert all(twin == 0 for _, twin in counts.values()), counts
    assert counts["freespace_carve"][0] == len(fused) >= 2, counts
    assert counts["freespace_components"][0] == mgr._kf_count // 2 >= 1
    assert counts["sg_assemble"][0] == cfg.mapping.lba_iters * n_lba > 0
    assert counts["sg_plan"][0] == n_lba, counts
    assert (counts["rooms_freespace"][0]
            == counts["freespace_components"][0]), counts
    assert counts["rooms_walls"][0] == 0, counts
    assert counts["plane_assoc"][0] == counts["plane_epilogue"][0] >= 2
    n_card = int(mgr._free_grid.sum())
    n_cpu = int(runs["cpu"][0].scenegraph._free_grid.sum())
    assert n_cpu > 0 and abs(n_card - n_cpu) <= 0.01 * n_cpu
    rk, rc = mgr.rooms(), runs["cpu"][0].scenegraph.rooms()
    assert len(rk["center"]) == len(rc["center"])
    if len(rc["center"]):
        assert np.abs(rk["center"] - rc["center"]).max() <= 0.05
    r = selfcheck.check_freespace_components(device, mgr._free_grid,
                                             mgr._free_origin)
    assert r["ok"], r
    r = selfcheck.check_sg_ba(
        system.map, selfcheck.seed_rooms_and_doors(mgr.state),
        system.ref_kf_host, system.cam_K, system.cam_bf, cfg.scenegraph)
    assert r["ok"], r


@pytest.fixture(scope="module")
def rooms_checks(device):
    return {r["name"]: r for r in selfcheck.run_rooms(device)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rooms_walls@cases",
                                  "rooms_freespace@cases",
                                  "plane_assoc@cases"])
def test_rooms_and_plane_assoc_kernels(rooms_checks, name):
    # K23's two entries and K24 on the seeded cases the CPU parity tests
    # (tests/test_torch_rooms.py) hold the twins to: integer and bool
    # fields exact, room centres within 1e-6 m, plane and observation
    # floats within 1e-5
    r = rooms_checks[name]
    assert r["ok"], r


@pytest.fixture(scope="module")
def guided_assoc_checks(device):
    out = selfcheck.run_guided_cases(device) + [
        selfcheck.check_guided(device, name="guided_count@seeded")]
    for c in selfcheck.assoc_cases():
        out.append(selfcheck.check_plane_assoc(
            device, *selfcheck.assoc_operands(c, device),
            name=f"plane_assoc@{c['name']}"))
    return {r["name"]: r for r in out}


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    *(f"guided_count@{c}" for c in ("seeded", "behind", "no_valid_b",
                                    "hamming_64", "one_b", "scaled")),
    *(f"plane_assoc@{c}" for c in ("same_plane_twice", "full_planes",
                                   "full_obs", "argmin_tie",
                                   "two_on_one"))])
def test_guided_count_and_plane_assoc_cases(guided_assoc_checks, name):
    # K16 (the rows' validity, the Sim3 projection, the gate and the
    # count in one launch) exactly its twin's, and K24 (the score table in
    # parallel, the detections resolved in order) with integer fields
    # exact and floats within 1e-5, each on the CPU parity tests' cases:
    # one device operation a call, bitwise from launch to launch
    r = guided_assoc_checks[name]
    assert r["ok"] and r["device_ops"] == 1, r


@pytest.fixture(scope="module")
def scan_ba_checks(device):
    return {r["name"]: r for r in selfcheck.run_scan(device)
            + selfcheck.run_ba_solve(device)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    *(f"scan_epilogue@{c}" for c, _, _ in selfcheck.SCAN_CASES),
    "scan_prologue", "inlier_tail"])
def test_scan_epilogue_kernel(scan_ba_checks, name):
    # K25's three entries against their twins on seeded attempts (the
    # retry taken and accepted, not taken, taken but rejected): integers,
    # decisions and the packed row exact, poses within SCAN_POSE_TOL,
    # bitwise from launch to launch; the frame entry one device operation
    r = scan_ba_checks[name]
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ba_solve@lba", "ba_solve",
                                  "ba_solve@gba", "ba_solve@gba256",
                                  "ba_solve@not_pd"])
def test_ba_solve_kernel(scan_ba_checks, name):
    # K26 at D = 66, 402 (the scene-graph BA's, fixed keyframes, planes,
    # rooms and doors), 768 and 1536 (its one-block path and its cluster
    # over distributed shared memory and over global scratch), and on a
    # system that is not positive definite (a zero step): the step within
    # BA_STEP_TOL of the float64 twin's largest entry, the moved values
    # within BA_VALUE_TOL, bitwise from launch to launch, one device
    # operation a call
    r = scan_ba_checks[name]
    assert r["ok"], r


@pytest.fixture(scope="module")
def maint_checks(device):
    return {r["name"]: r for r in selfcheck.run_maintenance(device)}


MAINT_CASES = ("first_keyframe", "free_slot_fold", "evict",
               "evict_full_ledger", "evict_alone", "evict_tie", "ties")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    f"{k}@{c}" for c in MAINT_CASES
    for k in ("kf_insert", "fuse_prologue", "fuse_writeback", "map_cull")]
    + ["found_stats@free_slot_fold", "found_stats@frame"])
def test_map_maintenance_kernels(maint_checks, name):
    # K27's two entries, K28's two and K29 against their twins on the
    # seeded maps of tests/test_torch_kf_maintenance.py at the cells'
    # capacities (128 keyframes, 1000 keypoints, 32768 points, the 4096
    # ledger entries): integer and bool fields exact, pt_pos, kf_pose and
    # led_T_cp within MAINT_TOL, the input map unmodified, one device
    # operation a call, bitwise from launch to launch
    r = maint_checks[name]
    assert r["ok"], r
