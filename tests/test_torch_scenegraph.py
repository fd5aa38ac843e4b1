"""Port parity of the scene-graph layer: plane algebra, the plane detector's
three kernels' twins (K12 depth cloud + voxel downsample, K13 weighted
RANSAC, K14 per-detection statistics), association, maintenance, rooms,
semantic point refinement, the scene-graph factors and the scene-graph
local BA, each against the reference function on the same numpy inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.config import SceneGraphConfig as RefSGConfig
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.core import plane as rplane
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu.optim import factors as rfac
from visual_sgraphs_tpu.optim import fast_ba as rba
from visual_sgraphs_tpu.optim import graph as rgraph
from visual_sgraphs_tpu.scenegraph import joint_ba as rjoint
from visual_sgraphs_tpu.scenegraph import manager as rman
from visual_sgraphs_tpu.scenegraph import plane_fit as rfit
from visual_sgraphs_tpu.scenegraph import pointcloud as rpc
from visual_sgraphs_tpu.scenegraph import state as rstate
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.core import plane as pplane
from visual_sgraphs_tpu_torch.optim import factors as pfac
from visual_sgraphs_tpu_torch.optim import fast_ba as pba
from visual_sgraphs_tpu_torch.optim import graph as pgraph
from visual_sgraphs_tpu_torch.scenegraph import joint_ba as pjoint
from visual_sgraphs_tpu_torch.scenegraph import manager as pman
from visual_sgraphs_tpu_torch.scenegraph import plane_fit as pfit
from visual_sgraphs_tpu_torch.scenegraph import pointcloud as ppc
from visual_sgraphs_tpu_torch.scenegraph import state as pstate

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

FRAMES = (0, 4, 8, 11)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def hypotheses(key, n_det=4, n_hyp=192, n_cloud=2048):
    """The reference's RANSAC samples for ``key`` (extract_planes splits
    the key per round; ransac_plane draws randint(k, (n_hyp, 3), 0, N))."""
    return np.stack([_np(jax.random.randint(k, (n_hyp, 3), 0, n_cloud))
                     for k in jax.random.split(key, n_det)]).astype(np.int32)


def up_to_sign(a, b):
    """Flip rows of ``b`` (..., 4) to the sign of the matching row of
    ``a`` (plane coefficients equal up to sign)."""
    s = np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    return b * s


@pytest.fixture(scope="module")
def snap():
    """A mid-stream reference map (two keyframes, see torch_parity)."""
    return tp.snapshot(10)


@pytest.fixture(scope="module")
def sem_frames():
    scene, frames = tp.semantic_frames(12)
    return scene, [(d, s, T) for _, d, s, T, _ in frames]


# ---------------------------------------------------------------- plane algebra


def _planes(rng, n):
    c = rng.normal(size=(n, 4)).astype(np.float32)
    c[:, 3] *= 3
    return c / np.linalg.norm(c[:, :3], axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["normalize", "normal_rotation", "oplus",
                                "ominus", "transform", "point_plane_distance"])
def test_plane_algebra(fn):
    # float32 inputs from a numpy seed; within 1e-5 (trig rounding)
    rng = np.random.default_rng(0)
    a, b = _planes(rng, 64), _planes(rng, 64)
    delta = (rng.normal(size=(64, 3)) * 0.2).astype(np.float32)
    T = _np(rlie.se3_exp(jnp.asarray(rng.normal(size=(64, 6)) * 0.5,
                                     jnp.float32)))
    p = rng.normal(size=(64, 3)).astype(np.float32) * 3
    args = {"normalize": (a * 2.5,), "normal_rotation": (a[:, :3],),
            "oplus": (a, delta), "ominus": (a, b), "transform": (T, a),
            "point_plane_distance": (a, p)}[fn]
    ref = getattr(rplane, fn)(*(jnp.asarray(x) for x in args))
    port = getattr(pplane, fn)(*(_t(x) for x in args))
    np.testing.assert_allclose(port.numpy(), _np(ref), rtol=0, atol=1e-5)


def test_fit_centroid_svd_up_to_sign():
    # the eigenvector's sign is the solver's: equal up to sign within 1e-5
    rng = np.random.default_rng(1)
    pts = np.zeros((500, 3), np.float32)
    pts[:, :2] = rng.uniform(-2, 2, (500, 2))
    pts[:, 2] = 2.0 + 0.3 * pts[:, 0] + rng.normal(size=500) * 0.01
    w = rng.uniform(0.2, 1.0, 500).astype(np.float32)
    r = _np(rplane.fit_centroid_svd(jnp.asarray(pts), jnp.asarray(w)))
    p = pplane.fit_centroid_svd(_t(pts), _t(w)).numpy()
    np.testing.assert_allclose(up_to_sign(r, p), r, rtol=0, atol=1e-5)


def test_voxel_key_slot_and_semantics_exact():
    rng = np.random.default_rng(2)
    p = (rng.normal(size=(4096, 3)) * 20).astype(np.float32)
    rk = rstate.voxel_key(jnp.asarray(p))
    np.testing.assert_array_equal(pstate.voxel_key(_t(p)).numpy(), _np(rk))
    np.testing.assert_array_equal(
        pstate.voxel_slot(pstate.voxel_key(_t(p)), 512).numpy(),
        _np(rstate.voxel_slot(rk, 512)))
    sg = synthetic_state()
    np.testing.assert_array_equal(
        pstate.plane_semantics(port_state(sg), 3.0).numpy(),
        _np(rstate.plane_semantics(sg, 3.0)))


# ---------------------------------------------------------------- K12-K14 twins


@functools.partial(jax.jit, static_argnums=(2,))
def _ref_cloud(depth, K, n_out):
    """The reference's strided cloud + voxel downsample, compiled as the
    detector compiles it (a constant voxel size divides by its float32
    reciprocal)."""
    pts, valid, _ = rpc.backproject_depth(depth, K, stride=4)
    return (pts, valid) + rpc.voxel_downsample(
        pts, valid, 0.08, n_out, min_points_per_voxel=1,
        point_weight=jnp.ones(pts.shape[:1], jnp.float32))


@pytest.mark.parametrize("frame", FRAMES)
def test_depth_cloud_twin(sem_frames, frame):
    # K12: validity and the voxels chosen (which, in which order) exact;
    # points and centroids within 1e-5 m
    scene, frames = sem_frames
    depth = frames[frame][0]
    K = np.asarray(scene.cam.K, np.float32)
    r = [_np(x) for x in _ref_cloud(jnp.asarray(depth), jnp.asarray(K), 2048)]
    p = [x.numpy() for x in ppc.depth_cloud_torch(
        _t(depth), None, None, _t(K), 0.08, 2048)]
    np.testing.assert_array_equal(p[1], r[1])
    np.testing.assert_array_equal(p[5], r[3])
    np.testing.assert_allclose(p[0], r[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(p[4], r[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(p[6], r[4], rtol=0, atol=1e-5)
    assert r[3].sum() > 500


@pytest.mark.parametrize("frame", FRAMES)
def test_extract_planes_twin(sem_frames, frame):
    # K13 on the reference's cloud with the reference's samples: the same
    # planes found, coefficients equal up to sign within 1e-4, point
    # assignments >= 99.9 % equal; the port pins c >= 0
    scene, frames = sem_frames
    K = jnp.asarray(np.asarray(scene.cam.K, np.float32))
    _, _, cloud, cvalid, cw = _ref_cloud(jnp.asarray(frames[frame][0]), K,
                                         2048)
    key = jax.random.PRNGKey(frame)
    rc, rv, ra = (_np(x) for x in rfit.extract_planes(
        cloud, cvalid, cw, key, n_planes=4, n_hyp=192, dist_thresh=0.04,
        min_inliers=150.0))
    pc, pv, pa = (x.numpy() for x in pfit.extract_planes_torch(
        _t(cloud), _t(cvalid), _t(cw), _t(hypotheses(key)), 0.04, 150.0))
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_allclose(up_to_sign(rc, pc), rc, rtol=0, atol=1e-4)
    assert np.mean(pa == ra) >= 0.999
    assert (pc[pv, 3] >= 0).all()


@pytest.mark.parametrize("frame", FRAMES)
def test_detect_planes_from_depth(sem_frames, frame):
    # the whole detector (K12 -> K13 -> K14): planes equal up to sign
    # within 1e-4; K14's member counts and voxel-key rows exact, votes,
    # centroids and quadrics within 1e-4 relative
    scene, frames = sem_frames
    depth, sem, T_wc = frames[frame]
    T_cw = _np(rlie.se3_inverse(jnp.asarray(T_wc)))
    K = np.asarray(scene.cam.K, np.float32)
    key = jax.random.PRNGKey(frame)
    r = [_np(x) for x in rman.detect_planes_from_depth(
        jnp.asarray(depth), jnp.asarray(sem), jnp.asarray(T_cw),
        jnp.asarray(K), key, dist_thresh=0.04)]
    p = [x.numpy() for x in pman.detect_planes_from_depth(
        _t(depth), _t(sem), _t(T_cw), _t(K), _t(hypotheses(key)),
        dist_thresh=0.04)]
    cw, valid, cen, npts, votes, local, quad, vox = p
    np.testing.assert_array_equal(valid, r[1])
    np.testing.assert_allclose(up_to_sign(r[0], cw), r[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(up_to_sign(r[5], local), r[5], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(npts, r[3])
    np.testing.assert_array_equal(vox, r[7])
    for got, want in ((cen, r[2]), (votes, r[4]), (quad, r[6])):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    assert valid.any() and (local[valid, 3] >= 0).all()


# ------------------------------------------------ association and maintenance


def synthetic_state(max_obs=64):
    """A reference SceneGraphState of the synthetic room: the six room
    planes (perturbed), settled votes (ground / ceiling / walls), two
    keyframes' observations with Gij quadrics, one 4-wall room, one
    corridor and a door."""
    rng = np.random.default_rng(3)
    cap = tp.slice_config(SyntheticScene(h=240, w=320)).capacity
    sg = rstate.empty_scenegraph(cap, max_obs=max_obs)
    room = np.array([[0, -1, 0, 1.6], [0, 1, 0, 1.6], [1, 0, 0, 2.5],
                     [-1, 0, 0, 2.5], [0, 0, -1, 7.0], [0, 0, 1, 3.0]],
                    np.float32)
    planes = room + rng.normal(size=room.shape).astype(np.float32) * 0.02
    planes /= np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    cls = [0, 2, 1, 1, 1, 1]
    votes = np.zeros((cap.max_planes, 3), np.float32)
    votes[np.arange(6), cls] = 4.0
    cen = np.array([[0, 1.6, 2], [0, -1.6, 2], [-2.5, 0, 2], [2.5, 0, 2],
                    [0, 0, 7], [0, 0, -3]], np.float32)
    P = cap.max_planes
    pl = np.zeros((P, 4), np.float32)
    pl[:6] = planes
    cen_all = np.zeros((P, 3), np.float32)
    cen_all[:6] = cen
    valid = np.zeros(P, bool)
    valid[:6] = True
    npts = np.zeros(P, np.float32)
    npts[:6] = [900, 300, 500, 450, 800, 200]
    # observations: keyframes 0 and 1 see planes 0, 2, 3, 4
    T = _np(rlie.se3_exp(jnp.asarray([[0, 0, 0, 0, 0, 0],
                                      [0.1, 0.02, 0.3, 0.01, 0.05, 0]],
                                     jnp.float32)))
    ob_kf, ob_pl, ob_c, ob_q = [], [], [], []
    for k in (0, 1):
        for j in (0, 2, 3, 4):
            loc = _np(rplane.transform(jnp.asarray(T[k]),
                                       jnp.asarray(room[j])))
            # Gij of points on the (unperturbed) plane, camera frame
            basis = np.linalg.svd(loc[None, :3])[2][1:]
            pts = (-loc[3] * loc[:3])[None] + rng.uniform(
                -1, 1, (200, 2)) @ basis
            ph = np.concatenate([pts, np.ones((200, 1))], 1)
            ob_kf.append(k)
            ob_pl.append(j)
            ob_c.append(loc + rng.normal(size=4) * 0.01)
            ob_q.append(ph.T @ ph / 200)
    n = len(ob_kf)

    def put(arr, vals):
        arr = np.array(arr)
        arr[:n] = vals
        return jnp.asarray(arr)

    return sg._replace(
        pl_coeffs=jnp.asarray(pl), pl_valid=jnp.asarray(valid),
        pl_centroid=jnp.asarray(cen_all), pl_npts=jnp.asarray(npts),
        pl_votes=jnp.asarray(votes),
        pl_nobs=jnp.asarray(np.where(valid, 2, 0).astype(np.int32)),
        ob_kf=put(sg.ob_kf, ob_kf), ob_plane=put(sg.ob_plane, ob_pl),
        ob_coeffs=put(sg.ob_coeffs, np.array(ob_c, np.float32)),
        ob_conf=put(sg.ob_conf, np.full(n, 0.8, np.float32)),
        ob_quadric=put(sg.ob_quadric, np.array(ob_q, np.float32)),
        ob_valid=put(sg.ob_valid, np.ones(n, bool)),
        room_center=sg.room_center.at[:2].set(
            jnp.asarray([[0, 0, 2.0], [0, 0, 1.8]], jnp.float32)),
        room_walls=sg.room_walls.at[:2].set(
            jnp.asarray([[2, 3, 4, 5], [2, 3, -1, -1]], jnp.int32)),
        room_is_corridor=sg.room_is_corridor.at[1].set(True),
        room_valid=sg.room_valid.at[:2].set(True),
        room_ground=sg.room_ground.at[0].set(0),
        door_pose=sg.door_pose.at[0].set(jnp.asarray(
            [1, 0, 0, 0, 2.4, 0.0, 3.0], jnp.float32)),
        door_marker=sg.door_marker.at[0].set(7),
        door_valid=sg.door_valid.at[0].set(True),
        n_planes=jnp.asarray(6, jnp.int32),
        n_obs=jnp.asarray(n, jnp.int32), n_rooms=jnp.asarray(2, jnp.int32),
        n_doors=jnp.asarray(1, jnp.int32))


def port_state(sg):
    return interop.scenegraph_from_numpy(tp.to_np(sg))


def assert_state_close(port, ref, atol=1e-5):
    for k, v in tp.to_np(ref).items():
        got = getattr(port, k).numpy()
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(got, v, rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_scenegraph_state_round_trip():
    # exact, field for field, in the port's dtypes
    sg = synthetic_state()
    p = port_state(sg)
    assert_state_close(p, sg, atol=0)
    back = interop.scenegraph_to_numpy(p)
    assert set(back) == set(pstate.SceneGraphState._fields)


def test_associate_and_update(sem_frames):
    # two keyframes' reference detections into the synthetic table and
    # into an empty one: every field within 1e-5
    scene, frames = sem_frames
    K = np.asarray(scene.cam.K, np.float32)
    for sg in (synthetic_state(), rstate.empty_scenegraph(
            tp.slice_config(scene).capacity, max_obs=64)):
        psg = port_state(sg)
        for kf, frame in ((2, 4), (3, 8)):
            depth, sem, T_wc = frames[frame]
            T_cw = rlie.se3_inverse(jnp.asarray(T_wc))
            det = rman.detect_planes_from_depth(
                jnp.asarray(depth), jnp.asarray(sem), T_cw, jnp.asarray(K),
                jax.random.PRNGKey(frame), dist_thresh=0.04)
            (cw, valid, cen, npts, votes, local, quad, vox) = det
            sg = rman.associate_and_update(
                sg, cw, valid, cen, npts, votes, local,
                jnp.asarray(kf, jnp.int32), det_quadric=quad, det_vox=vox)
            d = [_t(_np(x)) for x in det]
            psg = pman.associate_and_update(
                psg, d[0], d[1], d[2], d[3], d[4], d[5], kf,
                det_quadric=d[6], det_vox=d[7])
        assert_state_close(psg, sg)
        assert int(sg.n_obs) > 0


@pytest.mark.parametrize("fn", ["filter_semantic_planes",
                                "reassociate_planes", "detect_rooms"])
def test_maintenance_and_rooms(fn):
    sg = synthetic_state()
    # a duplicate of the back wall (merge candidate) and a tilted "wall"
    sg = sg._replace(
        pl_coeffs=sg.pl_coeffs.at[6].set(jnp.asarray(
            [0.01, 0, -1.0, 7.05], jnp.float32) / 1.00005).at[7].set(
            jnp.asarray([0.6, 0.8, 0, 1.0], jnp.float32)),
        pl_centroid=sg.pl_centroid.at[6].set(
            jnp.asarray([0.3, 0, 7.0], jnp.float32)),
        pl_valid=sg.pl_valid.at[6:8].set(True),
        pl_votes=sg.pl_votes.at[6:8, 1].set(5.0),
        pl_npts=sg.pl_npts.at[6:8].set(100.0),
        room_valid=sg.room_valid.at[:2].set(False),
        n_rooms=jnp.asarray(0, jnp.int32))
    ref = getattr(rman, fn)(sg)
    port = getattr(pman, fn)(port_state(sg))
    assert_state_close(port, ref)
    changed = any(not np.array_equal(_np(a), _np(b))
                  for a, b in zip(ref, sg) if a is not None)
    assert changed


def test_plane_covis_bonus():
    sg = synthetic_state()
    sg = sg._replace(ob_kf=sg.ob_kf.at[2].set(5).at[5].set(9))
    for kf in (0, 1, 5):
        r = rman.plane_covis_bonus(sg, jnp.asarray(kf, jnp.int32), 32)
        p = pman.plane_covis_bonus(port_state(sg), kf, 32)
        np.testing.assert_allclose(p.numpy(), _np(r), rtol=0, atol=1e-6)


def test_refine_points_semantic(sem_frames, snap):
    # exact: the culled points and unlinked observations; points are
    # planted behind the back wall inside its observed surface voxels
    scene, frames = sem_frames
    m = snap["map"]
    depth, sem, T_wc = frames[0]
    K = jnp.asarray(np.asarray(scene.cam.K, np.float32))
    det = rman.detect_planes_from_depth(
        jnp.asarray(depth), jnp.asarray(sem),
        rlie.se3_inverse(jnp.asarray(T_wc)), K, jax.random.PRNGKey(0),
        dist_thresh=0.04)
    sg = rman.associate_and_update(
        rstate.empty_scenegraph(tp.slice_config(scene).capacity, 64),
        *det[:6], jnp.asarray(0, jnp.int32), det_quadric=det[6],
        det_vox=det[7])
    sg = sg._replace(pl_votes=sg.pl_votes.at[:, 1].add(5.0))
    rng = np.random.default_rng(4)
    behind = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40),
                       rng.uniform(7.3, 8.0, 40)], -1).astype(np.float32)
    m = m._replace(pt_pos=m.pt_pos.at[:40].set(jnp.asarray(behind)))
    T_cw = m.kf_pose[0]
    r = rman.refine_points_semantic(m, sg, T_cw)
    p = pman.refine_points_semantic(tp.port_map(m), port_state(sg),
                                    _t(_np(T_cw)))
    for f in ("pt_valid", "pt_freed_seq", "kf_obs_pt"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      _np(getattr(r, f)), err_msg=f)
    assert (~_np(r.pt_valid)[:40]).sum() > 0


# ---------------------------------------------------- factors and scene-graph BA


@pytest.mark.parametrize("name", ["plane_kf", "plane_quadric", "room_2wall",
                                  "room_4wall", "door_room"])
def test_factor_linearization(name):
    # whitened residuals and Jacobians (forward-mode AD in both) within
    # 1e-5; the Gij residual is the square root of pi^T G pi, a
    # cancellation near zero for points on the plane, so float32 sums in
    # another order leave it within 1e-4 relative only
    rtol = 1e-4 if name == "plane_quadric" else 0.0
    sg = synthetic_state()
    poses = _np(rlie.se3_exp(jnp.asarray(
        np.random.default_rng(5).normal(size=(2, 6)) * 0.1, jnp.float32)))
    n = int(sg.n_obs)
    idx = np.stack([_np(sg.ob_kf)[:n], _np(sg.ob_plane)[:n]], 1)
    spec = {
        "plane_kf": (("kf", "plane"), idx, {"pi_obs": _np(sg.ob_coeffs)[:n]}),
        "plane_quadric": (("kf", "plane"), idx,
                          {"G": _np(sg.ob_quadric)[:n]}),
        "room_2wall": (("room", "plane", "plane"),
                       np.array([[1, 2, 3]], np.int32), {}),
        "room_4wall": (("room", "plane", "plane", "plane", "plane"),
                       np.array([[0, 2, 3, 4, 5]], np.int32), {}),
        "door_room": (("door", "room"), np.array([[0, 0]], np.int32),
                      {"rel": np.array([[2.3, 0.1, 1.0]], np.float32)}),
    }[name]
    fams, idx, const = spec
    m = idx.shape[0]
    values = {"kf": poses, "plane": _np(sg.pl_coeffs),
              "room": _np(sg.room_center), "door": _np(sg.door_pose)}
    info = np.linspace(0.5, 2.0, m).astype(np.float32)
    ref_fams = {"kf": rgraph.se3_family(jnp.asarray(values["kf"])),
                "plane": rgraph.plane_family(jnp.asarray(values["plane"])),
                "room": rgraph.point_family(jnp.asarray(values["room"])),
                "door": rgraph.se3_family(jnp.asarray(values["door"]))}
    port_fams = {"kf": pgraph.se3_family(_t(values["kf"])),
                 "plane": pgraph.plane_family(_t(values["plane"])),
                 "room": pgraph.point_family(_t(values["room"])),
                 "door": pgraph.se3_family(_t(values["door"]))}
    res_dim = 1 if name == "plane_quadric" else 3
    rb = rgraph.FactorBatch(
        families=fams, residual_fn=getattr(rfac, name), res_dim=res_dim,
        var_idx=jnp.asarray(idx), const={k: jnp.asarray(v)
                                         for k, v in const.items()},
        info=jnp.asarray(info), valid=jnp.ones(m, bool), huber=2.0)
    pb = pgraph.FactorBatch(fams, getattr(pfac, name), res_dim, _t(idx),
                            {k: _t(v) for k, v in const.items()}, _t(info),
                            torch.ones(m, dtype=torch.bool), 2.0)
    # jitted, as the reference's solves run it (eager dispatch of the
    # vmapped jacfwd costs seconds a factor type)
    r = jax.jit(rgraph.linearize_batch)(rb, ref_fams)
    p = pgraph.linearize_batch(pb, port_fams)
    np.testing.assert_allclose(p[0].numpy(), _np(r[0]), rtol=rtol, atol=1e-5)
    for pj, rj in zip(p[1], r[1]):
        np.testing.assert_allclose(pj.numpy(), _np(rj), rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(p[2].numpy(), _np(r[2]), rtol=0, atol=1e-5)


def relocate_keyframe(m, src: int, dst: int):
    """The map with keyframe slot ``src`` moved to slot ``dst``.  The
    window BA of a keyframe whose slot is among the first ten zero-count
    slots writes its own stale pose back (a duplicate in top_k's window,
    last write wins, in both packages), so the BA case uses a high slot."""
    rows = {f: getattr(m, f) for f in m._fields if f.startswith("kf_")}
    out = {}
    for f, v in rows.items():
        v = np.array(v)
        v[dst] = v[src]
        if f == "kf_valid":
            v[src] = False
        elif f == "kf_seq":
            v[src] = -1
        out[f] = jnp.asarray(v)
    return m._replace(**out)


SG_FLOAT_FIELDS = ("pl_coeffs", "pl_centroid", "pl_npts", "pl_votes",
                   "ob_coeffs", "ob_conf", "ob_quadric", "room_center",
                   "door_pose")
BA_FLOAT_FIELDS = ("kf_pose", "pt_pos", "kf_uv", "kf_depth")
KF = 20


@pytest.mark.parametrize("port_dtype", ["float32", "float64"])
def test_fast_scenegraph_ba(snap, port_dtype):
    # poses within 1e-4 and points within 1e-3 of the reference's float64
    # solve (the rule of test_torch_mapping.py: two float32 solves of this
    # ill-conditioned system differ by ~1e-3), planes and rooms within 1e-3
    cfg = snap["cfg"]
    sg_cfg = dataclasses.replace(RefSGConfig(), plane_covis_enabled=True)
    m = relocate_keyframe(snap["map"], 1, KF)
    sg = synthetic_state()
    sg = sg._replace(ob_kf=jnp.where(sg.ob_kf == 1, KF, sg.ob_kf))
    bf = np.float32(cfg.camera.bf)
    r_m = m._replace(**{f: getattr(m, f).astype(jnp.float64)
                        for f in BA_FLOAT_FIELDS})
    r_sg = sg._replace(**{f: getattr(sg, f).astype(jnp.float64)
                          for f in SG_FLOAT_FIELDS})
    r, rs, _ = rba.fast_scenegraph_ba(
        r_m, r_sg, jnp.asarray(KF, jnp.int32),
        jnp.asarray(cfg.camera.K, jnp.float64), jnp.asarray(bf, jnp.float64),
        n_window=10, iters=6, config=sg_cfg)
    dt = getattr(torch, port_dtype)
    pm = tp.port_map(m)
    pm = pm._replace(**{f: getattr(pm, f).to(dt) for f in BA_FLOAT_FIELDS})
    psg = port_state(sg)
    psg = psg._replace(**{f: getattr(psg, f).to(dt) for f in SG_FLOAT_FIELDS})
    p, ps, _ = pba.fast_scenegraph_ba(
        pm, psg, KF, tp.t(cfg.camera.K).to(dt), torch.tensor(bf, dtype=dt),
        n_window=10, iters=6, config=tp.port_config(dataclasses.replace(
            cfg, scenegraph=sg_cfg)).scenegraph)
    np.testing.assert_allclose(p.kf_pose.numpy(), _np(r.kf_pose), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(p.pt_pos.numpy(), _np(r.pt_pos), rtol=0,
                               atol=1e-3)
    for f in ("pl_coeffs", "room_center", "door_pose"):
        np.testing.assert_allclose(getattr(ps, f).numpy(), _np(getattr(rs, f)),
                                   rtol=0, atol=1e-3, err_msg=f)
    # the solve moved the keyframe and the observed planes
    assert np.abs(_np(r.kf_pose) - _np(m.kf_pose)).max() > 1e-6
    assert np.abs(_np(rs.pl_coeffs) - _np(sg.pl_coeffs)).max() > 1e-6


@pytest.mark.parametrize("port_dtype", ["float32", "float64"])
def test_scenegraph_local_ba(snap, port_dtype):
    # the recovery keyframe's joint BA on the LM engine (point-on-plane
    # factors on too), 6 iterations: the rule of test_fast_scenegraph_ba
    # against the reference's float64 solve, and the same plane
    # observations erased by the chi2 gate
    cfg = snap["cfg"]
    sg_cfg = dataclasses.replace(RefSGConfig(), plane_map_point_factor=True)
    m = relocate_keyframe(snap["map"], 1, KF)
    sg = synthetic_state()
    sg = sg._replace(ob_kf=jnp.where(sg.ob_kf == 1, KF, sg.ob_kf))
    bf = np.float32(cfg.camera.bf)
    r_m = m._replace(**{f: getattr(m, f).astype(jnp.float64)
                        for f in BA_FLOAT_FIELDS})
    r_sg = sg._replace(**{f: getattr(sg, f).astype(jnp.float64)
                          for f in SG_FLOAT_FIELDS})
    r, rs, r_cost = rjoint.scenegraph_local_ba(
        r_m, r_sg, jnp.asarray(KF, jnp.int32),
        jnp.asarray(cfg.camera.K, jnp.float64), jnp.asarray(bf, jnp.float64),
        n_window=10, iters=6, config=sg_cfg)
    dt = getattr(torch, port_dtype)
    pm = tp.port_map(m)
    pm = pm._replace(**{f: getattr(pm, f).to(dt) for f in BA_FLOAT_FIELDS})
    psg = port_state(sg)
    psg = psg._replace(**{f: getattr(psg, f).to(dt) for f in SG_FLOAT_FIELDS})
    p, ps, p_cost = pjoint.scenegraph_local_ba(
        pm, psg, KF, tp.t(cfg.camera.K).to(dt), torch.tensor(bf, dtype=dt),
        n_window=10, iters=6, config=tp.port_config(dataclasses.replace(
            cfg, scenegraph=sg_cfg)).scenegraph)
    np.testing.assert_allclose(p.kf_pose.numpy(), _np(r.kf_pose), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(p.pt_pos.numpy(), _np(r.pt_pos), rtol=0,
                               atol=1e-3)
    for f in ("pl_coeffs", "room_center"):
        np.testing.assert_allclose(getattr(ps, f).numpy(), _np(getattr(rs, f)),
                                   rtol=0, atol=1e-3, err_msg=f)
    # the door-room factor holds a door's position only: its rotation sits
    # in the damped null space of the LM step, which float32 resolves to
    # ~1e-3, so at float32 the doors compare by position
    door = slice(None) if port_dtype == "float64" else slice(4, 7)
    np.testing.assert_allclose(ps.door_pose.numpy()[:, door],
                               _np(rs.door_pose)[:, door], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ps.ob_valid.numpy(), _np(rs.ob_valid))
    np.testing.assert_allclose(float(p_cost), float(r_cost), rtol=1e-3)
    assert np.abs(_np(r.kf_pose) - _np(m.kf_pose)).max() > 1e-6
    assert np.abs(_np(rs.pl_coeffs) - _np(sg.pl_coeffs)).max() > 1e-6
