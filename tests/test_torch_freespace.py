"""Free-space rooms and the scene-graph BA's assembly, port against
reference on the same numpy inputs (the kernels' plain twins stand in for
K17a, K17b and K21 on the CPU):

- the reference's own free-space cases (``tests/test_freespace.py``);
- the 6-connected components on seeded grids and on a serpentine longer
  than the 48 sweeps reach (which only synchronous sweeps reproduce);
- ray carving on a rendered frame with a non-identity pose;
- the serial scene-graph slice with ``room_method="freespace"``;
- K21's twin (the generic linearisation and dense scatter of the five
  scene-graph factor types) against the reference's ``_assemble_dense``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.optim import factors as rfac
from visual_sgraphs_tpu.optim import graph as rgraph
from visual_sgraphs_tpu.optim.fast_ba import _assemble_dense as r_assemble
from visual_sgraphs_tpu.scenegraph import freespace as rfs
from visual_sgraphs_tpu.scenegraph.manager import SceneGraphManager as RefMgr
from visual_sgraphs_tpu_torch import interop, selfcheck
from visual_sgraphs_tpu_torch.optim import fast_ba
from visual_sgraphs_tpu_torch.scenegraph import freespace as pfs
from visual_sgraphs_tpu_torch.scenegraph.manager import (
    SceneGraphManager as PortMgr,
)
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from test_freespace import _two_room_sg
from torch_parity import KeyframeDepthReference, ReferenceHypotheses
from torch_parity import one_torch_thread  # noqa: F401

G = 32
VOX = 0.35
ROOM_FIELDS = ("room_valid", "room_walls", "room_is_corridor",
               "room_ground", "n_rooms")


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_rooms_equal(port_sg, ref_sg):
    # validity, walls, corridor flags, ground ids and count exact;
    # centres within 1e-6
    for k in ROOM_FIELDS:
        np.testing.assert_array_equal(getattr(port_sg, k).numpy(),
                                      np.asarray(getattr(ref_sg, k)), k)
    np.testing.assert_allclose(port_sg.room_center.numpy(),
                               np.asarray(ref_sg.room_center), rtol=0,
                               atol=1e-6)


def components_both(grid, origin):
    """(reference centres, validity), (port centres, validity) of a grid
    given as numpy."""
    rc, rv = rfs.freespace_cluster_centers(
        jnp.asarray(grid), jnp.asarray(origin),
        jnp.asarray(VOX, jnp.float32), G=grid.shape[0])
    pc, pv = pfs.freespace_cluster_centers(_t(grid), _t(origin), VOX)
    return (np.asarray(rc), np.asarray(rv)), (pc.numpy(), pv.numpy())


# ------------------------------------------------ the reference's cases


def test_detect_rooms_freespace_two_rooms():
    # reference test_freespace.py:82: two same-orientation rooms, room A's
    # far wall unsurveyed; cluster-seeded detection in both packages
    sg = _two_room_sg()
    sg = sg._replace(pl_valid=sg.pl_valid.at[1].set(False))
    centers = np.asarray([[2.0, 0.0, 2.0], [7.0, 0.0, 2.0],
                          [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    valid = np.asarray([True, True, False, False])
    ref = rfs.detect_rooms_freespace(sg, jnp.asarray(centers),
                                     jnp.asarray(valid), wall_dist=2.5)
    port = pfs.detect_rooms_freespace(
        interop.scenegraph_from_numpy(tp.to_np(sg)), _t(centers), _t(valid),
        wall_dist=2.5)
    assert_rooms_equal(port, ref)
    walls = port.room_walls.numpy()[port.room_valid.numpy()]
    assert [4, 5, 6, 7] in sorted(sorted(w) for w in walls.tolist())


def test_cluster_centers_two_volumes():
    # reference test_freespace.py:128: two blobs, two valid clusters
    grid = np.zeros((G, G, G), bool)
    grid[4:10, 4:10, 4:10] = True
    grid[20:28, 20:28, 20:28] = True
    origin = np.zeros(3, np.float32)
    (rc, rv), (pc, pv) = components_both(grid, origin)
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(pc, rc)
    assert pv.sum() == 2


def test_accumulate_freespace_identity_pose():
    # reference test_freespace.py:147: a wall 5 m ahead of an identity
    # camera; the grids are equal
    h, w = 120, 160
    origin = np.asarray([-4.0, -4.0, 0.0], np.float32)
    K = np.asarray([80.0, 80.0, 79.5, 59.5], np.float32)
    depth = np.full((h, w), 5.0, np.float32)
    T_cw = np.asarray(rlie.se3_identity(), np.float32)
    ref = rfs.accumulate_freespace(
        jnp.zeros((G, G, G), bool), jnp.asarray(origin),
        jnp.asarray(VOX, jnp.float32), jnp.asarray(depth),
        jnp.asarray(T_cw), jnp.asarray(K), G=G)
    port = pfs.accumulate_freespace(
        torch.zeros((G, G, G), dtype=torch.bool), _t(origin), VOX,
        _t(depth), _t(T_cw), _t(K))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert port.sum() > 50


# ------------------------------------------------ components on seeded grids


def _grid_case(name: str) -> np.ndarray:
    if name == "snake":
        return selfcheck.snake_grid(G)
    density = {"sparse": 0.22, "dense": 0.33}[name]
    return np.random.default_rng(7).uniform(size=(G, G, G)) < density


@pytest.mark.parametrize("name", ["sparse", "dense", "snake"])
def test_cluster_centers_seeded(name):
    # random grids near and above the percolation density (many small and
    # one spanning component) and the snake: centres and validity exact
    grid = _grid_case(name)
    origin = np.asarray([-5.6, -1.25, 0.4], np.float32)
    (rc, rv), (pc, pv) = components_both(grid, origin)
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(pc, rc)
    assert pv.any()


def test_snake_needs_synchronous_sweeps():
    # on the snake, in-place (Gauss-Seidel) sweeps give other components
    # than the reference's synchronous ones, so the case above can only
    # pass with Jacobi sweeps
    grid = selfcheck.snake_grid(G)
    big = G ** 3 + 1
    lab = np.where(grid, np.arange(G ** 3).reshape(G, G, G), big)
    pad = np.full((G + 2,) * 3, big)
    for _ in range(48):
        pad[1:-1, 1:-1, 1:-1] = lab
        for i, j, k in zip(*np.nonzero(grid)):  # in place, index order
            m = min(pad[i + 1 + di, j + 1 + dj, k + 1 + dk]
                    for di, dj, dk in ((0, 0, 0), (1, 0, 0), (-1, 0, 0),
                                       (0, 1, 0), (0, -1, 0), (0, 0, 1),
                                       (0, 0, -1)))
            pad[i + 1, j + 1, k + 1] = m
        lab = pad[1:-1, 1:-1, 1:-1].copy()
    gs_sizes = np.sort(np.bincount(lab[grid]))[::-1][:4]
    _, _, sizes, _, _ = pfs.freespace_components_torch(
        _t(grid), torch.zeros(3), VOX)
    assert not np.array_equal(gs_sizes, sizes.numpy()), (gs_sizes, sizes)


# ------------------------------------------------ carving a rendered frame


@pytest.mark.parametrize("frame", [5, 11])
def test_accumulate_freespace_rendered_frame(frame):
    # a 240x320 reference frame at its (non-identity) pose, carved into an
    # empty grid and into one carved from frame 0: grids exact
    _, frames = tp.semantic_frames(12)
    K = np.asarray(tp.SyntheticScene(h=tp.H, w=tp.W).cam.K, np.float32)

    def pose(i):
        return np.asarray(rlie.se3_inverse(jnp.asarray(frames[i][3])),
                          np.float32)

    origin = (frames[0][3][4:7] - 0.5 * G * VOX).astype(np.float32)
    assert np.abs(pose(frame)[1:4]).max() > 1e-3
    for prior in (np.zeros((G, G, G), bool), None):
        if prior is None:
            prior = np.asarray(rfs.accumulate_freespace(
                jnp.zeros((G, G, G), bool), jnp.asarray(origin),
                jnp.asarray(VOX, jnp.float32), jnp.asarray(frames[0][1]),
                jnp.asarray(pose(0)), jnp.asarray(K), G=G))
        ref = rfs.accumulate_freespace(
            jnp.asarray(prior), jnp.asarray(origin),
            jnp.asarray(VOX, jnp.float32), jnp.asarray(frames[frame][1]),
            jnp.asarray(pose(frame)), jnp.asarray(K), G=G)
        port = pfs.accumulate_freespace(
            _t(prior), _t(origin), VOX, _t(frames[frame][1]),
            _t(pose(frame)), _t(K))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        assert port.sum() > prior.sum()


# ------------------------------------------------ the free-space slice


N_FRAMES = 12


@pytest.fixture(scope="module")
def runs():
    # the serial scene-graph slice with free-space rooms, clustering at
    # every second keyframe (an instance attribute in both packages)
    scene, frames = tp.semantic_frames(N_FRAMES)
    cfg = tp.slice_config(scene)
    cfg = dataclasses.replace(cfg, scenegraph=dataclasses.replace(
        cfg.scenegraph, plane_covis_enabled=True, refine_map_points=True,
        room_method="freespace"))
    ref = KeyframeDepthReference(cfg)
    ref.scenegraph = RefMgr(cfg.scenegraph, cfg.capacity)
    pcfg = tp.port_config(cfg)
    port = PortSystem(pcfg, device="cpu")
    port.scenegraph = PortMgr(pcfg.scenegraph, pcfg.capacity, device="cpu",
                              hypotheses=ReferenceHypotheses())
    ref.scenegraph.maintenance_interval = 2
    port.scenegraph.maintenance_interval = 2
    clusterings = []
    infer = port.scenegraph.infer_rooms_freespace

    def spy():
        clusterings.append(int(port.scenegraph._free_grid.sum()))
        infer()

    port.scenegraph.infer_rooms_freespace = spy
    for g, d, s, _, ts in frames:
        ref.scenegraph.provide_semantics(ts, s)
        ref.track_rgbd(g, d, ts)
        port.scenegraph.provide_semantics(ts, s)
        port.track_rgbd(g, d, ts)
    return ref, port, clusterings


def test_freespace_slice_grid_and_rooms(runs):
    ref, port, clusterings = runs
    assert clusterings and clusterings[0] > 0
    grid, origin = interop.freespace_to_numpy(port.scenegraph)
    np.testing.assert_array_equal(grid, np.asarray(ref.scenegraph._free_grid))
    np.testing.assert_allclose(origin, np.asarray(ref.scenegraph._free_origin),
                               rtol=0, atol=1e-5)
    assert_rooms_equal(port.scenegraph.state, ref.scenegraph.state)


def test_freespace_slice_positions(runs):
    ref, port, _ = runs
    r, p = ref.positions(), port.positions()
    assert p.shape == r.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(p, r, rtol=0, atol=0.01)
    assert port.tracked_mask().all()
    assert int(port.map.n_kf) == int(ref.map.n_kf) >= 2


# ------------------------------------------------ K21's twin


@jax.jit
def _reference_assemble(J: dict):
    """The reference's ``_assemble_dense`` over the five factor batches of
    the operands ``J`` (built inside the traced function, so the family
    order, and the layout of H with it, is the reference's own)."""
    h = fast_ba.SG_HUBER
    batches = [
        rgraph.FactorBatch(families=("kf", "plane"),
                           residual_fn=rfac.plane_kf, res_dim=3,
                           var_idx=J["ob_idx"],
                           const={"pi_obs": J["ob_coeffs"]},
                           info=J["ob_info"], valid=J["ob_valid"],
                           huber=h[0]),
        rgraph.FactorBatch(families=("kf", "plane"),
                           residual_fn=rfac.plane_quadric, res_dim=1,
                           var_idx=J["ob_idx"], const={"G": J["ob_quadric"]},
                           info=J["quad_info"], valid=J["quad_valid"],
                           huber=h[1]),
        rgraph.FactorBatch(families=("room",) + ("plane",) * 4,
                           residual_fn=rfac.room_4wall, res_dim=3,
                           var_idx=J["room_idx"], const={},
                           info=J["room_info"], valid=J["room4_valid"],
                           huber=h[2]),
        rgraph.FactorBatch(families=("room", "plane", "plane"),
                           residual_fn=rfac.room_2wall, res_dim=3,
                           var_idx=J["room_idx"][:, :3], const={},
                           info=J["room_info"], valid=J["room2_valid"],
                           huber=h[3]),
        rgraph.FactorBatch(families=("door", "room"),
                           residual_fn=rfac.door_room, res_dim=3,
                           var_idx=J["door_idx"], const={"rel": J["door_rel"]},
                           info=J["door_info"], valid=J["door_valid"],
                           huber=h[4]),
    ]
    values = {"kf": J["poses"], "plane": J["planes"], "room": J["rooms"],
              "door": J["doors"]}
    problem = rgraph.GraphProblem(
        families={"kf": rgraph.se3_family(values["kf"]),
                  "plane": rgraph.plane_family(values["plane"]),
                  "room": rgraph.point_family(values["room"]),
                  "door": rgraph.se3_family(values["door"])},
        factors=batches)
    return r_assemble(problem, values)


LIVE = ("ob_valid", "quad_valid", "room4_valid", "room2_valid",
        "door_valid")


@pytest.mark.parametrize("case", ["float64", "float32", "float32-quadric"])
def test_sg_assemble_twin_matches_reference(case):
    # seeded operands (L = 4, P = 12, R = 8, Dn = 4, Q = 96) with live
    # items of all five types, both packages in one dtype: H and g within
    # 1e-5 of the largest entry.  In float32 the Gij quadric's
    # sqrt(pi^T G pi) cancels (G ~ |p|^2 ~ 10, pi^T G pi ~ 1e-4), so each
    # package's float32 H is ~1e-3 off its float64 one in another way:
    # the float32 case holds the other four types to 1e-5 and
    # "float32-quadric" the quadric alone to 2e-3
    d = selfcheck.sg_assemble_inputs(seed=1, L=4, P=12, R=8, Dn=4, Q=96)
    assert all(d[k].sum() > 0 for k in LIVE)
    dtype = np.float64 if case == "float64" else np.float32
    tol = 2e-3 if case == "float32-quadric" else 1e-5
    if case == "float32":
        d["quad_valid"] = np.zeros_like(d["quad_valid"])
    elif case == "float32-quadric":
        for k in LIVE:
            if k != "quad_valid":
                d[k] = np.zeros_like(d[k])
    d = {k: v.astype(dtype) if v.dtype.kind == "f" else v
         for k, v in d.items()}
    rH, rg = (np.asarray(x) for x in _reference_assemble(
        {k: jnp.asarray(v) for k, v in d.items()}))
    pH, pg = fast_ba.sg_assemble(*selfcheck.sg_assemble_operands(
        d, "cpu", getattr(torch, np.dtype(dtype).name)))
    assert pH.dtype == getattr(torch, np.dtype(dtype).name)
    np.testing.assert_allclose(pH.numpy(), rH, rtol=0,
                               atol=tol * np.abs(rH).max())
    np.testing.assert_allclose(pg.numpy(), rg, rtol=0,
                               atol=tol * np.abs(rg).max())


def test_freespace_grid_interop_round_trip(runs):
    # the reference manager's grid and origin handed to a fresh port
    # manager (a mid-stream start) and read back unchanged; clustering it
    # gives the reference's centres
    ref, port, _ = runs
    grid = np.asarray(ref.scenegraph._free_grid)
    origin = np.asarray(ref.scenegraph._free_origin)
    mgr = PortMgr(port.scenegraph.cfg, device="cpu")
    assert interop.freespace_to_numpy(mgr) == (None, None)
    interop.freespace_from_numpy(mgr, grid, origin)
    g, o = interop.freespace_to_numpy(mgr)
    np.testing.assert_array_equal(g, grid)
    np.testing.assert_array_equal(o, origin)
    (rc, rv), (pc, pv) = components_both(grid, origin)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pv, rv)
