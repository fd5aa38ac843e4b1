"""The scene graph's room pair analysis (K23) and plane association (K24),
port against reference on the same seeded numpy inputs: the kernels' plain
twins stand in on the CPU.  The cases come from
``visual_sgraphs_tpu_torch.selfcheck.room_cases`` / ``assoc_cases``, which
``chip_smoke.py`` also runs through the kernels on the card:

- rooms (walls): equal supports (tie order), a corridor on wall 0 (its -1
  walls' scatter leaves wall 0 free), a full room table, a match by 1.5 m
  against one by two shared walls;
- rooms (free space): an invalid cluster, two clusters competing for one
  wall pair;
- association: one plane detected twice in one call, a full plane table,
  a full observation table, an arg-min tie, two detections of one table
  plane.

Tolerances: room walls, flags, ground ids, n_rooms, plane ids, n_planes,
n_obs, ob_plane, ob_kf, pl_nobs and pl_vox exact; room centres within
1e-6 m; plane coefficients, centroids and the other float fields within
1e-5 (``test_torch_scenegraph.py::test_associate_and_update``'s bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.scenegraph import freespace as rfs
from visual_sgraphs_tpu.scenegraph import manager as rman
from visual_sgraphs_tpu.scenegraph import state as rstate
from visual_sgraphs_tpu_torch import selfcheck
from visual_sgraphs_tpu_torch.scenegraph import freespace as pfs
from visual_sgraphs_tpu_torch.scenegraph import manager as pman

from torch_parity import one_torch_thread  # noqa: F401

ROOM_CASES = {c["name"]: c for c in selfcheck.room_cases()}
ASSOC_CASES = {c["name"]: c for c in selfcheck.assoc_cases()}
# what each case must produce, so that it exercises its hazard
N_ROOMS = {"support_ties": 2, "corridor_wall0": 2, "full_table": 16,
           "match_distance_vs_walls": 4, "fs_invalid_cluster": 1,
           "fs_compete": 2}
NEW_OBS = {"same_plane_twice": 3, "full_planes": 2, "full_obs": 0,
           "argmin_tie": 4, "two_on_one": 4}


def ref_state(d: dict):
    return rstate.SceneGraphState(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_fields(port, ref, ints, floats, atol):
    for k in ints:
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    for k in floats:
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(ROOM_CASES))
def test_detect_rooms(name):
    case = ROOM_CASES[name]
    d = case["sg"]
    port_sg = selfcheck._state(d, "cpu")
    if case["kind"] == "walls":
        ref = rman.detect_rooms(ref_state(d))
        port = pman.detect_rooms(port_sg)
    else:
        ref = rfs.detect_rooms_freespace(
            ref_state(d), jnp.asarray(case["centers"]),
            jnp.asarray(case["valid"]), wall_dist=case["wall_dist"])
        port = pfs.detect_rooms_freespace(
            port_sg, torch.from_numpy(case["centers"]),
            torch.from_numpy(case["valid"]), wall_dist=case["wall_dist"])
    assert_fields(port, ref, selfcheck.ROOM_INT_FIELDS, ("room_center",),
                  1e-6)
    assert int(port.n_rooms) == N_ROOMS[name]


@pytest.mark.parametrize("name", list(ASSOC_CASES))
def test_associate_and_update_cases(name):
    case = ASSOC_CASES[name]
    det = case["det"]
    keys = ("coeffs", "valid", "centroid", "npts", "votes", "local")
    ref = rman.associate_and_update(
        ref_state(case["sg"]), *(jnp.asarray(det[k]) for k in keys),
        jnp.asarray(case["kf"], jnp.int32),
        det_quadric=jnp.asarray(det["quadric"]),
        det_vox=jnp.asarray(det["vox"]))
    sg, dets, kf = selfcheck.assoc_operands(case, "cpu")
    port = pman.associate_and_update(sg, *dets[:6], kf, det_quadric=dets[6],
                                     det_vox=dets[7])
    assert_fields(port, ref, selfcheck.ASSOC_INT_FIELDS,
                  selfcheck.ASSOC_FLOAT_FIELDS, 1e-5)
    assert int(port.n_obs - sg.n_obs) == NEW_OBS[name]
