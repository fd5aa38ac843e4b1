"""Carry configuration and state between the JAX package and the port.

Everything crosses as numpy: a reference ``MapState`` /
``SceneGraphState`` / ``FrameObs`` / ``TrackResult`` / ``PlaceDB`` becomes
``{field: np.asarray(value)}`` (``m._asdict()``), and the port's tuples
load from and dump to such dicts, field for field with the port's
canonical dtypes.  A vocabulary crosses as ``{"centers": [per-level
(K**(l+1), 32) uint8], "idf": (W,) float32}`` (or through the reference's
``save_vocab`` file, ``place.vocab.load_vocab``): a tree the reference
trained is the port's "weights", so both compute with the same words.  A
reference ``SystemConfig`` crosses as ``dataclasses.asdict``.  The
inertial state crosses the same way: a ``Preintegrated`` field for field,
an ``ImuKfState`` with its ``preint`` as a nested dict, and an
``ImuPipeline``'s state as the reference's ``export_state`` dict with
those nested (``imu_pipeline_state_from_numpy``).  This module imports
neither package's JAX side.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from visual_sgraphs_tpu_torch import config as cfg_mod
from visual_sgraphs_tpu_torch.inertial.preintegration import (
    Preintegrated,
    pack,
    unpack,
)
from visual_sgraphs_tpu_torch.inertial.vi_ba import ImuKfState
from visual_sgraphs_tpu_torch.place.database import PlaceDB
from visual_sgraphs_tpu_torch.place.vocab import VocabTree, tree_from_numpy
from visual_sgraphs_tpu_torch.scenegraph.state import (
    SceneGraphState,
    empty_scenegraph,
)
from visual_sgraphs_tpu_torch.slam.frame import FrameObs
from visual_sgraphs_tpu_torch.slam.map_state import MapState, empty_map
from visual_sgraphs_tpu_torch.slam.tracking import TrackResult


@functools.lru_cache(maxsize=None)
def _map_dtypes() -> dict:
    tiny = empty_map(cfg_mod.CapacityConfig(max_keyframes=1, max_points=1,
                                            max_retired=1),
                     cfg_mod.OrbConfig(n_features=1))
    return {k: v.dtype for k, v in tiny._asdict().items()}


@functools.lru_cache(maxsize=None)
def _scenegraph_dtypes() -> dict:
    tiny = empty_scenegraph(cfg_mod.CapacityConfig(
        max_planes=1, max_rooms=1, max_doors=1, max_markers=1,
        plane_vox_slots=1), max_obs=1)
    return {k: v.dtype for k, v in tiny._asdict().items()}


_FRAME_DTYPES = dict(uv=torch.float32, depth=torch.float32,
                     level=torch.int32, angle=torch.float32,
                     desc=torch.uint8, valid=torch.bool,
                     timestamp=torch.float32)
_TRACK_DTYPES = dict(pose=torch.float32, slot_pt=torch.int32,
                     vis_pt=torch.int32, n_matches=torch.int32,
                     n_inliers=torch.int32, n_local_pts=torch.int32)


def _load(cls, dtypes: dict, d: dict, device):
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{
        k: torch.from_numpy(np.array(d[k])).to(device=device,
                                                dtype=dtypes[k])
        for k in cls._fields
    })


def to_numpy(nt) -> dict:
    """Any of the port's state tuples -> {field: np.ndarray}."""
    return {k: v.detach().cpu().numpy() for k, v in nt._asdict().items()}


def map_from_numpy(d: dict, device=None) -> MapState:
    return _load(MapState, _map_dtypes(), d, device)


def map_to_numpy(m: MapState) -> dict:
    return to_numpy(m)


def scenegraph_from_numpy(d: dict, device=None) -> SceneGraphState:
    """A reference ``SceneGraphState`` (as numpy) in the port's dtypes."""
    return _load(SceneGraphState, _scenegraph_dtypes(), d, device)


def scenegraph_to_numpy(sg: SceneGraphState) -> dict:
    return to_numpy(sg)


def freespace_from_numpy(manager, grid, origin) -> None:
    """Give a ``SceneGraphManager`` a free-space grid ((G, G, G) bool) and
    origin ((3,) float32) as numpy, e.g. the reference manager's
    ``_free_grid`` / ``_free_origin`` for a mid-stream start."""
    dev = manager.device
    manager._free_grid = torch.from_numpy(
        np.array(grid, dtype=bool)).to(dev)
    manager._free_origin = torch.from_numpy(
        np.array(origin, dtype=np.float32)).to(dev)


def freespace_to_numpy(manager) -> tuple:
    """(grid, origin) of a manager's free-space grid as numpy, or (None,
    None) before its first keyframe."""
    if manager._free_grid is None:
        return None, None
    return (manager._free_grid.cpu().numpy(),
            manager._free_origin.cpu().numpy())


def frame_from_numpy(d: dict, device=None) -> FrameObs:
    return _load(FrameObs, _FRAME_DTYPES, d, device)


def frame_to_numpy(f: FrameObs) -> dict:
    return to_numpy(f)


def track_from_numpy(d: dict, device=None) -> TrackResult:
    return _load(TrackResult, _TRACK_DTYPES, d, device)


def track_to_numpy(r: TrackResult) -> dict:
    return to_numpy(r)


_PLACEDB_DTYPES = dict(bow=torch.float32, has_word=torch.bool,
                       valid=torch.bool)


def placedb_from_numpy(d: dict, device=None) -> PlaceDB:
    return _load(PlaceDB, _PLACEDB_DTYPES, d, device)


def placedb_to_numpy(db: PlaceDB) -> dict:
    return to_numpy(db)


def vocab_from_numpy(d: dict, device=None) -> VocabTree:
    """A vocabulary tree from {"centers": [...], "idf": ...}."""
    return tree_from_numpy(d["centers"], d["idf"], device=device)


def vocab_to_numpy(tree: VocabTree) -> dict:
    return {"centers": [c.cpu().numpy() for c in tree.centers],
            "idf": tree.idf.cpu().numpy()}


def preint_from_numpy(d: dict, device=None) -> Preintegrated:
    """A reference ``Preintegrated`` (as numpy, any leading batch shape):
    views of one packed float32 table, as the port keeps them."""
    fields = _load(Preintegrated, {k: torch.float32
                                   for k in Preintegrated._fields}, d,
                   device)
    return unpack(pack(fields).contiguous())


def preint_to_numpy(p: Preintegrated) -> dict:
    return to_numpy(p)


def imu_state_from_numpy(d: dict, device=None) -> ImuKfState:
    """A reference ``ImuKfState`` with ``preint`` as a nested dict."""
    f = lambda k, dt: torch.from_numpy(np.array(d[k])).to(  # noqa: E731
        device=device, dtype=dt)
    return ImuKfState(vel=f("vel", torch.float32),
                      bias_g=f("bias_g", torch.float32),
                      bias_a=f("bias_a", torch.float32),
                      preint=preint_from_numpy(d["preint"], device),
                      preint_valid=f("preint_valid", torch.bool))


def imu_state_to_numpy(s: ImuKfState) -> dict:
    out = {k: v.detach().cpu().numpy() for k, v in s._asdict().items()
           if k != "preint"}
    out["preint"] = preint_to_numpy(s.preint)
    return out


def imu_pipeline_state_from_numpy(d: dict, device=None) -> dict:
    """The reference ``ImuPipeline.export_state()`` dict (numpy leaves,
    ``state`` / ``since_kf`` nested) -> the port's ``import_state``
    argument."""
    t = lambda k: torch.from_numpy(np.array(d[k], np.float32)).to(  # noqa
        device)
    return {"state": imu_state_from_numpy(d["state"], device),
            "since_kf": preint_from_numpy(d["since_kf"], device),
            "vel": t("vel"), "bias_g": t("bias_g"), "bias_a": t("bias_a"),
            "initialized": bool(np.asarray(d["initialized"])),
            "scale": float(np.asarray(d["scale"])),
            "last_t": float(np.asarray(d["last_t"])), "q_wg": t("q_wg")}


def imu_pipeline_state_to_numpy(tree: dict) -> dict:
    """The port's ``ImuPipeline.export_state()`` as numpy (the inverse of
    ``imu_pipeline_state_from_numpy``)."""
    c = lambda x: x.detach().cpu().numpy()  # noqa: E731
    return {"state": imu_state_to_numpy(tree["state"]),
            "since_kf": preint_to_numpy(tree["since_kf"]),
            "vel": c(tree["vel"]), "bias_g": c(tree["bias_g"]),
            "bias_a": c(tree["bias_a"]),
            "initialized": np.asarray(tree["initialized"]),
            "scale": np.asarray(tree["scale"], np.float32),
            "last_t": np.asarray(tree["last_t"], np.float64),
            "q_wg": c(tree["q_wg"])}


_NESTED_TUPLES = {("EnvDatabase", "rooms"): cfg_mod.EnvRoom,
                  ("EnvDatabase", "doors"): cfg_mod.EnvDoor}


def _build(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        item_cls = _NESTED_TUPLES.get((cls.__name__, f.name))
        if item_cls is not None:
            v = tuple(_build(item_cls, x) for x in v)
        elif isinstance(v, dict) and dataclasses.is_dataclass(f.default):
            v = _build(type(f.default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_dict(d: dict) -> cfg_mod.SystemConfig:
    """SystemConfig from ``dataclasses.asdict`` of the reference config."""
    return _build(cfg_mod.SystemConfig, d)
