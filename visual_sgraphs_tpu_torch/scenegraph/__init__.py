"""Scene graph: planes (K12-K14), rooms and the manager."""

from visual_sgraphs_tpu_torch.scenegraph.manager import (
    SceneGraphManager,
    associate_and_update,
    detect_planes_from_depth,
    detect_rooms,
    filter_semantic_planes,
    plane_covis_bonus,
    reassociate_planes,
    refine_points_semantic,
)
from visual_sgraphs_tpu_torch.scenegraph.state import (
    CEILING,
    GROUND,
    N_CLASSES,
    UNDEFINED,
    WALL,
    SceneGraphState,
    empty_scenegraph,
    plane_semantics,
)

__all__ = [
    "CEILING", "GROUND", "N_CLASSES", "UNDEFINED", "WALL",
    "SceneGraphManager", "SceneGraphState", "associate_and_update",
    "detect_planes_from_depth", "detect_rooms", "empty_scenegraph",
    "filter_semantic_planes", "plane_covis_bonus", "plane_semantics",
    "reassociate_planes", "refine_points_semantic",
]
