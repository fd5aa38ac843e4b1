"""Keyframe place-recognition database (the KeyFrameDatabase replacement)
and its query (kernel K11).

Port of ``visual_sgraphs_tpu/place/database.py``: a dense (Kmax, W)
float32 BoW table with word occupancy and slot validity; a query is one
L1-overlap reduction ``score(q, k) = sum_w min(q_w, bow[k, w])`` over all
keyframes, gated by the shared-word count (DetectNBestCandidates).

``place_query`` runs the whole query of the keyframe program (candidate
scores and common-word counts of every row, the validity / exclusion
masks, the ``min_common_ratio`` gate, the top-n with lax.top_k's lower-
index-first tie order and the best covisible score) as the hand kernel in
``csrc/bow.cu`` on CUDA tensors, and as the plain twin
``place_query_torch`` (built from the functions below) on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.slam.tracking import topk_stable


class PlaceDB(NamedTuple):
    bow: torch.Tensor  # (Kmax, W) float32 L1-normalised tf-idf
    has_word: torch.Tensor  # (Kmax, W) bool occupancy
    valid: torch.Tensor  # (Kmax,) bool


def empty_db(max_keyframes: int, n_words: int, device=None) -> PlaceDB:
    return PlaceDB(
        bow=torch.zeros((max_keyframes, n_words), dtype=torch.float32,
                        device=device),
        has_word=torch.zeros((max_keyframes, n_words), dtype=torch.bool,
                             device=device),
        valid=torch.zeros((max_keyframes,), dtype=torch.bool, device=device))


def add_keyframe(db: PlaceDB, kf_id: int, bow: torch.Tensor) -> PlaceDB:
    """Write keyframe ``kf_id``'s row (the BoW tables in place: the
    database belongs to one LoopCloser; the validity by a compare, since
    writing a Python scalar into a CUDA tensor synchronises)."""
    db.bow[kf_id] = bow
    db.has_word[kf_id] = bow > 0
    slot = torch.arange(db.valid.shape[0], device=db.valid.device) == kf_id
    return db._replace(valid=db.valid | slot)


def build_db(bows: torch.Tensor, valid: torch.Tensor) -> PlaceDB:
    """Whole-database (re)build from stacked (Kmax, W) rows."""
    bows = torch.where(valid[:, None], bows, 0.0)
    return PlaceDB(bow=bows, has_word=bows > 0, valid=valid.clone())


def l1_scores(db: PlaceDB, query_bow: torch.Tensor) -> torch.Tensor:
    """(Kmax,) L1 similarity sum_w min(q, v) of every valid row."""
    s = torch.sum(torch.minimum(db.bow, query_bow[None, :]), dim=1)
    return torch.where(db.valid, s, 0.0)


def detect_candidates(db: PlaceDB, query_bow: torch.Tensor,
                      exclude: torch.Tensor, min_common_ratio: float = 0.8,
                      top_n: int = 3):
    """(ids (top_n,), scores (top_n,)): rows sharing at least
    ``min_common_ratio`` x the most shared words (and one), not excluded,
    by L1 score; empty slots are id -1."""
    q_words = query_bow > 0
    common = torch.sum(db.has_word & q_words[None, :], dim=1,
                       dtype=torch.int32)
    common = torch.where(db.valid & ~exclude, common, 0)
    max_common = torch.max(common)
    # the reference multiplies in float32 and truncates to int32
    thr = (max_common.to(torch.float32) * min_common_ratio).to(torch.int32)
    ok = common >= torch.clamp(thr, min=1)
    scores = torch.where(ok, l1_scores(db, query_bow), 0.0)
    top_scores, top_ids = topk_stable(scores, top_n)
    return torch.where(top_scores > 0, top_ids, -1).to(torch.int32), \
        top_scores


def best_covisible_score(db: PlaceDB, query_bow: torch.Tensor,
                         covis: torch.Tensor) -> torch.Tensor:
    """The best BoW score within the query's covisible neighbourhood."""
    return torch.max(torch.where(covis, l1_scores(db, query_bow), 0.0))


def place_query_torch(db: PlaceDB, query_bow: torch.Tensor,
                      exclude: torch.Tensor, covis: torch.Tensor,
                      min_common_ratio: float = 0.8,
                      top_n: int = 3) -> torch.Tensor:
    """Plain twin of K11: packed (2 top_n + 2,) float32 [best covisible
    score, candidate ids, candidate scores, valid rows]."""
    if query_bow.is_cuda:
        place_query_torch.cuda_calls += 1
    ids, scores = detect_candidates(db, query_bow, exclude,
                                    min_common_ratio, top_n)
    ref = best_covisible_score(db, query_bow, covis)
    return torch.cat([ref[None], ids.to(torch.float32), scores,
                      db.valid.sum(dtype=torch.int32)[None].to(
                          torch.float32)])


place_query_torch.cuda_calls = 0


def place_query(db: PlaceDB, query_bow: torch.Tensor, exclude: torch.Tensor,
                covis: torch.Tensor, min_common_ratio: float = 0.8,
                top_n: int = 3) -> torch.Tensor:
    """Database query (kernel K11 on CUDA tensors, the twin on CPU); the
    packed layout of ``place_query_torch``."""
    if query_bow.device.type == "cpu":
        return place_query_torch(db, query_bow, exclude, covis,
                                 min_common_ratio, top_n)
    cuda.require_cuda("place_query", db.bow, db.has_word, db.valid,
                      query_bow, exclude, covis)
    if db.bow.dtype != torch.float32 or query_bow.dtype != torch.float32:
        raise ValueError("place_query: float32 BoW rows")
    if not 1 <= top_n <= 8:
        raise ValueError("place_query: 1 <= top_n <= 8")
    K, W = db.bow.shape
    dev = db.bow.device
    scores = torch.empty((K,), dtype=torch.float32, device=dev)
    common = torch.empty((K,), dtype=torch.int32, device=dev)
    packed = torch.empty((2 * top_n + 2,), dtype=torch.float32, device=dev)
    cuda.call("vsg_place_query", cuda.ptr(db.bow), cuda.ptr(db.has_word),
              cuda.ptr(db.valid), cuda.ptr(query_bow), cuda.ptr(exclude),
              cuda.ptr(covis), K, W, float(np.float32(min_common_ratio)),
              top_n, cuda.ptr(scores), cuda.ptr(common), cuda.ptr(packed),
              cuda.stream())
    place_query.launches += 1
    return packed


place_query.launches = 0
