"""Keyframe place-recognition database (the KeyFrameDatabase replacement)
and its query (kernel K11).

Port of ``visual_sgraphs_tpu/place/database.py``: a dense (Kmax, W)
float32 BoW table with word occupancy and slot validity; a query is one
L1-overlap reduction ``score(q, k) = sum_w min(q_w, bow[k, w])`` over all
keyframes, gated by the shared-word count (DetectNBestCandidates).

``place_query`` runs a query (candidate scores and common-word counts of
every row, the validity / exclusion masks, the ``min_common_ratio`` gate,
the top-n with lax.top_k's lower-index-first tie order, the best
covisible score and the valid count) and ``place_query_insert`` the
keyframe program's whole database step (the validity synced with the
map's keyframes, that query, then the keyframe's row inserted, and the
packed vector with the caller's extra scalars), each as one launch of
the hand kernel in ``csrc/bow.cu`` on CUDA tensors (both count in
``place_query.launches``), and as the plain twins ``place_query_torch`` /
``place_query_insert_torch`` (built from the functions below) on CPU
tensors.  The insertion updates the database's tensors in place (the
database belongs to one LoopCloser), on either device.
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
    if bow.is_cuda:
        add_keyframe.cuda_calls += 1
    db.bow[kf_id] = bow
    db.has_word[kf_id] = bow > 0
    slot = torch.arange(db.valid.shape[0], device=db.valid.device) == kf_id
    return db._replace(valid=db.valid | slot)


add_keyframe.cuda_calls = 0


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


def place_query_insert_torch(db: PlaceDB, query_bow: torch.Tensor,
                             exclude: torch.Tensor, covis: torch.Tensor,
                             kf_valid: torch.Tensor, kf: int, extra=None,
                             min_common_ratio: float = 0.8,
                             top_n: int = 3):
    """Plain twin of K11's insertion entry: the database's validity ANDed
    with ``kf_valid``, the query (``place_query_torch``) on it, then row
    ``kf`` inserted (``add_keyframe``), the tables in place.  Returns (the
    database, packed (2 top_n + 2 + len(extra),) float32: the query's
    packed vector, then ``extra``, or one zero)."""
    valid = db.valid & kf_valid
    packed = place_query_torch(db._replace(valid=valid), query_bow, exclude,
                               covis, min_common_ratio, top_n)
    db.valid.copy_(add_keyframe(db._replace(valid=valid), kf,
                                query_bow).valid)
    if extra is None:
        extra = torch.zeros((1,), dtype=torch.float32,
                            device=query_bow.device)
    return db, torch.cat([packed, extra.to(torch.float32).reshape(-1)])


def _launch(db: PlaceDB, query_bow, exclude, covis, kf_valid, kf: int,
            extra, n_extra: int, min_common_ratio: float,
            top_n: int) -> torch.Tensor:
    tensors = [db.bow, db.has_word, db.valid, query_bow, exclude, covis]
    if kf_valid is not None:
        tensors.append(kf_valid)
    if extra is not None:
        tensors.append(extra)
    cuda.require_cuda("place_query", *tensors)
    if db.bow.dtype != torch.float32 or query_bow.dtype != torch.float32:
        raise ValueError("place_query: float32 BoW rows")
    masks = [db.has_word, db.valid, exclude, covis] + (
        [] if kf_valid is None else [kf_valid])
    if any(t.dtype != torch.bool for t in masks):
        raise ValueError("place_query: bool occupancy, validity and masks")
    K, W = db.bow.shape
    if not 1 <= top_n <= min(8, K) or not K <= 4096:
        raise ValueError("place_query: 1 <= top_n <= min(8, K), K <= 4096")
    q0, b0 = query_bow.data_ptr(), db.bow.data_ptr()
    if kf >= 0 and b0 - 4 * W < q0 < b0 + 4 * K * W:
        raise ValueError("place_query: the query must not alias the rows "
                         "the insertion writes")
    if extra is not None and extra.dtype != torch.int32:
        raise ValueError("place_query: int32 extra scalars")
    packed = torch.empty((2 * top_n + 2 + n_extra,), dtype=torch.float32,
                         device=db.bow.device)
    cuda.call("vsg_place_query", cuda.ptr(db.bow), cuda.ptr(db.has_word),
              cuda.ptr(db.valid), cuda.ptr(query_bow), cuda.ptr(exclude),
              cuda.ptr(covis), cuda.ptr(kf_valid), K, W,
              float(np.float32(min_common_ratio)), top_n, kf,
              cuda.ptr(extra), n_extra, cuda.ptr(packed), cuda.stream())
    place_query.launches += 1
    return packed


def place_query(db: PlaceDB, query_bow: torch.Tensor, exclude: torch.Tensor,
                covis: torch.Tensor, min_common_ratio: float = 0.8,
                top_n: int = 3) -> torch.Tensor:
    """Database query (kernel K11 on CUDA tensors, the twin on CPU); the
    packed layout of ``place_query_torch``."""
    if query_bow.device.type == "cpu":
        return place_query_torch(db, query_bow, exclude, covis,
                                 min_common_ratio, top_n)
    return _launch(db, query_bow, exclude, covis, None, -1, None, 0,
                   min_common_ratio, top_n)


place_query.launches = 0


def place_query_insert(db: PlaceDB, query_bow: torch.Tensor,
                       exclude: torch.Tensor, covis: torch.Tensor,
                       kf_valid: torch.Tensor, kf: int, extra=None,
                       min_common_ratio: float = 0.8, top_n: int = 3):
    """The keyframe program's database step (kernel K11's insertion entry
    on CUDA tensors, one launch; the twin on CPU): the outputs of
    ``place_query_insert_torch``.  ``extra``: int32 scalars packed after
    the query's (None: one zero)."""
    if query_bow.device.type == "cpu":
        return place_query_insert_torch(db, query_bow, exclude, covis,
                                        kf_valid, kf, extra,
                                        min_common_ratio, top_n)
    if not 0 <= kf < db.bow.shape[0]:
        raise ValueError("place_query_insert: kf out of range")
    n_extra = 1 if extra is None else extra.numel()
    packed = _launch(db, query_bow, exclude, covis, kf_valid, int(kf),
                     None if extra is None else extra.reshape(-1), n_extra,
                     min_common_ratio, top_n)
    return db, packed
