"""Loop closing and relocalisation (the LoopClosing thread and
Tracking::Relocalization).

Port of ``visual_sgraphs_tpu/place/loop_closer.py`` (in-map only): after
each keyframe the keyframe program queries the place database (BoW vector
K10, covisibility / recency exclusion, candidate scores and covisible
reference score K11, insertion); the host reads those scalars one keyframe
later on the keyframe board, checks temporal consistency, and dispatches
the geometric verification of a consistent candidate (NN-ratio matching
K5, Sim3 RANSAC + refinement K15, guided re-match count K16, loop drift),
whose scalars it reads one keyframe later again.  An accepted loop mines
the essential graph, solves the Sim3 pose graph (K19), corrects the map
and the scene graph, fuses the welded observations and runs the global
BA (K8), or without it the welding-window local BA.  A lost frame is relocalised against the database (K10, K11),
NN-ratio matches per candidate (K5), PnP RANSAC (K15) and the
motion-only refinement (K6).

The vocabulary is trained once, on the host, from the map's own
descriptors when ``vocab_min_keyframes`` keyframes exist (one readback per
session), unless one is supplied (``interop.vocab_from_numpy`` loads a
tree the reference trained).

Random samples: the reference draws its RANSAC samples inside its
programs from ``jax.random`` keys.  Here the host draws uniforms from a
``torch.Generator`` seeded with the same key integer, copies them pinned
and non-blocking, and the device maps them through the cumulative sum of
the valid mask (``jax.random.choice``'s inverse-CDF rule); a ``samples``
callable ``(kind, key, valid) -> indices`` replaces that, e.g. with the
reference's own draws.  ``kind`` is "sim3" ((256, 3) indices, uniform
over the valid matches) or "pnp" ((192, 6)).  ``warm_programs`` is not
ported: eager PyTorch compiles nothing, and the kernel library is built
before the first frame.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_sgraphs_tpu_torch.config import PlaceConfig
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.features.match import (
    guided_count_sim3,
    match_nn_ratio,
)
from visual_sgraphs_tpu_torch.place import database as db_mod
from visual_sgraphs_tpu_torch.place import pgo
from visual_sgraphs_tpu_torch.place import vocab as vocab_mod
from visual_sgraphs_tpu_torch.place.pnp import ransac_pnp
from visual_sgraphs_tpu_torch.place.sim3_ransac import verify_sim3
from visual_sgraphs_tpu_torch.slam import mapping
from visual_sgraphs_tpu_torch.slam.map_state import (
    MapState,
    covisibility_counts,
)

SAMPLE_SHAPES = {"sim3": (256, 3), "pnp": (192, 6)}


def inverse_cdf_samples(valid: torch.Tensor, u: torch.Tensor):
    """Indices drawn with probability proportional to ``valid`` from
    uniforms ``u`` in [0, 1): r = total * (1 - u), the first index whose
    cumulative weight reaches r (``jax.random.choice`` with ``p``)."""
    cdf = torch.cumsum(valid.to(torch.float32), 0)
    r = cdf[-1] * (1.0 - u)
    idx = torch.searchsorted(cdf, r.reshape(-1)).reshape(u.shape)
    return torch.clamp(idx, max=valid.shape[0] - 1).to(torch.int32)


def default_draw(kind: str, key: int, valid: torch.Tensor):
    """Host uniforms from a generator seeded with ``key``, mapped on the
    device (a pinned, non-blocking copy on CUDA: no sync)."""
    gen = torch.Generator().manual_seed(int(key))
    u = torch.rand(SAMPLE_SHAPES[kind], generator=gen)
    if valid.is_cuda:
        u = u.pin_memory().to(valid.device, non_blocking=True)
    return inverse_cdf_samples(valid, u)


# --------------------------------------------------------------- device ops


def _loop_geometry(m: MapState, cur: int, cand: int, draw,
                   inlier_thresh: float, cam_K, fix_scale: bool = False):
    """Geometric verification between keyframes ``cur`` and ``cand``:
    NN-ratio matches with rotation consistency (K5), both sides' points in
    their own camera frames, Sim3 RANSAC + refinement (K15) on samples
    ``draw(valid)``, and the guided re-match count under the refined Sim3
    (K16: the rows' validity, the projection and the count in one
    launch).  Returns device (S_cand_cur (8,), n_inliers, n_guided,
    n_match); ``_loop_geometry.cuda_calls`` counts the verifications on
    the card."""
    desc_a, desc_b = m.kf_desc[cur], m.kf_desc[cand]
    if desc_a.is_cuda:
        _loop_geometry.cuda_calls += 1
    obs_a, obs_b = m.kf_obs_pt[cur], m.kf_obs_pt[cand]
    va = m.kf_kp_valid[cur] & (obs_a >= 0)
    vb = m.kf_kp_valid[cand] & (obs_b >= 0)
    match, _ = match_nn_ratio(desc_a, va, desc_b, vb, ratio=0.85,
                              angle_a=m.kf_angle[cur],
                              angle_b=m.kf_angle[cand])
    ok = match >= 0
    pt_a = torch.clamp(obs_a, min=0).long()
    pt_b = torch.clamp(obs_b[torch.clamp(match, min=0).long()], min=0).long()
    ok = ok & m.pt_valid[pt_a] & m.pt_valid[pt_b]
    n_match = ok.sum(dtype=torch.int32)
    # points in each keyframe's camera frame (drift cancels locally)
    p_a = lie.se3_apply(m.kf_pose[cur], m.pt_pos[pt_a]).contiguous()
    p_b = lie.se3_apply(m.kf_pose[cand], m.pt_pos[pt_b]).contiguous()
    res = verify_sim3(p_a, p_b, ok, draw(ok), inlier_thresh, fix_scale)
    # guided re-matching: every point of ``cur`` projected into ``cand``
    # under the refined Sim3 must land near a compatible keypoint
    n_guided = guided_count_sim3(res.S_ab, p_a, obs_a, m.kf_kp_valid[cur],
                                 m.pt_valid, desc_a, m.kf_uv[cand],
                                 m.kf_kp_valid[cand], desc_b, cam_K)
    return res.S_ab, res.n_inliers, n_guided, n_match


_loop_geometry.cuda_calls = 0


def _reloc_attempt(m: MapState, frame, cand: int, cam_K, draw):
    """Relocalisation against one candidate keyframe: NN-ratio matches to
    its map points (K5), PnP RANSAC (K15) and the wide-gate refinement
    (K6).  Returns device (pose (7,), n_inliers)."""
    obs_b = m.kf_obs_pt[cand]
    vb = m.kf_kp_valid[cand] & (obs_b >= 0)
    match, _ = match_nn_ratio(frame.desc, frame.valid, m.kf_desc[cand], vb,
                              ratio=0.8)
    ok = match >= 0
    pt = torch.clamp(obs_b[torch.clamp(match, min=0).long()], min=0).long()
    ok = ok & m.pt_valid[pt]
    res = ransac_pnp(m.pt_pos[pt].contiguous(), frame.uv, ok, cam_K,
                     draw(ok))
    return res.T_cw, res.n_inliers


def _exclusion_mask(m: MapState, kf: int, min_gap: int = 10):
    """Covisible-or-recent keyframes barred from candidacy (recency in
    insertion sequence, not slot index).  Returns (exclude, covis)."""
    covis = covisibility_counts(m, kf) > 0
    recent = torch.abs(m.kf_seq - m.kf_seq[kf]) < min_gap
    return covis | recent | ~m.kf_valid, covis


def _detect_program(m: MapState, db: db_mod.PlaceDB,
                    vocab: vocab_mod.VocabTree, kf: int, min_gap: int,
                    top_n: int, extra=None):
    """The per-keyframe place query: BoW vector (K10), exclusion, then the
    database step (K11's insertion entry, one launch): validity sync,
    candidates and covisible reference score, the insertion and the
    packed vector.  Returns (database, packed (2 top_n + 3,) [ref, ids,
    scores, valid rows, extra]); ``_detect_program.cuda_calls`` counts the
    calls on the card."""
    bow = vocab_mod.bow_vector(vocab, m.kf_desc[kf], m.kf_kp_valid[kf])
    if bow.is_cuda:
        _detect_program.cuda_calls += 1
    exclude, covis = _exclusion_mask(m, kf, min_gap)
    # the query reads the rows before the insertion writes row ``kf``
    # (``kf`` is excluded from its own query, and covis[kf] is false, so
    # the reference's reading of the reference score after the insertion
    # gives the same value)
    return db_mod.place_query_insert(db, bow, exclude, covis, m.kf_valid,
                                     kf, extra, 0.8, top_n)


_detect_program.cuda_calls = 0


def _loop_drift(kf_pose, cur: int, cand: int, S_est):
    """Tangent norm of (estimated loop Sim3) - (pose-implied Sim3)."""
    S_now = lie.sim3_multiply(lie.sim3_from_se3(kf_pose[cand]),
                              lie.sim3_inverse(lie.sim3_from_se3(
                                  kf_pose[cur])))
    return torch.linalg.norm(lie.sim3_log(lie.sim3_multiply(
        S_est, lie.sim3_inverse(S_now))))


def _host_read(t):
    return t.cpu().numpy()


def reloc_in_map(m: MapState, db: db_mod.PlaceDB,
                 vocab: vocab_mod.VocabTree, frame, cam_K, min_inliers: int,
                 top_n: int = 3, seed: int = 0, draw=default_draw,
                 read=_host_read):
    """Relocalise ``frame`` in the map: candidates from the database, then
    one PnP attempt per candidate until one reaches ``min_inliers``
    (scaled with the frame's feature capacity).  ``read`` copies a device
    value to the host (the system counts those reads).  Returns (pose
    (7,), kf slot) or None."""
    min_eff = max(12, min_inliers * int(frame.valid.shape[0]) // 1000)
    bow = vocab_mod.bow_vector(vocab, frame.desc, frame.valid)
    if bow.is_cuda:
        reloc_in_map.cuda_calls += 1
    packed = db_mod.place_query(db, bow, ~m.kf_valid,
                                torch.zeros_like(m.kf_valid), 0.5, top_n)
    cand_ids = read(packed[1:1 + top_n]).astype(np.int64)
    for j, cid in enumerate(cand_ids):
        if cid < 0:
            continue
        key = seed * 131 + j
        pose, n_inl = _reloc_attempt(m, frame, int(cid), cam_K,
                                     lambda v, k=key: draw("pnp", k, v))
        if int(read(n_inl)) >= min_eff:
            return lie.se3_normalize(pose), int(cid)
    return None


reloc_in_map.cuda_calls = 0


def _consume_board(system, value: float) -> None:
    """The scalar the keyframe program packs after the detection scalars
    (the scene graph's n_obs, which the keyframe board also carries)."""
    sgm = getattr(system, "scenegraph", None)
    if sgm is not None:
        sgm.n_obs_host = int(value)


class LoopCloser:
    """Host stage: place recognition, loop correction, relocalisation."""

    def __init__(self, cfg: PlaceConfig = PlaceConfig(),
                 vocab: vocab_mod.VocabTree | None = None, samples=None):
        self.cfg = cfg
        self.vocab = vocab
        self.db: db_mod.PlaceDB | None = None
        self.samples = samples
        self._consistent_cand = -1
        self._consistent_count = 0
        self._rng = np.random.default_rng(cfg.seed)
        self.n_loops_closed = 0
        self.last_loop: tuple[int, int] | None = None
        self._kf_since_loop = 10**9  # cooldown counter
        # one-keyframe-deep pipelines: (kf_host, packed) where packed is a
        # host array (delivered on the keyframe board) or a device tensor;
        # and (kf_host, best, S_cand_cur, scalars)
        self._pending_det: tuple | None = None
        self._pending_verify: tuple | None = None

    def draw(self, kind: str, key: int, valid: torch.Tensor):
        """RANSAC samples of ``kind`` for matches ``valid``."""
        if self.samples is None:
            return default_draw(kind, key, valid)
        idx = torch.as_tensor(np.array(self.samples(kind, key, valid)))
        n_hyp, k = SAMPLE_SHAPES[kind]
        if tuple(idx.shape) != (n_hyp, k):
            raise ValueError(f"samples: expected ({n_hyp}, {k}) indices")
        return idx.to(torch.int32).to(valid.device)

    # ------------------------------------------------------------ internal

    def reset(self) -> None:
        """Fresh database and vocabulary for a new map."""
        self.vocab = None
        self.db = None
        self._consistent_cand = -1
        self._consistent_count = 0
        self._pending_det = None
        self._pending_verify = None

    def _ensure_vocab(self, system) -> bool:
        """Train the vocabulary from the map's own descriptors once enough
        keyframes exist (one counted readback), then backfill the
        database.  Returns whether the place query can run."""
        m: MapState = system.map
        if self.vocab is not None:
            if self.db is None:
                self.db = db_mod.empty_db(m.K, self.vocab.n_words,
                                          device=m.kf_pose.device)
            return True
        n_kf = system.n_kf_host
        if n_kf < self.cfg.vocab_min_keyframes:
            return False
        desc = system._read(m.kf_desc[:n_kf]).reshape(-1, 32)
        valid = system._read(m.kf_kp_valid[:n_kf]).reshape(-1)
        desc = desc[valid]
        if desc.shape[0] < 512:
            return False
        cap = self.cfg.vocab_train_max_desc
        if desc.shape[0] > cap:
            desc = desc[self._rng.choice(desc.shape[0], cap, replace=False)]
        # data-driven depth: a leaf needs several training descriptors
        levels = self.cfg.vocab_levels
        b = self.cfg.vocab_branching
        while levels > 2 and (b ** levels) * 3 > desc.shape[0]:
            levels -= 1
        self.vocab = vocab_mod.fit_vocab(desc, branching=b, levels=levels,
                                         seed=self.cfg.seed,
                                         device=m.kf_pose.device)
        system.events.emit("vocab_trained", n_words=self.vocab.n_words,
                           n_desc=int(desc.shape[0]))
        # backfill every keyframe's row in one batched K10 launch
        self.db = db_mod.build_db(
            vocab_mod.bow_vectors(self.vocab, m.kf_desc, m.kf_kp_valid),
            m.kf_valid)
        return True

    # ---------------------------------------------------------------- api

    def on_keyframe(self, system, kf: int) -> bool:
        """Resolve the previous keyframe's query and queue keyframe
        ``kf``'s (the path that runs the place query outside the keyframe
        program).  Returns True if the map was corrected."""
        if not self._ensure_vocab(system):
            return False
        corrected = self.resolve_pending(system)
        self.db, packed = _detect_program(
            system.map, self.db, self.vocab, kf, self.cfg.min_gap,
            self.cfg.top_n_candidates)
        self.queue_detection(kf, packed)
        return corrected

    def flush(self, system) -> bool:
        """Drain both pipelines (end of stream / before reading state)."""
        corrected = self.resolve_pending(system)
        return self.resolve_verify(system) or corrected

    def resolve_pending(self, system) -> bool:
        """Resolve the dispatched verification, then the previous
        keyframe's queued place query."""
        corrected = self.resolve_verify(system)
        prev, self._pending_det = self._pending_det, None
        if prev is None or prev[1] is None:
            return corrected
        return self._resolve_detection(system, *prev) or corrected

    def queue_detection(self, kf_host: int, packed) -> None:
        """Store a keyframe's detection scalars for resolution at the next
        keyframe: a device tensor, or None when they ride the keyframe
        board (``deliver``)."""
        self._pending_det = (kf_host, packed)

    def deliver(self, packed_host: np.ndarray) -> None:
        """Hand the detection scalars read on the keyframe board over to
        the queued detection."""
        if self._pending_det is not None:
            self._pending_det = (self._pending_det[0], packed_host)

    def _resolve_detection(self, system, kf_host: int, packed) -> bool:
        """Host half of NewDetectCommonRegions: candidate acceptance,
        temporal consistency, and the dispatch of the verification."""
        pk = packed if isinstance(packed, np.ndarray) else system._read(
            packed)
        n_top = self.cfg.top_n_candidates
        self._kf_since_loop += 1
        if pk.shape[0] > 2 * n_top + 2:
            _consume_board(system, float(pk[-1]))
        if self._kf_since_loop <= self.cfg.loop_cooldown:
            return False
        ref_score = float(pk[0])
        cand_ids = pk[1:1 + n_top].astype(np.int32)
        cand_scores = pk[1 + n_top:1 + 2 * n_top]
        best = -1
        for cid, sc in zip(cand_ids, cand_scores):
            if cid >= 0 and sc >= self.cfg.loop_score_ratio * max(ref_score,
                                                                  1e-9):
                best = int(cid)
                break
        system.events.emit(
            "loop_query", kf=kf_host, best=best,
            cands=[int(c) for c in cand_ids],
            scores=[round(float(s), 3) for s in cand_scores],
            ref=round(ref_score, 3))
        if best < 0:
            self._consistent_count = 0
            self._consistent_cand = -1
            return False
        if self._consistent_cand >= 0 and abs(best -
                                              self._consistent_cand) <= 5:
            self._consistent_count += 1
        else:
            self._consistent_count = 1
        self._consistent_cand = best
        if self._consistent_count < self.cfg.consistency:
            return False
        # dispatch only: the scalars are read back at the next keyframe
        m: MapState = system.map
        key = int(self._rng.integers(0, 2**31))
        fix_scale = not system.cfg.sensor_is_monocular()
        with system.timers.stage("loop_verify"):
            S_cand_cur, n_inl, n_guided, n_match = _loop_geometry(
                m, kf_host, best, lambda v: self.draw("sim3", key, v),
                self.cfg.loop_inlier_thresh_3d, system.cam_K,
                fix_scale=fix_scale)
            drift = _loop_drift(m.kf_pose, kf_host, best, S_cand_cur)
            scalars = torch.stack([
                n_inl.to(torch.float32), n_guided.to(torch.float32), drift,
                m.kf_timestamp[kf_host], m.kf_timestamp[best],
                n_match.to(torch.float32)])
        self._pending_verify = (kf_host, best, S_cand_cur, scalars)
        return False

    def resolve_verify(self, system) -> bool:
        """Read the dispatched verification's scalars, apply the double
        gate, and correct the map if the loop passes.  Returns True if
        the map was corrected."""
        pv, self._pending_verify = self._pending_verify, None
        if pv is None:
            return False
        kf_host, best, S_cand_cur, scalars = pv
        m: MapState = system.map
        sc = system._read(scalars)
        n_inl_host, n_guided_host = int(sc[0]), int(sc[1])
        drift = float(sc[2])
        n_match_host = int(sc[5])
        n_feat = int(m.kf_kp_valid.shape[1])
        min_guided = max(12, self.cfg.loop_min_guided * n_feat // 1000)
        ratio_ok = n_inl_host >= max(
            self.cfg.loop_min_inliers,
            int(self.cfg.loop_min_inlier_ratio * n_match_host))
        if not ratio_ok or n_guided_host < min_guided:
            self._consistent_count = 0
            self._consistent_cand = -1
            system.events.emit("loop_rejected", kf=kf_host, cand=best,
                               n_inl=n_inl_host, n_guided=n_guided_host,
                               n_match=n_match_host)
            return False
        system.events.emit(
            "loop_verified", kf=kf_host, cand=best, n_inl=n_inl_host,
            n_guided=n_guided_host, drift=round(drift, 4),
            ts_kf=float(sc[3]), ts_cand=float(sc[4]))
        if drift < self.cfg.loop_min_correction:
            self._kf_since_loop = 0  # treated as closed: consistent already
            self._consistent_count = 0
            self._consistent_cand = -1
            return False
        fix_scale = not system.cfg.sensor_is_monocular()
        with system.timers.stage("loop_correct"):
            edges = pgo.build_covis_edges(
                m, min_weight=self.cfg.essential_min_weight,
                max_edges=self.cfg.essential_max_edges)
            fixed = torch.arange(m.K, device=m.kf_pose.device) == best
            result = pgo.optimize_essential_graph(
                m.kf_pose, m.kf_valid, edges, loop_i=best, loop_j=kf_host,
                S_loop_ji=lie.sim3_inverse(S_cand_cur), fixed=fixed,
                iters=self.cfg.pgo_iters, fix_scale=fix_scale)
            system.map = pgo.correct_map(m, result)
            sgm = getattr(system, "scenegraph", None)
            if sgm is not None:
                sgm.state = pgo.correct_scenegraph(sgm.state, result,
                                                   system.map)
            system.map = mapping.fuse_observations(system.map, kf_host,
                                                   system.cam_K)
        if self.cfg.gba_after_loop:
            system.run_global_ba(iters=self.cfg.gba_iters)
        elif self.cfg.loop_local_ba:
            # the welding-window refinement around the closed loop
            # (LoopClosureLocalBundleAdjustment, Optimizer.cc:4634)
            with system.timers.stage("loop_lba", sync_on=system.map.n_kf):
                system.map, _ = mapping.local_ba(
                    system.map, kf_host, system.cam_K, system.cam_bf,
                    n_window=10, iters=6)
        self.n_loops_closed += 1
        self.last_loop = (kf_host, best)
        self._kf_since_loop = 0
        self._consistent_count = 0
        self._consistent_cand = -1
        return True

    def relocalize(self, system, frame) -> bool:
        """Recover tracking from a lost state (Tracking::Relocalization)."""
        if self.vocab is None or self.db is None:
            return False
        with system.timers.stage("reloc"):
            hit = reloc_in_map(system.map, self.db, self.vocab, frame,
                               system.cam_K, self.cfg.reloc_min_inliers,
                               top_n=self.cfg.top_n_candidates,
                               draw=self.draw, read=system._read)
        if hit is None:
            return False
        pose, cid = hit
        system.events.emit("reloc", cand=cid)
        system.last_pose = pose
        system.ref_kf_host = cid
        system.velocity = lie.se3_identity(device=pose.device)
        return True
