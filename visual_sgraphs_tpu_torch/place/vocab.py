"""Binary bag-of-words vocabulary (DBoW2's TemplatedVocabulary) and the
BoW transform (kernel K10).

Port of ``visual_sgraphs_tpu/place/vocab.py``.  The tree is a stack of
per-level center tables (``centers[l]`` is (K**(l+1), 32) uint8; the
children of node ``n`` of level ``l-1`` are rows ``n*K + c``) and an idf
vector over the W = K**L leaves.  ``fit_vocab`` is the host-side binary
k-majority clustering, copied from the reference so that the same
descriptors and seed give the same tree bit for bit; ``save_vocab`` /
``load_vocab`` read and write the reference's ``.npz`` layout.

``bow_vectors`` launches the hand kernel in ``csrc/bow.cu`` on CUDA
tensors (tree descent, tf counts, tf-idf and L1 normalisation for R
descriptor sets at once) and runs the plain twin ``bow_vectors_torch`` on
CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda


class VocabTree(NamedTuple):
    """K-ary tree of binary centers (see the module docstring)."""

    centers: tuple  # L tensors, (K**(l+1), 32) uint8
    idf: torch.Tensor  # (W,) float32

    @property
    def branching(self) -> int:
        return self.centers[0].shape[0]

    @property
    def n_words(self) -> int:
        return self.idf.shape[0]

    def to(self, device) -> "VocabTree":
        return VocabTree(tuple(c.to(device) for c in self.centers),
                         self.idf.to(device))


# ------------------------------------------------------------------ training


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x, axis=-1).sum(-1)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Na, Nb) Hamming distances between uint8 descriptor rows."""
    return _popcount_np(a[:, None, :] ^ b[None, :, :])


def _kmajority(desc: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-means ("k-majority"): centers are per-bit majority votes.
    Returns (centers (k, 32) uint8, assignment (N,) int)."""
    n = desc.shape[0]
    if n == 0:
        return rng.integers(0, 256, (k, 32), dtype=np.uint8), np.zeros(0, int)
    centers = desc[rng.choice(n, size=min(k, n), replace=False)]
    if centers.shape[0] < k:  # pad with random picks (duplicates are fine)
        centers = np.concatenate(
            [centers, desc[rng.integers(0, n, k - centers.shape[0])]])
    assign = np.zeros(n, int)
    for _ in range(iters):
        d = _hamming_np(desc, centers)
        assign = d.argmin(1)
        bits = np.unpackbits(desc, axis=1)  # (N, 256)
        for c in range(k):
            sel = bits[assign == c]
            if sel.shape[0] == 0:
                centers[c] = desc[rng.integers(0, n)]
            else:
                maj = (sel.mean(0) >= 0.5).astype(np.uint8)
                centers[c] = np.packbits(maj)
    return centers, assign


def tree_from_numpy(centers, idf, device=None) -> VocabTree:
    return VocabTree(
        tuple(torch.from_numpy(np.array(c, np.uint8)).to(device)
              for c in centers),
        torch.from_numpy(np.array(idf, np.float32)).to(device))


def fit_vocab(desc: np.ndarray, branching: int = 8, levels: int = 4,
              seed: int = 0, device=None) -> VocabTree:
    """Train a branching**levels-word vocabulary from (N, 32) uint8 ORB
    descriptors (the offline half of DBoW2's k-means tree), on the host
    with the reference's training loop."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(desc, np.uint8)
    K = branching
    level_centers: list[np.ndarray] = []
    groups = [desc]
    for lvl in range(levels):
        centers = np.zeros((K ** (lvl + 1), 32), np.uint8)
        next_groups: list[np.ndarray] = []
        for node, g in enumerate(groups):
            c, a = _kmajority(g, K, rng)
            centers[node * K:(node + 1) * K] = c
            for ch in range(K):
                next_groups.append(g[a == ch] if g.shape[0] else g)
        level_centers.append(centers)
        groups = next_groups
    # idf from training occupancy: rare words are informative (TF_IDF)
    counts = np.array([max(g.shape[0], 1) for g in groups], np.float64)
    idf = np.log(desc.shape[0] / counts).astype(np.float32)
    return tree_from_numpy(level_centers, np.maximum(idf, 0.0), device=device)


def save_vocab(tree: VocabTree, path: str) -> None:
    np.savez(path, idf=tree.idf.cpu().numpy(), n_levels=len(tree.centers),
             **{f"level_{i}": c.cpu().numpy()
                for i, c in enumerate(tree.centers)})


def load_vocab(path: str, device=None) -> VocabTree:
    z = np.load(path)
    n = int(z["n_levels"])
    return tree_from_numpy([z[f"level_{i}"] for i in range(n)], z["idf"],
                           device=device)


# ------------------------------------------------------------------- descent

_POPCOUNT = None


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount of a uint8 tensor (int32)."""
    global _POPCOUNT
    if _POPCOUNT is None:
        _POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                                 dtype=torch.int32)
    return _POPCOUNT.to(x.device)[x.long()]


def descend(tree: VocabTree, desc: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 descriptors -> (N,) int32 word ids: at each level the
    Hamming argmin over the current node's K children (first index on
    ties, as jnp.argmin)."""
    K = tree.branching
    dev = desc.device
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=dev)
    ar = torch.arange(K, device=dev)
    for C in tree.centers:
        child_idx = node[:, None] * K + ar[None]
        ham = popcount_u8(C[child_idx] ^ desc[:, None, :]).sum(-1)
        node = torch.gather(child_idx, 1, torch.argmin(ham, dim=1)[:, None]
                            )[:, 0]
    return node.to(torch.int32)


def bow_vectors_torch(tree: VocabTree, desc: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Plain twin of K10: (R, F, 32) descriptor sets + (R, F) validity ->
    (R, W) L1-normalised tf-idf rows (the reference's ``bow_vector`` per
    set)."""
    if desc.is_cuda:
        bow_vectors_torch.cuda_calls += 1
    R, F = valid.shape
    W = tree.n_words
    words = descend(tree, desc.reshape(R * F, 32)).reshape(R, F).long()
    tf = torch.zeros((R, W), dtype=torch.float32, device=desc.device)
    tf.scatter_add_(1, torch.where(valid, words, 0), valid.to(torch.float32))
    v = tf * tree.idf[None]
    return v / torch.clamp(torch.sum(v, dim=1, keepdim=True), min=1e-12)


bow_vectors_torch.cuda_calls = 0


def bow_vectors(tree: VocabTree, desc: torch.Tensor, valid: torch.Tensor,
                words_out: torch.Tensor | None = None) -> torch.Tensor:
    """BoW rows of R descriptor sets (kernel K10 on CUDA tensors, the twin
    on CPU): (R, F, 32) uint8 + (R, F) bool -> (R, W) float32.  With
    ``words_out`` (an (R, F) int32 tensor), each descriptor's word id is
    written there too."""
    if desc.device.type == "cpu":
        if words_out is not None:
            words_out.copy_(descend(tree, desc.reshape(-1, 32)).reshape(
                valid.shape))
        return bow_vectors_torch(tree, desc, valid)
    flat, offsets = _flat_centers(tree)
    cuda.require_cuda("bow_vectors", desc, valid, flat, tree.idf)
    if desc.dtype != torch.uint8 or desc.shape[-1] != 32 \
            or valid.dtype != torch.bool or desc.data_ptr() % 4:
        raise ValueError("bow_vectors: (R, F, 32) uint8 descriptors on a "
                         "4-byte boundary and a (R, F) bool mask")
    R, F = valid.shape
    L, K, W = len(tree.centers), tree.branching, tree.n_words
    if K > 32 or L > 8:
        raise ValueError("bow_vectors: at most 32 children and 8 levels")
    dev = desc.device
    tf = torch.zeros((R, W), dtype=torch.int32, device=dev)
    words = (words_out if words_out is not None
             else torch.empty((R, F), dtype=torch.int32, device=dev))
    if words.shape != (R, F) or words.dtype != torch.int32 \
            or not words.is_contiguous() or words.device != dev:
        raise ValueError("bow_vectors: words_out must be a contiguous "
                         "(R, F) int32 tensor on the descriptors' device")
    bow = torch.empty((R, W), dtype=torch.float32, device=dev)
    cuda.call("vsg_bow_vectors", cuda.ptr(desc), cuda.ptr(valid),
              cuda.ptr(flat), *offsets, L, K, W, R, F, cuda.ptr(tree.idf),
              cuda.ptr(tf), cuda.ptr(words), cuda.ptr(bow), cuda.stream())
    bow_vectors.launches += 1
    return bow


bow_vectors.launches = 0

_FLAT_CACHE: dict = {}


def _flat_centers(tree: VocabTree):
    """All levels' centers in one contiguous (sum K**(l+1), 32) table and
    the row offset of each level (8 slots, unused ones 0), cached per
    tree."""
    key = id(tree.centers[0])
    hit = _FLAT_CACHE.get(key)
    if hit is not None and hit[0] is tree.centers[0]:
        return hit[1], hit[2]
    flat = torch.cat(list(tree.centers)).contiguous()
    offs, o = [], 0
    for c in tree.centers:
        offs.append(o)
        o += c.shape[0]
    offs += [0] * (8 - len(offs))
    _FLAT_CACHE.clear()
    _FLAT_CACHE[key] = (tree.centers[0], flat, offs)
    return flat, offs


def bow_vector(tree: VocabTree, desc: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """L1-normalised tf-idf BoW vector (W,) of one frame's descriptors."""
    return bow_vectors(tree, desc[None], valid[None])[0]
