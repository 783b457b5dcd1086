"""BoW vocabulary: hierarchical binary-descriptor tree as dense arrays.

Port of orb_slam2_map_tpu/place/vocabulary.py, replacing DBoW2's
TemplatedVocabulary (reference: Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h): a k^L tree of ORB descriptor centroids with
TF-IDF weighting and L1 scoring, save/load, and the levels-up direct
index.

The tree is a complete k-ary array — level l holds k^l centroids, the
children of node j are the contiguous block j*k .. j*k+k-1 — so
`transform` (descriptor -> word) is L rounds of gather + XOR-popcount
argmin, batched over the descriptors, on the device of the descriptors
(a tensor) or the one the caller names (numpy descriptors: the card
unless the caller asks for another device). Training (hierarchical k-medians
with bitwise-majority centroids, FORB::meanValue), the synthetic tree and
the DBoW2 text / binary converters are host numpy, copied from the JAX
package.

Centroids stay uint32 on the host (the .npz layout); on the device they
are int32 bit-views, like every descriptor of the port, and distances are
`ops.matching.hamming_distance` (bit unpacking, safe on top-bit words).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.matching import hamming_distance, popcount_np
from ..utils.device import default_device


def hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 8] x [M, 8] -> [N, M] int32 Hamming distances (host)."""
    x = a[:, None, :] ^ b[None, :, :]
    return popcount_np(x).sum(axis=-1).astype(np.int32)


def majority_centroid(descs: np.ndarray) -> np.ndarray:
    """Bitwise majority vote over packed descriptors [N, 8] -> [8]
    (FORB::meanValue semantics)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)     # [N, 256]
    maj = (bits.sum(axis=0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


@dataclass
class Vocabulary:
    k: int                      # branching factor
    L: int                      # depth (levels below root)
    centroids: np.ndarray       # [n_internal + n_words, 8] uint32, level-major
    weights: np.ndarray         # [n_words] float32 idf weights
    levelsup: int = 2           # direct-index level distance from leaves
    # device copies of the centroid table (int32 bit-views), per device
    _dev: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False,
                                          compare=False)

    @property
    def n_words(self) -> int:
        return self.k ** self.L

    def level_offset(self, level: int) -> int:
        """Start index of level `level` (1-based below root) in centroids."""
        return sum(self.k ** l for l in range(1, level))

    # ------------------------------------------------------------------

    def save(self, path: str):
        np.savez_compressed(path, k=self.k, L=self.L,
                            centroids=self.centroids, weights=self.weights,
                            levelsup=self.levelsup)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        return Vocabulary(k=int(z["k"]), L=int(z["L"]),
                          centroids=z["centroids"], weights=z["weights"],
                          levelsup=int(z["levelsup"]))

    # ------------------------------------------------------------------

    def _centroids_on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        dev = self._dev.get(key)
        if dev is None or dev.shape[0] != self.centroids.shape[0]:
            dev = torch.as_tensor(
                np.ascontiguousarray(self.centroids).view(np.int32),
                device=device)
            self._dev[key] = dev
        return dev

    def transform(self, desc, valid=None, device=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Descriptors [N, 8] (numpy uint32 / int32, or an int32 tensor)
        -> (word_id [N], node_id [N]) as numpy int64.

        node_id is the direct-index node `levelsup` levels above the leaf
        (reference: Frame::ComputeBoW levelsup=4 from the 6-level ORBvoc;
        scaled to this tree's depth). Invalid descriptors get word -1.
        The descent runs on `device`, else on the descriptors' device (a
        tensor), else on the card."""
        if isinstance(desc, torch.Tensor):
            d = desc.to(torch.int32)
            if device is not None:
                d = d.to(device)
        else:
            d = torch.as_tensor(np.ascontiguousarray(desc).view(np.int32),
                                device=default_device(device))
        node, direct = _descend(d, self.k, self.L, self.levelsup,
                                self._centroids_on(d.device))
        w, n = node.cpu().numpy(), direct.cpu().numpy()
        if valid is not None:
            valid = (valid.cpu().numpy() if isinstance(valid, torch.Tensor)
                     else np.asarray(valid))
            w = np.where(valid, w, -1)
            n = np.where(valid, n, -1)
        return w, n

    def bow_vector(self, desc, valid=None, device=None) -> np.ndarray:
        """L1-normalized tf-idf histogram [n_words] float32."""
        w, _ = self.transform(desc, valid, device)
        v = np.zeros(self.n_words, dtype=np.float32)
        ww = w[w >= 0]
        np.add.at(v, ww, self.weights[ww])
        s = v.sum()
        return v / s if s > 0 else v

    def bow_sparse(self, desc, valid=None, device=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse L1-normalized tf-idf BoW: (sorted word ids [W],
        weights [W]); W <= n_features whatever the vocabulary size."""
        w, _ = self.transform(desc, valid, device)
        ww = w[w >= 0]
        words, cnt = np.unique(ww, return_counts=True)
        vals = cnt.astype(np.float32) * self.weights[words]
        s = vals.sum()
        if s > 0:
            vals = vals / s
        return words.astype(np.int64), vals.astype(np.float32)

    @staticmethod
    def score_l1(v1: np.ndarray, v2: np.ndarray) -> float:
        """DBoW2 L1 score: 1 - 0.5 |v1 - v2|_1, in [0, 1]."""
        return float(1.0 - 0.5 * np.abs(v1 - v2).sum())

    @staticmethod
    def score_sparse(w1, v1, w2, v2) -> float:
        """L1 score on sparse BoW pairs: for L1-normalized vectors,
        1 - 0.5*|v1-v2|_1 == sum over SHARED words of min(a, b)
        (Thirdparty/DBoW2 L1Scoring)."""
        c1, i1, i2 = np.intersect1d(w1, w2, assume_unique=True,
                                    return_indices=True)
        if len(c1) == 0:
            return 0.0
        return float(np.minimum(v1[i1], v2[i2]).sum())


def _descend(desc: torch.Tensor, k: int, L: int, levelsup: int,
             centroids: torch.Tensor):
    """Batched tree descent: L rounds of gathering each descriptor's k
    packed candidate centroids ([N, k, 8]), Hamming distances and argmin
    (first index on ties, as jnp.argmin)."""
    n = desc.shape[0]
    dev = desc.device
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    direct = torch.zeros(n, dtype=torch.int64, device=dev)
    offset = 0
    ar = torch.arange(k, device=dev)
    for level in range(1, L + 1):
        block = centroids[offset:offset + k ** level]            # [k^l, 8]
        child_base = node * k
        cand = block[child_base[:, None] + ar[None, :]]          # [N, k, 8]
        dist = hamming_distance(cand.reshape(n * k, 8),
                                desc.repeat_interleave(k, dim=0)).view(n, k)
        node = child_base + torch.argmin(dist, dim=1)
        if level == L - levelsup:
            direct = node
        offset += k ** level
    if L - levelsup <= 0:
        direct = torch.zeros_like(node)
    return node, direct


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_vocabulary(descs: np.ndarray, k: int = 10, L: int = 3,
                     seed: int = 0, iters: int = 8,
                     levelsup: int = 1) -> Vocabulary:
    """Hierarchical k-medians over packed descriptors [N, 8].

    Builds a complete k^L tree (empty clusters re-seeded from the largest
    cluster so the dense-array layout always holds).
    """
    rng = np.random.default_rng(seed)
    levels = []                 # per level: [k^level, 8]
    assignments = np.zeros(len(descs), dtype=np.int64)  # node idx in level

    for level in range(1, L + 1):
        n_nodes = k ** level
        cents = np.zeros((n_nodes, 8), dtype=np.uint32)
        new_assign = np.zeros_like(assignments)
        for parent in range(k ** (level - 1)):
            sel = np.nonzero(assignments == parent)[0]
            sub = descs[sel]
            c = _kmedians(sub, k, rng, iters)
            cents[parent * k:(parent + 1) * k] = c
            if len(sel):
                a = np.argmin(hamming_np(sub, c), axis=1)
                new_assign[sel] = parent * k + a
        assignments = new_assign
        levels.append(cents)

    centroids = np.concatenate(levels, axis=0)
    # idf weights from training data (reference TF_IDF weighting)
    n_words = k ** L
    counts = np.bincount(assignments, minlength=n_words).astype(np.float64)
    n_docs = max(len(descs) / 500.0, 1.0)  # pseudo-documents of ~500 feats
    idf = np.log(np.maximum(n_docs, 2.0) /
                 np.maximum(counts / 500.0, 1e-3))
    idf = np.clip(idf, 0.05, None).astype(np.float32)
    return Vocabulary(k=k, L=L, centroids=centroids, weights=idf,
                      levelsup=min(levelsup, L - 1))


def _kmedians(sub: np.ndarray, k: int, rng, iters: int) -> np.ndarray:
    """k-medians with majority centroids; always returns k centroids."""
    if len(sub) == 0:
        return rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32)
    if len(sub) <= k:
        out = np.zeros((k, 8), dtype=np.uint32)
        out[:len(sub)] = sub
        out[len(sub):] = sub[rng.integers(0, len(sub), k - len(sub))]
        # perturb duplicates one bit so children differ
        for i in range(len(sub), k):
            out[i, 0] ^= np.uint32(1 << int(rng.integers(0, 32)))
        return out
    # k-means++ style init in Hamming space
    cents = [sub[rng.integers(len(sub))]]
    for _ in range(k - 1):
        d = hamming_np(sub, np.asarray(cents)).min(axis=1).astype(np.float64)
        s = d.sum()
        if s > 0:
            cents.append(sub[rng.choice(len(sub), p=d / s)])
        else:  # all descriptors identical to a centroid: uniform pick
            cents.append(sub[rng.integers(len(sub))])
    cents = np.asarray(cents, dtype=np.uint32)
    for _ in range(iters):
        a = np.argmin(hamming_np(sub, cents), axis=1)
        for j in range(k):
            sel = sub[a == j]
            if len(sel):
                cents[j] = majority_centroid(sel)
            else:  # re-seed from the biggest cluster
                big = np.argmax(np.bincount(a, minlength=k))
                pool = sub[a == big]
                cents[j] = pool[rng.integers(len(pool))]
    return cents


def synthesize_vocabulary(k: int, L: int, seed: int = 0,
                          flips_root: int = 96) -> Vocabulary:
    """A hierarchically consistent vocabulary without training: level-1
    centroids are random, each child perturbs its parent by a decreasing
    number of random bit flips (exercises the reference's 1M-word k=10
    L=6 shape, reference README.md:24, without hours of k-medians)."""
    rng = np.random.default_rng(seed)
    levels = []
    parents = rng.integers(0, 2 ** 32, (1, 8), dtype=np.uint32)  # root
    for level in range(1, L + 1):
        n_nodes = k ** level
        children = np.repeat(parents, k, axis=0)
        if level == 1:
            children = rng.integers(0, 2 ** 32, (n_nodes, 8),
                                    dtype=np.uint32)
        else:
            n_flips = max(flips_root >> (level - 1), 4)
            bit = rng.integers(0, 256, (n_nodes, n_flips))
            rows = np.repeat(np.arange(n_nodes), n_flips)
            w = (bit // 32).ravel()
            b = (bit % 32).ravel().astype(np.uint32)
            np.bitwise_xor.at(children, (rows, w),
                              (np.uint32(1) << b))
        levels.append(children)
        parents = children
    centroids = np.concatenate(levels, axis=0)
    weights = rng.uniform(0.2, 1.0, k ** L).astype(np.float32)
    return Vocabulary(k=k, L=L, centroids=centroids, weights=weights,
                      levelsup=min(4, L - 1))


# ---------------------------------------------------------------------------
# DBoW2 text format (tools/bin_vocabulary.cc equivalent)
# ---------------------------------------------------------------------------

def save_orbvoc_text(voc: Vocabulary, path: str):
    """Write the DBoW2 text format (the inverse of load_orbvoc_text):
    header 'k L scoring weighting', then one node per line in level
    order: 'parent_file_id is_leaf d0..d31 weight'."""
    k, L = voc.k, voc.L
    offsets = np.concatenate([[0], np.cumsum([k ** l
                                              for l in range(1, L + 1)])])
    n = offsets[-1]
    rows = np.zeros((n, 35), dtype=np.float64)
    desc_bytes = np.ascontiguousarray(voc.centroids).view(np.uint8)
    rows[:, 2:34] = desc_bytes.reshape(n, 32)
    for lv in range(1, L + 1):
        s, e = offsets[lv - 1], offsets[lv]
        pos = np.arange(e - s)
        if lv == 1:
            rows[s:e, 0] = 0
        else:
            rows[s:e, 0] = 1 + offsets[lv - 2] + pos // k
        if lv == L:
            rows[s:e, 1] = 1
            rows[s:e, 34] = voc.weights
    fmt = "%d %d " + " ".join(["%d"] * 32) + " %.6g"
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        np.savetxt(f, rows, fmt=fmt)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse the DBoW2 text vocabulary format: header 'k L scoring
    weighting', then one node per line: 'parent is_leaf d0..d31 weight'.
    Rows that do not have 35 fields (stray short or comment lines of
    real-world files) are skipped; non-complete trees are densified."""
    with open(path) as f:
        header = f.readline().split()
    k, L = int(header[0]), int(header[1])
    with open(path, "rb") as f:
        f.readline()                                       # header
        body = f.read()
    good = [ln for ln in body.splitlines() if len(ln.split()) == 35]
    if not good:
        raise ValueError(f"empty vocabulary file: {path}")
    data = np.loadtxt(io.BytesIO(b"\n".join(good)), ndmin=2)  # [n, 35]
    parent = data[:, 0].astype(np.int64)                  # 1-based file ids
    # descriptor bytes -> packed uint32 (same byte order as ops.orb)
    desc = np.ascontiguousarray(
        data[:, 2:34].astype(np.uint8)).view(np.uint32)   # [n, 8]
    node_w = data[:, 34].astype(np.float32)
    return _vocabulary_from_flat(k, L, parent, desc, node_w)


def _vocabulary_from_flat(k: int, L: int, parent: np.ndarray,
                          desc: np.ndarray, node_w: np.ndarray
                          ) -> Vocabulary:
    """Rebuild the dense level-major tree from DBoW2's flat node list
    (node id = file line + 1, root = 0, parents precede children,
    children of one parent contiguous — both the text and binary
    formats satisfy this)."""
    n_total = sum(k ** l for l in range(1, L + 1))
    offsets = np.concatenate([[0], np.cumsum([k ** l
                                              for l in range(1, L + 1)])])
    n = len(parent)

    # level of each node: parents precede children, so L gathers close it
    level_of = np.zeros(n + 1, dtype=np.int32)            # [0]=root
    for _ in range(L):
        level_of[1:] = level_of[parent] + 1
    # rank among siblings: children of one parent are contiguous
    order = np.argsort(parent, kind="stable")
    ranks = np.empty(n, dtype=np.int64)
    sorted_parent = parent[order]
    new_group = np.concatenate([[True],
                                sorted_parent[1:] != sorted_parent[:-1]])
    group_start = np.maximum.accumulate(
        np.where(new_group, np.arange(n), 0))
    ranks[order] = np.arange(n) - group_start

    pos_in_level = np.zeros(n + 1, dtype=np.int64)
    for _ in range(L):
        pos_in_level[1:] = pos_in_level[parent] * k + ranks

    centroids = np.zeros((n_total, 8), dtype=np.uint32)
    weights = np.zeros(k ** L, dtype=np.float32)
    filled = np.zeros(n_total, dtype=bool)
    lvl = level_of[1:]
    idx = offsets[lvl - 1] + pos_in_level[1:]
    ok = (lvl >= 1) & (lvl <= L) & (idx < n_total)
    centroids[idx[ok]] = desc[ok]
    filled[idx[ok]] = True
    leaf = ok & (lvl == L)
    weights[pos_in_level[1:][leaf]] = node_w[leaf]

    # densify: unfilled nodes copy their parent (vectorized per level)
    for lv in range(2, L + 1):
        off, off_prev = offsets[lv - 1], offsets[lv - 2]
        j = np.nonzero(~filled[off:off + k ** lv])[0]
        centroids[off + j] = centroids[off_prev + j // k]
    return Vocabulary(k=k, L=L, centroids=centroids, weights=weights,
                      levelsup=min(4, L - 1))


# ---------------------------------------------------------------------------
# DBoW2 binary format (reference: TemplatedVocabulary.h loadFromBinaryFile /
# saveToBinaryFile; Vocabulary/ORBvoc.bin, src/System.cc:76-95)
# ---------------------------------------------------------------------------

_BIN_HEADER = np.dtype([("nb_nodes", "<u4"), ("size_node", "<u4"),
                        ("k", "<i4"), ("L", "<i4"),
                        ("scoring", "<i4"), ("weighting", "<i4")])
_BIN_NODE = np.dtype([("parent", "<i4"), ("desc", "u1", 32),
                      ("weight", "<f4"), ("is_leaf", "u1")])


def load_orbvoc_binary(path: str) -> Vocabulary:
    """Parse the ORBvoc.bin layout: 24-byte header (nb_nodes, size_node,
    k, L, scoring, weighting), then nb_nodes-1 packed 41-byte records
    (parent int32, 32 descriptor bytes, weight float32, is_leaf u8) in the
    text file's parent-major node order."""
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(_BIN_HEADER.itemsize),
                             dtype=_BIN_HEADER)[0]
        if int(head["size_node"]) != _BIN_NODE.itemsize:
            raise ValueError(
                f"unsupported node record size {int(head['size_node'])} "
                f"(expected {_BIN_NODE.itemsize} for 32-byte ORB)")
        body = f.read()
    n = len(body) // _BIN_NODE.itemsize
    nodes = np.frombuffer(body, dtype=_BIN_NODE, count=n)
    k, L = int(head["k"]), int(head["L"])
    parent = nodes["parent"].astype(np.int64)
    desc = np.ascontiguousarray(nodes["desc"]).view(np.uint32)
    return _vocabulary_from_flat(k, L, parent, desc,
                                 nodes["weight"].astype(np.float32))


def save_orbvoc_binary(voc: Vocabulary, path: str):
    """Write the ORBvoc.bin layout (inverse of load_orbvoc_binary)."""
    k, L = voc.k, voc.L
    offsets = np.concatenate([[0], np.cumsum([k ** l
                                              for l in range(1, L + 1)])])
    n = int(offsets[-1])
    rec = np.zeros(n, dtype=_BIN_NODE)
    rec["desc"] = np.ascontiguousarray(voc.centroids).view(
        np.uint8).reshape(n, 32)
    for lv in range(1, L + 1):
        s, e = int(offsets[lv - 1]), int(offsets[lv])
        pos = np.arange(e - s)
        rec["parent"][s:e] = 0 if lv == 1 else 1 + offsets[lv - 2] + pos // k
    rec["weight"][offsets[L - 1]:] = voc.weights
    rec["is_leaf"][offsets[L - 1]:] = 1
    head = np.zeros(1, dtype=_BIN_HEADER)
    head[0] = (n + 1, _BIN_NODE.itemsize, k, L, 0, 0)
    with open(path, "wb") as f:
        f.write(head.tobytes())
        f.write(rec.tobytes())
