"""Keyframe database: BoW inverted-file retrieval for loops + reloc.

Port of orb_slam2_map_tpu/place/database.py, replacing KeyFrameDatabase
(reference: src/KeyFrameDatabase.cc): loop candidates (shared-word count
>= 0.8*max, score >= minScore, covisibility-group accumulation over
top-10, retain > 0.75*bestAcc, :76-197) and relocalization candidates
(the same without covisibility exclusion and minScore, :199-311).

Sparse per-keyframe BoW (sorted word ids + weights) plus a word ->
keyframes inverted file, on the host; the vocabulary's tree descent runs
on the database's device. L1 scores use sum(min(a,b)) == 1 - 0.5*|a-b|_1.
"""

from __future__ import annotations

import functools
import os
from typing import TYPE_CHECKING, Dict, List, Optional, Set

import numpy as np

from ..config import SystemConfig
from ..utils.device import default_device
from .vocabulary import Vocabulary, train_vocabulary

if TYPE_CHECKING:
    from ..slam.mapstore import MapStore

DEFAULT_VOCABULARY = os.path.join(os.path.dirname(__file__), "data",
                                  "vocab10k.npz")


class KeyFrameDatabase:
    def __init__(self, cfg: SystemConfig, map_store: MapStore,
                 vocabulary: Optional[Vocabulary] = None, device=None):
        self.cfg = cfg
        self.map = map_store
        self.vocab = vocabulary
        self.device = default_device(device)
        K = map_store.K
        self._words: List[Optional[np.ndarray]] = [None] * K
        self._vals: List[Optional[np.ndarray]] = [None] * K
        self._has_bow = np.zeros(K, dtype=bool)
        self._inv: Dict[int, Set[int]] = {}
        self._synced_version = -1

    # ------------------------------------------------------------------

    def ensure_vocabulary(self, descs: Optional[np.ndarray] = None):
        """Load the shipped 10k-word vocabulary, or train one from map
        descriptors (the reference requires the prebuilt 1M-word ORBvoc
        file, src/System.cc:73-95)."""
        if self.vocab is not None:
            return
        self.vocab = load_default_vocabulary()
        if self.vocab is not None:
            return
        if descs is None:
            kfs = self.map.keyframe_ids()
            pool = [self.map.kf_desc[k][self.map.kf_kp_valid[k]] for k in kfs]
            descs = (np.concatenate(pool, axis=0) if pool
                     else np.random.default_rng(0).integers(
                         0, 2 ** 32, (4000, 8), dtype=np.uint32))
        if len(descs) > 30000:
            sel = np.random.default_rng(0).choice(len(descs), 30000,
                                                  replace=False)
            descs = descs[sel]
        self.vocab = train_vocabulary(descs, k=10, L=3)

    def maybe_refresh(self):
        """Sync BoW entries with map changes (new/culled KFs)."""
        if self.map.version == self._synced_version:
            return
        if self.vocab is None:
            if self.map.n_keyframes() >= 4:
                self.ensure_vocabulary()
            else:
                return
        live = self.map.kf_exists
        for k in np.nonzero(self._has_bow & ~live)[0]:
            for w in self._words[k]:
                self._inv.get(int(w), set()).discard(int(k))
            self._words[k] = self._vals[k] = None
            self._has_bow[k] = False
        for k in np.nonzero(live & ~self._has_bow)[0]:
            words, vals = self.vocab.bow_sparse(
                self.map.kf_desc[k], self.map.kf_kp_valid[k], self.device)
            self._words[k] = words
            self._vals[k] = vals
            for w in words:
                self._inv.setdefault(int(w), set()).add(int(k))
            self._has_bow[k] = True
        self._synced_version = self.map.version

    def clear(self):
        K = self.map.K
        self._words = [None] * K
        self._vals = [None] * K
        self._has_bow[:] = False
        self._inv.clear()
        self._synced_version = -1

    def rebuild(self):
        self.clear()
        self.maybe_refresh()

    # ------------------------------------------------------------------

    def _shared_counts(self, words: np.ndarray) -> np.ndarray:
        """[K] number of query words shared with each keyframe (the
        inverted-file walk, reference src/KeyFrameDatabase.cc:83-104)."""
        counts = np.zeros(self.map.K, dtype=np.int32)
        for w in words:
            for kid in self._inv.get(int(w), ()):
                counts[kid] += 1
        return counts

    def _score(self, words, vals, kid: int) -> float:
        return Vocabulary.score_sparse(words, vals,
                                       self._words[kid], self._vals[kid])

    def detect_loop_candidates(self, kid: int, min_score: float
                               ) -> np.ndarray:
        """(reference: src/KeyFrameDatabase.cc:76-197)."""
        self.maybe_refresh()
        if self.vocab is None or not self._has_bow[kid]:
            return np.asarray([], dtype=np.int64)
        words, vals = self._words[kid], self._vals[kid]
        connected = set(self.map.covisible_keyframes(kid).tolist())

        shared = self._shared_counts(words)
        shared[kid] = 0
        shared[~(self.map.kf_exists & self._has_bow)] = 0
        for c in connected:
            shared[c] = 0
        if shared.max() == 0:
            return np.asarray([], dtype=np.int64)
        min_common = int(0.8 * shared.max())
        cands = np.nonzero(shared > max(min_common, 0))[0]
        scores = np.asarray([self._score(words, vals, int(c))
                             for c in cands])
        cands = cands[scores >= min_score]
        if len(cands) == 0:
            return cands.astype(np.int64)

        # accumulate score over each candidate's top-10 covisibility group
        acc_scores = np.zeros(len(cands))
        best_of_group = np.zeros(len(cands), dtype=np.int64)
        for i, c in enumerate(cands):
            group = [int(c)] + self.map.covisible_keyframes(
                int(c), top_n=10).tolist()
            g = [x for x in group if self._has_bow[x]]
            g_scores = np.asarray([self._score(words, vals, int(x))
                                   for x in g])
            acc_scores[i] = g_scores.sum()
            best_of_group[i] = g[int(np.argmax(g_scores))]
        th = 0.75 * acc_scores.max()
        return np.unique(best_of_group[acc_scores >= th]).astype(np.int64)

    def reloc_candidates(self, f) -> np.ndarray:
        """(reference: src/KeyFrameDatabase.cc:199-311), ranked best
        first. `f` is a frame (its desc and valid, tensors or arrays)."""
        self.maybe_refresh()
        if self.vocab is None:
            return self.map.keyframe_ids()
        words, vals = self.vocab.bow_sparse(f.desc, f.valid, self.device)
        shared = self._shared_counts(words)
        shared[~(self.map.kf_exists & self._has_bow)] = 0
        if shared.max() == 0:
            return np.asarray([], dtype=np.int64)
        cands = np.nonzero(shared > 0.8 * shared.max())[0]
        scores = np.asarray([self._score(words, vals, int(c))
                             for c in cands])
        order = np.argsort(-scores, kind="stable")
        return cands[order].astype(np.int64)

    def min_score_vs_neighbors(self, kid: int) -> float:
        """DetectLoop's minScore: the lowest BoW score between the query
        KF and its covisibility neighbours (reference:
        src/LoopClosing.cc:125-139)."""
        self.maybe_refresh()
        if not self._has_bow[kid]:
            return 0.0
        words, vals = self._words[kid], self._vals[kid]
        nbs = [int(n) for n in self.map.covisible_keyframes(kid)
               if self._has_bow[n]]
        if not nbs:
            return 0.0
        return min(self._score(words, vals, n) for n in nbs)


@functools.lru_cache(maxsize=1)
def load_default_vocabulary() -> Optional[Vocabulary]:
    """The 10k-word vocabulary shipped with the package (the JAX
    package's `place/data/vocab10k.npz`, byte for byte: trained on
    synthetic-world ORB descriptors)."""
    if not os.path.exists(DEFAULT_VOCABULARY):
        return None
    return Vocabulary.load(DEFAULT_VOCABULARY)
