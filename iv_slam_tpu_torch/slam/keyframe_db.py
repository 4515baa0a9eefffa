"""Keyframe database: inverted BoW index for loop and relocalization
candidates (src/KeyFrameDatabase.cc re-designed over the map store).

Port of ``iv_slam_tpu/slam/keyframe_db.py`` (host bookkeeping, the
reference's dict and set iteration order), and ``KeyFrameBow``, the
per-keyframe BoW cache. DetectLoopCandidates:
accumulate shared-word counts through the inverted file, gate at
0.8 * max common words, L1-score gate at minScore, then covisibility-group
score accumulation and the 0.75 * bestAccScore cut.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .vocabulary import DEVICE_TRANSFORM_MIN_NODES, Vocabulary, l1_score


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.inverted: Dict[int, List[int]] = {}
        self.bow: Dict[int, Dict[int, float]] = {}

    def add(self, kf_id: int, bow_vec: Dict[int, float]):
        self.bow[kf_id] = bow_vec
        for w in bow_vec:
            self.inverted.setdefault(w, []).append(kf_id)

    def erase(self, kf_id: int):
        bow_vec = self.bow.pop(kf_id, None)
        if bow_vec:
            for w in bow_vec:
                lst = self.inverted.get(w)
                if lst and kf_id in lst:
                    lst.remove(kf_id)

    def clear(self):
        self.inverted.clear()
        self.bow.clear()

    def _shared_word_counts(self, bow_vec, exclude) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for w in bow_vec:
            for kf in self.inverted.get(w, ()):
                if kf not in exclude:
                    counts[kf] = counts.get(kf, 0) + 1
        return counts

    def _group_funnel(self, scored, m) -> List[int]:
        """Covisibility-group accumulation over (kf, score) pairs (each
        group: a candidate and its top-10 covisibles that scored), then the
        0.75 * best-accumulated cut, best keyframe per group, first seen."""
        best_acc = 0.0
        groups = []
        score_of = dict(scored)
        for kf, s in scored:
            acc = s
            best_kf, best_s = kf, s
            for nb, _w in m.covisible_keyframes(kf)[:10]:
                if nb in score_of:
                    acc += score_of[nb]
                    if score_of[nb] > best_s:
                        best_kf, best_s = nb, score_of[nb]
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        min_acc = 0.75 * best_acc
        out, seen = [], set()
        for acc, kf in groups:
            if acc > min_acc and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_loop_candidates(self, kf_id: int, bow_vec, min_score: float,
                               connected: set, m) -> List[int]:
        """KeyFrameDatabase::DetectLoopCandidates. `connected` is the
        covisibility neighbourhood of kf_id; `m` the map store (for the
        group expansion)."""
        counts = self._shared_word_counts(bow_vec, connected | {kf_id})
        if not counts:
            return []
        min_common = int(0.8 * max(counts.values()))
        scored = []
        for kf, c in counts.items():
            if c > min_common:
                s = l1_score(bow_vec, self.bow.get(kf, {}))
                if s >= min_score:
                    scored.append((kf, s))
        if not scored:
            return []
        return self._group_funnel(scored, m)

    def detect_relocalization_candidates(self, bow_vec, m) -> List[int]:
        """KeyFrameDatabase::DetectRelocalizationCandidates (the same
        funnel, no min_score gate, no connected exclusion)."""
        counts = self._shared_word_counts(bow_vec, set())
        if not counts:
            return []
        min_common = int(0.8 * max(counts.values()))
        scored = [(kf, l1_score(bow_vec, self.bow.get(kf, {})))
                  for kf, c in counts.items() if c > min_common]
        if not scored:
            return []
        return self._group_funnel(scored, m)


class KeyFrameBow:
    """Per-keyframe vocabulary data, computed once and shared by
    relocalization and loop closing (the reference keeps it on
    LoopClosing, ``_ensure_bow``/``kf_bow``/``kf_nodes``, and
    relocalization reads it there): one tree descent per keyframe feeds
    its BowVector and its FeatureVector nodes (DBoW2 transform() computes
    both in one walk). A vocabulary of DEVICE_TRANSFORM_MIN_NODES nodes or
    more descends on `device`."""

    def __init__(self, voc: Vocabulary, map_store, device):
        self.voc = voc
        self.map = map_store
        self.device = device
        self.kf_bow: Dict[int, Dict[int, float]] = {}
        self.kf_nodes: Dict[int, np.ndarray] = {}

    def ensure(self, kf_id: int):
        if kf_id in self.kf_bow:
            return
        frame = self.map.kf_frames[kf_id]
        on_device = len(self.voc.node_desc) >= DEVICE_TRANSFORM_MIN_NODES
        leaf = self.voc.transform_nodes(frame.desc, frame.valid,
                                        device=self.device if on_device else False)
        self.kf_bow[kf_id] = self.voc.bow_vector(frame.desc, nodes=leaf)
        self.kf_nodes[kf_id] = self.voc.feature_nodes(frame.desc, nodes=leaf)
