"""ORB visual vocabulary: training, transform, scoring.

Port of ``iv_slam_tpu/slam/vocabulary.py`` (DBoW2's TemplatedVocabulary<FORB>,
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h, FORB.cpp):

  * k-medians hierarchical clustering over 256-bit descriptors (cluster
    centers are bitwise majority votes, FORB::meanValue); TF-IDF leaf
    weights. The numpy RNG draws and the clustering are the reference's,
    step for step, so a seed gives the reference's tree;
  * transform: vocabulary-tree descent, on the host in numpy (all
    descriptors of a frame descend level by level together, which visits
    the same nodes as the reference's one-at-a-time walk) or on a torch
    device (``ops/bow.py``);
  * L1 scoring of normalized BoW vectors (DBoW2 L1Scoring), used by loop
    detection and relocalization candidate search.

Files: ``save``/``load`` write and read the reference's npz layout, and
``save_dbow2_text``/``load_dbow2_text`` the DBoW2 text format, so a file
written by either package loads in the other.

The reference's host helpers (its C++ extension, ``native/``) are
``csrc/vocab_native.c``, built by the host C compiler at first use and
called through ctypes: ``parse_vocab_text`` (an ORBvoc-sized text file,
~1.1M nodes, in seconds rather than the Python loop's tens of seconds),
``hamming_matrix`` and ``vocab_transform``. Their plain versions are the
NumPy forms beside them (``*_plain``); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np

from .. import _kernels

# vocabularies at ORBvoc scale (~1M leaves) pay ~50-70 ms of cache-hostile
# host tree descent per transform; those take the device descent
# (ops/bow.py, the tree resident on the device) instead
DEVICE_TRANSFORM_MIN_NODES = 200_000


def hamming_matrix_plain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 32) u8 x (M, 32) u8 -> (N, M) int32 Hamming distances."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return np.unpackbits(x, axis=-1).sum(axis=-1).astype(np.int32)


def parse_vocab_text_plain(path: str):
    """DBoW2 text file -> (k, L, scoring, weighting, parents, descs,
    weights, leaves); node 0 is the implicit root."""
    with open(path) as f:
        header = f.readline().split()
        k, L, scoring, weighting = (int(v) for v in header[:4])
        parents, descs, weights, leaves = [-1], [np.zeros(32, np.uint8)], [0.0], [0]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(int(parts[1]))
            descs.append(np.array([int(v) for v in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))
    return (k, L, scoring, weighting, np.array(parents, np.int32), np.stack(descs),
            np.array(weights, np.float32), np.array(leaves, np.uint8))


def vocab_transform_plain(children: np.ndarray, node_desc: np.ndarray,
                          desc: np.ndarray) -> np.ndarray:
    """(N, 32) u8 -> (N,) int32 leaf node ids: from the root, step to the
    child at the least Hamming distance (the first of equals; valid
    children sit at the front of a row) until a node has no children."""
    n = desc.shape[0]
    node = np.zeros(n, np.int32)
    active = np.arange(n)
    while len(active):
        kids = children[node[active]]                            # (A, k)
        inner = kids[:, 0] >= 0
        active, kids = active[inner], kids[inner]
        if not len(active):
            break
        x = np.bitwise_xor(desc[active][:, None, :], node_desc[np.maximum(kids, 0)])
        d = np.unpackbits(x, axis=-1).sum(axis=-1).astype(np.int32)
        d = np.where(kids >= 0, d, np.iinfo(np.int32).max)
        node[active] = kids[np.arange(len(active)), d.argmin(axis=1)]
    return node


_native_fns = {}


def _native(name: str, argtypes):
    fn = _native_fns.get(name)
    if fn is None:
        fn = getattr(_kernels.load("vocab_native"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _native_fns[name] = fn
    return fn


_P, _L = ctypes.c_void_p, ctypes.c_long


def parse_vocab_text(path: str):
    """parse_vocab_text_plain in C (csrc/vocab_native.c): the same tuple,
    the same arrays."""
    with open(path, "rb") as f:
        data = f.read()
    cap = data.count(b"\n") + data.count(b"\r") + 2   # lines bound the nodes
    header = np.zeros(4, np.int32)
    parents = np.empty(cap, np.int32)
    descs = np.empty((cap, 32), np.uint8)
    weights = np.empty(cap, np.float32)
    leaves = np.empty(cap, np.uint8)
    n_nodes, bad = ctypes.c_long(0), ctypes.c_long(0)
    fn = _native("parse_vocab_text", [ctypes.c_char_p, _L, _P, _P, _P, _P, _P, _L,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_long)])
    rc = fn(data, len(data), header.ctypes.data, parents.ctypes.data, descs.ctypes.data,
            weights.ctypes.data, leaves.ctypes.data, cap, ctypes.byref(n_nodes),
            ctypes.byref(bad))
    if rc == 1:
        raise ValueError(f"{path}: the header needs four integers (k L scoring weighting)")
    if rc == 2:
        raise ValueError(f"{path}: line {bad.value}: a node field does not parse")
    if rc != 0:
        raise RuntimeError(f"parse_vocab_text: error {rc}")
    n = n_nodes.value
    k, L, scoring, weighting = (int(v) for v in header)
    return (k, L, scoring, weighting, parents[:n].copy(), descs[:n].copy(),
            weights[:n].copy(), leaves[:n].copy())


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """hamming_matrix_plain in C."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != 32 or b.shape[1] != 32:
        raise ValueError(f"hamming_matrix: (N, 32) and (M, 32) descriptors, got "
                         f"{a.shape} and {b.shape}")
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    fn = _native("hamming_matrix", [_P, _L, _P, _L, _P])
    fn(a.ctypes.data, a.shape[0], b.ctypes.data, b.shape[0], out.ctypes.data)
    return out


def vocab_transform(children: np.ndarray, node_desc: np.ndarray,
                    desc: np.ndarray) -> np.ndarray:
    """vocab_transform_plain in C."""
    children = np.ascontiguousarray(children, np.int32)
    node_desc = np.ascontiguousarray(node_desc, np.uint8)
    desc = np.ascontiguousarray(desc, np.uint8)
    if (children.ndim != 2 or node_desc.shape[1:] != (32,) or desc.ndim != 2
            or desc.shape[1] != 32 or len(node_desc) < len(children)):
        raise ValueError(f"vocab_transform: children {children.shape}, node_desc "
                         f"{node_desc.shape}, desc {desc.shape}")
    out = np.empty(desc.shape[0], np.int32)
    fn = _native("vocab_transform", [_P, _L, _L, _P, _P, _L, _P])
    rc = fn(children.ctypes.data, children.shape[0], children.shape[1],
            node_desc.ctypes.data, desc.ctypes.data, desc.shape[0], out.ctypes.data)
    if rc != 0:
        raise IndexError("vocab_transform: a child id lies outside the node table")
    return out


def _majority_descriptor(descs: np.ndarray) -> np.ndarray:
    """Bitwise majority vote (FORB::meanValue)."""
    bits = np.unpackbits(descs, axis=1)  # (N, 256)
    maj = (bits.sum(axis=0) * 2 >= descs.shape[0]).astype(np.uint8)
    return np.packbits(maj)


class Vocabulary:
    def __init__(self, children, node_desc, weights, is_leaf, k, L):
        self.children = children        # (nodes, k) int32, -1 = none
        self.node_desc = node_desc      # (nodes, 32) uint8
        self.weights = weights          # (nodes,) float32 (leaf weights)
        self.is_leaf = is_leaf          # (nodes,) bool
        self.k = k
        self.L = L
        leaf_ids = np.nonzero(is_leaf)[0]
        self.word_of_node = np.full(len(is_leaf), -1, np.int32)
        self.word_of_node[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
        self.n_words = len(leaf_ids)
        self.node_of_word = leaf_ids.astype(np.int32)

    # ------------------------------------------------------------ training

    @staticmethod
    def train(descriptors: np.ndarray, k: int = 10, L: int = 3, seed: int = 0,
              kmeans_iters: int = 8) -> "Vocabulary":
        rng = np.random.default_rng(seed)
        children: List[List[int]] = [[-1] * k]
        node_desc = [np.zeros(32, np.uint8)]
        is_leaf = [False]
        # (node_id, descriptor subset, depth)
        stack = [(0, descriptors, 0)]
        while stack:
            node, descs, depth = stack.pop()
            if depth >= L or len(descs) <= k:
                is_leaf[node] = True
                children[node] = [-1] * k
                continue
            # k-medians: init with random distinct descriptors
            idx = rng.choice(len(descs), size=k, replace=False)
            centers = descs[idx].copy()
            for _ in range(kmeans_iters):
                assign = hamming_matrix(descs, centers).argmin(axis=1)
                new_centers = []
                for c in range(k):
                    members = descs[assign == c]
                    new_centers.append(centers[c] if len(members) == 0
                                       else _majority_descriptor(members))
                new = np.stack(new_centers)
                if (new == centers).all():
                    centers = new
                    break
                centers = new
            assign = hamming_matrix(descs, centers).argmin(axis=1)
            kids = []
            for c in range(k):
                members = descs[assign == c]
                child = len(node_desc)
                node_desc.append(centers[c])
                children.append([-1] * k)
                is_leaf.append(False)
                kids.append(child)
                if len(members) > 0:
                    stack.append((child, members, depth + 1))
                else:
                    is_leaf[child] = True
            children[node] = kids
        voc = Vocabulary(np.array(children, np.int32), np.stack(node_desc),
                         np.zeros(len(node_desc), np.float32), np.array(is_leaf, bool), k, L)
        # TF-IDF weights from the training corpus
        words = voc.transform_words(descriptors)
        counts = np.bincount(voc.word_of_node[words], minlength=voc.n_words).astype(np.float64)
        n_docs = max(len(descriptors), 1)
        idf = np.where(counts > 0, np.log(n_docs / np.maximum(counts, 1)), 0.0)
        voc.weights = np.zeros(len(voc.node_desc), np.float32)
        voc.weights[voc.node_of_word] = idf.astype(np.float32)
        return voc

    @staticmethod
    def synthesize(k: int = 10, L: int = 6, seed: int = 0,
                   flip_bits: int = 40) -> "Vocabulary":
        """A full k^L tree at ORBvoc scale (k=10, L=6 -> 1M leaves) without
        a descriptor corpus: each child's descriptor is its parent's with
        `flip_bits` random bits flipped, so the tree has the coarse-to-fine
        Hamming structure k-medians training produces."""
        rng = np.random.default_rng(seed)
        n_internal = (k ** L - 1) // (k - 1)
        n_nodes = n_internal + k ** L
        node_desc = np.empty((n_nodes, 32), np.uint8)
        node_desc[0] = rng.integers(0, 256, 32)
        children = np.full((n_nodes, k), -1, np.int32)
        is_leaf = np.zeros(n_nodes, bool)
        # level by level: nodes are laid out in BFS order, so level l
        # occupies [ (k^l - 1)/(k-1), (k^{l+1} - 1)/(k-1) )
        start = 0
        for lvl in range(L):
            n_lvl = k ** lvl
            child_start = start + n_lvl
            ids = np.arange(start, start + n_lvl)
            children[ids] = child_start + np.arange(n_lvl * k).reshape(n_lvl, k)
            # child descriptors: parent bits with flip_bits flips each
            kid_bits = np.repeat(np.unpackbits(node_desc[ids], axis=1), k, axis=0)
            flips = rng.integers(0, 256, size=(n_lvl * k, flip_bits))
            rows = np.repeat(np.arange(n_lvl * k), flip_bits)
            kid_bits[rows, flips.ravel()] ^= 1
            node_desc[child_start: child_start + n_lvl * k] = np.packbits(kid_bits, axis=1)
            start = child_start
        is_leaf[n_internal:] = True
        weights = np.zeros(n_nodes, np.float32)
        weights[n_internal:] = rng.uniform(0.2, 1.0, k ** L).astype(np.float32)
        return Vocabulary(children, node_desc, weights, is_leaf, k, L)

    # --------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """Save as .npz (the reference's native vocabulary layout)."""
        np.savez_compressed(path, children=self.children, node_desc=self.node_desc,
                            weights=self.weights, is_leaf=self.is_leaf,
                            k=np.int32(self.k), L=np.int32(self.L))

    def save_dbow2_text(self, path: str) -> None:
        """Write the DBoW2 text format (TemplatedVocabulary::saveToTextFile,
        TemplatedVocabulary.h:1338-1438): header "k L scoring weighting",
        then one line per non-root node in id order, "parent is_leaf
        d0..d31 weight". Ids are creation-ordered (parent < child), so the
        file loads back to the same ids."""
        n = len(self.node_desc)
        table = np.empty((n - 1, 35), np.float64)   # integers < 2^53 stay exact
        table[:, 0] = self._parents()[1:]
        table[:, 1] = self.is_leaf[1:]
        table[:, 2:34] = self.node_desc[1:]
        table[:, 34] = self.weights[1:]
        with open(path, "w") as f:
            # scoring 0 = L1_NORM, weighting 0 = TF_IDF (ORBvoc settings)
            f.write(f"{self.k} {self.L} 0 0\n")
            np.savetxt(f, table, fmt=["%d"] * 34 + ["%.6f"], delimiter=" ")

    @staticmethod
    def load(path: str) -> "Vocabulary":
        """Load a vocabulary: .npz, or DBoW2 text by the .txt extension."""
        if path.endswith(".txt"):
            return Vocabulary.load_dbow2_text(path)
        z = np.load(path)
        return Vocabulary(z["children"], z["node_desc"], z["weights"],
                          z["is_leaf"].astype(bool), int(z["k"]), int(z["L"]))

    @staticmethod
    def load_dbow2_text(path: str) -> "Vocabulary":
        """A DBoW2 text file; each node's children in file order."""
        k, L, _scoring, _weighting, parents, descs, weights, leaves = parse_vocab_text(path)
        n = len(parents)
        children = np.full((n, k), -1, np.int32)
        # child i goes to its parent's next free slot: its rank among the
        # parent's children in id order
        ids = np.arange(1, n)
        par = parents[1:].astype(np.int64)
        order = np.argsort(par, kind="stable")
        first = np.searchsorted(par[order], par[order], side="left")
        slot = np.empty(n - 1, np.int64)
        slot[order] = np.arange(n - 1) - first
        children[par, slot] = ids
        return Vocabulary(children, descs, weights, leaves.astype(bool), k, L)

    # ----------------------------------------------------------- transform

    def transform_words(self, descriptors: np.ndarray) -> np.ndarray:
        """(N, 32) u8 -> (N,) leaf node ids (host tree descent)."""
        return vocab_transform(self.children, self.node_desc, descriptors)

    def transform_words_device(self, descriptors, valid=None, device=None) -> np.ndarray:
        """Device tree descent (ops/bow.py): (N, 32) or (B, N, 32) numpy
        arrays or tensors; leaf node ids as numpy, -1 where `valid` is
        False. Runs on the descriptors' device when they are a tensor, else
        on `device` (CUDA when None)."""
        from ..ops import bow

        return bow.transform_batch(self, descriptors, valid, device)

    def transform_nodes(self, descriptors: np.ndarray, valid: np.ndarray = None,
                        device=False) -> np.ndarray:
        """(N, 32) u8 -> (N,) int64 leaf node ids, -1 where invalid: one
        descent feeds both bow_vector and feature_nodes (DBoW2's
        transform() computes BowVector and FeatureVector in one walk).
        `device`: False for the host descent; True (CUDA) or a torch device
        for the device descent, which descends every row and masks."""
        n = len(descriptors)
        nodes = np.full(n, -1, np.int64)
        idx = np.nonzero(valid)[0] if valid is not None else np.arange(n)
        if len(idx) == 0:
            return nodes
        if device is not False:
            w = self.transform_words_device(descriptors, valid=valid,
                                            device=None if device is True else device)
            nodes[idx] = w[idx]
        else:
            nodes[idx] = self.transform_words(descriptors[idx])
        return nodes

    def bow_vector(self, descriptors: np.ndarray, valid: np.ndarray = None,
                   nodes: np.ndarray = None) -> Dict[int, float]:
        """L1-normalized TF-IDF bag of words {word_id: weight}
        (TemplatedVocabulary::transform with TF_IDF + L1 norm). Pass
        `nodes` from transform_nodes to skip the tree descent."""
        if nodes is None:
            nodes = self.transform_nodes(descriptors, valid)
        nd = nodes[nodes >= 0]
        if len(nd) == 0:
            return {}
        words = self.word_of_node[nd]
        wgts = self.weights[nd]
        keep = (words >= 0) & (wgts > 0)
        if not keep.any():
            return {}
        uw, inv = np.unique(words[keep], return_inverse=True)
        sums = np.bincount(inv, weights=wgts[keep].astype(np.float64))
        norm = sums.sum()
        if norm > 0:
            sums = sums / norm
        return {int(w): float(s) for w, s in zip(uw, sums)}

    def feature_nodes(self, descriptors: np.ndarray, valid: np.ndarray = None,
                      levels_up: int = 4, nodes: np.ndarray = None) -> np.ndarray:
        """(N,) int64 FeatureVector node id per keypoint (-1 invalid): the
        leaf's ancestor at depth L - levels_up (the array form of DBoW2's
        FeatureVector, which SearchByBoW consumes)."""
        if nodes is None:
            nodes = self.transform_nodes(descriptors, valid)
        anc = self._ancestor_at(max(self.L - levels_up, 0))
        out = np.full(len(nodes), -1, np.int64)
        ok = nodes >= 0
        out[ok] = anc[nodes[ok]]
        return out

    def feature_vector(self, descriptors: np.ndarray, valid: np.ndarray = None,
                       levels_up: int = 4, nodes: np.ndarray = None) -> Dict[int, List[int]]:
        """Node-at-level -> feature indices (DBoW2 FeatureVector)."""
        fn = self.feature_nodes(descriptors, valid, levels_up, nodes)
        fv: Dict[int, List[int]] = {}
        for i in np.nonzero(fn >= 0)[0]:
            fv.setdefault(int(fn[i]), []).append(int(i))
        return fv

    def _parents(self):
        if not hasattr(self, "_parent_arr"):
            p = np.full(len(self.node_desc), -1, np.int32)
            src = np.repeat(np.arange(len(self.children), dtype=np.int32),
                            self.children.shape[1])
            dst = self.children.reshape(-1)
            ok = dst >= 0
            p[dst[ok]] = src[ok]
            self._parent_arr = p
        return self._parent_arr

    def _depths(self):
        if not hasattr(self, "_depth_arr"):
            d = np.zeros(len(self.node_desc), np.int32)
            frontier = np.array([0], np.int32)
            depth = 0
            while len(frontier) and depth <= self.L + 1:
                kids = self.children[frontier].reshape(-1)
                frontier = kids[kids >= 0].astype(np.int32)
                depth += 1
                d[frontier] = depth
            self._depth_arr = d
        return self._depth_arr

    def _ancestor_at(self, target_depth: int) -> np.ndarray:
        """(nodes,) int32: each node's ancestor at `target_depth` (the node
        itself if already at or above). Cached per depth."""
        cache = getattr(self, "_anc_cache", None)
        if cache is None:
            cache = self._anc_cache = {}
        if target_depth not in cache:
            p, d = self._parents(), self._depths()
            anc = np.arange(len(p), dtype=np.int32)
            for _ in range(int(d.max(initial=0)) - target_depth):
                deep = d[anc] > target_depth
                if not deep.any():
                    break
                anc[deep] = p[anc[deep]]
            cache[target_depth] = anc
        return cache[target_depth]


def l1_score(bow1: Dict[int, float], bow2: Dict[int, float]) -> float:
    """DBoW2 L1Scoring on L1-normalized vectors:
    s = 0.5 * sum_{common} (|v| + |w| - |v - w|)."""
    if len(bow2) < len(bow1):
        bow1, bow2 = bow2, bow1
    s = 0.0
    for w, v in bow1.items():
        u = bow2.get(w)
        if u is not None:
            s += abs(v) + abs(u) - abs(v - u)
    return 0.5 * s
