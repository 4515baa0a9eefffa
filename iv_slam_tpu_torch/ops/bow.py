"""Vocabulary-tree descent on the device.

Port of ``iv_slam_tpu/ops/bow.py``. The reference's DBoW2 transform walks
the tree one descriptor at a time on the CPU
(TemplatedVocabulary.h transform: per level, the Hamming argmin over the
node's k children). Here a whole frame, or a batch of frames, descends
together: per level, a gather of every row's children descriptors, their
Hamming distances through ``ops/hamming.py`` and a first-index argmin.
The reference runs these as XLA ops, not a Pallas kernel, and so does the
port (torch ops).

Semantics equal the host descent (``slam/vocabulary.py::vocab_transform``):
descent stops at nodes with no children (children[node, 0] < 0), ties
pick the first minimal child (valid children are stored at the front of
each row).
"""

from __future__ import annotations

import numpy as np
import torch

from .hamming import hamming_matrix

INF = 1 << 30


def transform_words(children: torch.Tensor, node_desc: torch.Tensor,
                    desc: torch.Tensor, depth: int) -> torch.Tensor:
    """children (nodes, k) int32 (-1 = none, valid at the front), node_desc
    (nodes, 32) u8, desc (N, 32) u8 -> (N,) int32 leaf node ids after at
    most `depth` levels."""
    node = torch.zeros(desc.shape[0], dtype=torch.long, device=desc.device)
    for _ in range(depth):
        kids = children[node]                                        # (N, k)
        kd = node_desc[torch.clamp(kids, min=0).long()]             # (N, k, 32)
        dist = hamming_matrix(desc[:, None, :], kd)[:, 0, :]         # (N, k)
        dist = torch.where(kids >= 0, dist, INF)
        best = torch.gather(kids, 1, torch.argmin(dist, dim=1, keepdim=True))[:, 0]
        node = torch.where(kids[:, 0] < 0, node, best.long())
    return node.to(torch.int32)


def _dev_tree(vocabulary, device: torch.device):
    """The (children, node_desc) tables on `device`, uploaded once per
    vocabulary and device (a 1M-leaf tree is ~80 MB)."""
    cache = vocabulary.__dict__.setdefault("_dev_tree", {})
    if device not in cache:
        cache[device] = (torch.as_tensor(vocabulary.children).to(device),
                         torch.as_tensor(vocabulary.node_desc).to(device))
    return cache[device]


def transform_batch(vocabulary, desc, valid=None, device=None) -> np.ndarray:
    """Device tree descent for (N, 32) or (B, N, 32) descriptors (numpy or
    a tensor, whose device is used) -> leaf node ids as numpy; rows where
    `valid` is False -> -1. Numpy input runs on `device` (CUDA when None)."""
    if isinstance(desc, torch.Tensor):
        dev = desc.device
    else:
        from ..slam import resolve_device

        dev = resolve_device(device, "transform_words_device")
    d = torch.as_tensor(np.asarray(desc) if not isinstance(desc, torch.Tensor) else desc)
    d = d.to(dev)
    children, node_desc = _dev_tree(vocabulary, dev)
    words = transform_words(children, node_desc, d.reshape(-1, d.shape[-1]),
                            int(vocabulary.L)).cpu().numpy()
    if valid is not None:
        words = np.where(np.asarray(valid).reshape(-1), words, -1)
    return words.reshape(d.shape[:-1]) if d.ndim == 3 else words
