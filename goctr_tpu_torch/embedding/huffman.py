"""Huffman coding for hierarchical softmax (port of
goctr_tpu/embedding/huffman.py, numpy only, kept as its own copy).

The tree is built from a heap of (count, node id) pairs, ties broken by
node id, and exported as fixed-shape arrays: paths [V, max_depth] of
inner-node ids and codes [V, max_depth] in {0, 1} with a length vector,
so the whole HS loss vectorizes on the device instead of a per-word
pointer walk.
"""
from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np


def build_huffman_paths(counts: Sequence[int],
                        max_depth: int = 100
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(paths [V, depth] int32 inner-node ids (-1 pad), codes [V, depth]
    float32, lengths [V] int32). Inner nodes are numbered 0..V-2."""
    v = len(counts)
    if v == 0:
        return (np.zeros((0, 0), np.int32), np.zeros((0, 0), np.float32),
                np.zeros(0, np.int32))
    if v == 1:
        # degenerate tree: single leaf, zero-length code
        return (np.full((1, 1), -1, np.int32), np.zeros((1, 1), np.float32),
                np.zeros(1, np.int32))

    # heap of (count, tiebreak, node_id); leaves 0..v-1, inner v..2v-2
    heap = [(int(c), i, i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.zeros(2 * v - 1, dtype=np.int64)
    code_bit = np.zeros(2 * v - 1, dtype=np.int8)
    next_id = v
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        code_bit[n2] = 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = next_id - 1

    depth_cap = max_depth
    paths = np.full((v, depth_cap), -1, dtype=np.int32)
    codes = np.zeros((v, depth_cap), dtype=np.float32)
    lengths = np.zeros(v, dtype=np.int32)
    for leaf in range(v):
        # climb to root collecting (inner_node, bit); then reverse
        node = leaf
        rev_nodes: list[int] = []
        rev_bits: list[int] = []
        while node != root:
            p = parent[node]
            rev_nodes.append(int(p) - v)   # inner-node index 0..v-2
            rev_bits.append(int(code_bit[node]))
            node = p
        depth = min(len(rev_nodes), depth_cap)
        for d in range(depth):
            paths[leaf, d] = rev_nodes[len(rev_nodes) - 1 - d]
            codes[leaf, d] = rev_bits[len(rev_bits) - 1 - d]
        lengths[leaf] = depth
    used = int(lengths.max()) if v else 0
    return paths[:, :used], codes[:, :used], lengths
