"""Consensus clustering of patterns — a copy of
cogaps_tpu/parallel/clustering.py, which uses numpy only.

The JAX package cannot be imported where the port runs, so this module
is copied; tests/test_torch_api.py holds each function to its original.

The reference clusters patterns with `cluster::agnes(diss=TRUE, "complete")`
followed by `stats::cutree(k=cut)` (reference: R/DistributedCogaps.R:197-217).
For complete linkage on a precomputed dissimilarity, agnes and classic
agglomerative hierarchical clustering build the identical tree, so we
implement complete-linkage agglomeration + the cutree(k) rule directly in
numpy. Pattern counts are tiny (nSets * nPatterns, tens of columns), so the
O(n^3) loop is irrelevant to performance — determinism is what matters.
"""

from __future__ import annotations

from typing import List

import numpy as np


def complete_linkage(diss: np.ndarray) -> List[tuple]:
    """Agglomerative complete-linkage clustering of an n x n dissimilarity
    matrix. Returns the merge list [(height, members_frozenset), ...] in
    merge order; ties break on the smallest pair indices (matching R's
    deterministic scan order)."""
    n = diss.shape[0]
    active = {i: frozenset([i]) for i in range(n)}
    d = diss.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    # cluster ids: start 0..n-1, new clusters get n, n+1, ...
    next_id = n
    ids = list(range(n))
    merges = []
    # work on a growing distance dict between active cluster ids
    dist = {}
    for i in range(n):
        for j in range(i + 1, n):
            dist[(i, j)] = d[i, j]

    while len(active) > 1:
        # find min-distance active pair, ties -> smallest (i, j)
        best = None
        best_d = np.inf
        for i in sorted(active):
            for j in sorted(active):
                if j <= i:
                    continue
                dij = dist[(min(i, j), max(i, j))]
                if dij < best_d - 1e-15:
                    best_d = dij
                    best = (i, j)
        i, j = best
        members = active[i] | active[j]
        merges.append((best_d, members))
        # complete linkage: d(new, k) = max(d(i,k), d(j,k))
        new = next_id
        next_id += 1
        for k in active:
            if k in (i, j):
                continue
            dik = dist[(min(i, k), max(i, k))]
            djk = dist[(min(j, k), max(j, k))]
            dist[(min(new, k), max(new, k))] = max(dik, djk)
        del active[i], active[j]
        active[new] = members
    del ids
    return merges


def cutree_k(merges: List[tuple], n: int, k: int) -> np.ndarray:
    """R stats::cutree(hclust, k): cut the tree so k clusters remain.
    Applying the first (n - k) merges leaves exactly k clusters; labels are
    assigned 1..k in order of first appearance by leaf index (R semantics).
    """
    k = max(1, min(k, n))
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for _, members in merges[: n - k]:
        it = iter(sorted(members))
        root = find(next(it))
        for m in it:
            parent[find(m)] = root

    labels = np.zeros(n, dtype=np.int64)
    seen = {}
    for leaf in range(n):
        r = find(leaf)
        if r not in seen:
            seen[r] = len(seen) + 1
        labels[leaf] = seen[r]
    return labels


def corcut(all_patterns: np.ndarray, cut: int, min_ns: int) -> List[np.ndarray]:
    """Cluster pattern columns by 1 - correlation distance; drop clusters
    with fewer than min_ns members (reference: R/DistributedCogaps.R:197-217).
    Returns the list of clusters (each a (length, members) column matrix) in
    cutree-label order."""
    with np.errstate(invalid="ignore"):
        corr = np.corrcoef(all_patterns.T)
    dist = 1.0 - corr
    if np.isnan(dist).any():
        raise ValueError("NA values in correlation of patterns")
    n = all_patterns.shape[1]
    if n == 1:
        return [all_patterns.copy()] if min_ns <= 1 else []
    merges = complete_linkage(dist)
    labels = cutree_k(merges, n, cut)
    clusters = []
    for lab in np.unique(labels):
        cols = np.where(labels == lab)[0]
        if len(cols) >= min_ns:
            clusters.append(all_patterns[:, cols])
    return clusters


def corr_to_mean_pattern(cluster: np.ndarray) -> np.ndarray:
    """Correlation of each member pattern to the cluster mean, rounded to 3
    decimals like the reference (R/DistributedCogaps.R:182-186)."""
    mean_pat = cluster.mean(axis=1)
    out = np.empty(cluster.shape[1])
    for j in range(cluster.shape[1]):
        c = np.corrcoef(cluster[:, j], mean_pat)[0, 1]
        out[j] = np.round(c, 3)
    return out


def pattern_match(all_patterns: np.ndarray, cut: int, min_ns: int,
                  max_ns: int):
    """Full consensus pattern matching (reference:
    R/DistributedCogaps.R:144-177): corcut, split clusters larger than
    max_ns in two (recursively), then cor^3-weighted mean patterns rescaled
    to max 1."""
    clusters = corcut(all_patterns, cut, min_ns)

    def split_cluster(lst, index):
        split = corcut(lst[index], 2, min_ns)
        out = list(lst)
        if len(split) == 0:
            # both halves dropped: remove the cluster (cannot keep looping)
            del out[index]
            return out
        out[index] = split[0]
        if len(split) > 1:
            out.append(split[1])
        return out

    idx = [i for i, c in enumerate(clusters) if c.shape[1] > max_ns]
    while idx:
        clusters = split_cluster(clusters, idx[0])
        idx = [i for i, c in enumerate(clusters) if c.shape[1] > max_ns]

    if not clusters:
        raise ValueError("no clusters passed the minNS threshold — "
                         "patterns did not replicate across subsets")

    mean_patterns = []
    for clust in clusters:
        w = corr_to_mean_pattern(clust) ** 3
        wsum = w.sum()
        if wsum <= 0:
            w = np.ones_like(w)
            wsum = w.sum()
        mean_patterns.append((clust * w[None, :]).sum(axis=1) / wsum)
    consensus = np.stack(mean_patterns, axis=1)
    consensus = consensus / np.maximum(consensus.max(axis=0), 1e-30)
    return clusters, consensus.astype(np.float32)
