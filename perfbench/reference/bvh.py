"""SAH BVH build + DFS flatten (host side, NumPy).

Semantics-compatible rebuild of the reference builder
(reference src/bvhtree.cpp:21-182, src/boundingbox.h/.cpp):

* one global top-down tree over ALL scene triangles (built at load,
  scene.cpp:40-44), 9-bucket SAH on the longest centroid axis,
  MaxPrimsInNode = 10;
* leaf when 1 tri, degenerate centroid axis, or SAH prefers a leaf
  (bvhtree.cpp:34-58, 108-122);
* triangles are reordered into leaf order (bvhtree.cpp:173) so every leaf
  is a CONTIGUOUS triangle range — this is what makes the TPU traversal
  kernels dynamic-slice-friendly;
* flattened to a preorder DFS array where the left child of node i is node
  i+1 and the right child index is stored (bvhtree.cpp:128-145,
  bvhtree.h:48-54).

Replicated quirk: the reference's box-union operator treats an exactly
all-zero box as "empty" on the LEFT side only (boundingbox.h:36-50); a
zero box on the right side drags the union to the origin. The SAH bucket
bounds start as zero boxes, so this affects split choices; we match it so
tree shapes (and hence traversal order / tie-breaking) agree.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

MAX_PRIMS_IN_NODE = 10   # bvhtree.cpp:5
N_BUCKETS = 9            # bvhtree.cpp:71


def _union_box(a_min, a_max, b_min, b_max):
    """a || b with the reference's zero-left-box special case."""
    if not (np.any(a_min) or np.any(a_max)):
        return b_min.copy(), b_max.copy()
    return np.minimum(a_min, b_min), np.maximum(a_max, b_max)


def _area(bmin, bmax) -> float:
    d = bmax - bmin
    return float(2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]))


def _longest_axis(bmin, bmax) -> int:
    d = bmax - bmin
    if d[0] > d[1] and d[0] > d[2]:
        return 0
    return 1 if d[1] > d[2] else 2


@dataclasses.dataclass
class FlatBVH:
    """Preorder-flattened BVH as SoA arrays (BVH_ArrNode equivalent)."""
    bounds_min: np.ndarray   # (N, 3) f32
    bounds_max: np.ndarray   # (N, 3) f32
    prim_count: np.ndarray   # (N,) i32; > 0 marks a leaf
    axis: np.ndarray         # (N,) i32; split axis of interior nodes
    prim_offset: np.ndarray  # (N,) i32; first triangle (leaf, reordered ids)
    right_child: np.ndarray  # (N,) i32; right child index (interior)


class _Builder:
    def __init__(self, tri_min: np.ndarray, tri_max: np.ndarray):
        self.pmin = tri_min.astype(np.float32)
        self.pmax = tri_max.astype(np.float32)
        self.centroid = (0.5 * (self.pmin + self.pmax)).astype(np.float32)
        self.perm = np.arange(tri_min.shape[0], dtype=np.int64)  # primitive[i].index
        self.order: list = []      # orderedTris: original tri indices in leaf order
        # flat node records appended in preorder during build+flatten
        self.nmin: list = []
        self.nmax: list = []
        self.count: list = []
        self.axis: list = []
        self.poff: list = []
        self.rchild: list = []

    def _emit(self, bmin, bmax, count, axis, poff):
        idx = len(self.nmin)
        self.nmin.append(bmin)
        self.nmax.append(bmax)
        self.count.append(count)
        self.axis.append(axis)
        self.poff.append(poff)
        self.rchild.append(-1)
        return idx

    def _make_leaf(self, start, end, bmin, bmax) -> int:
        first = len(self.order)
        self.order.extend(self.perm[start:end].tolist())
        return self._emit(bmin, bmax, end - start, -1, first)

    def build(self, start: int, end: int) -> int:
        """Build(primitive, start, end) + DFS flatten fused: we emit nodes
        in preorder as we recurse, which reproduces DFSBVHTree's layout."""
        idx = self.perm[start:end]
        bmin = self.pmin[idx].min(axis=0)
        bmax = self.pmax[idx].max(axis=0)
        # reference unions sequentially with the zero-box quirk; a plain
        # min/max differs only if some triangle bbox is exactly the zero box
        # (degenerate tri at the origin) — guard for exactness:
        zero = ~(np.any(self.pmin[idx], axis=1) | np.any(self.pmax[idx], axis=1))
        if zero.any() and not zero.all():
            nz = idx[~zero]
            bmin = self.pmin[nz].min(axis=0)
            bmax = self.pmax[nz].max(axis=0)
            first_nonzero = int(np.argmax(~zero))
            if zero[first_nonzero + 1:].any():
                # a zero box on the RIGHT of a non-zero accumulator drags
                # the union to the origin (boundingbox.h:43-48)
                bmin = np.minimum(bmin, 0)
                bmax = np.maximum(bmax, 0)

        ntris = end - start
        if ntris == 1:
            return self._make_leaf(start, end, bmin, bmax)

        cmin = self.centroid[idx].min(axis=0)
        cmax = self.centroid[idx].max(axis=0)
        axi = _longest_axis(cmin, cmax)
        if cmax[axi] == cmin[axi]:
            return self._make_leaf(start, end, bmin, bmax)

        if ntris == 2:
            # nth_element on 2 elements: smaller centroid first (bvhtree.cpp:62-67)
            if self.centroid[self.perm[start], axi] > self.centroid[self.perm[start + 1], axi]:
                self.perm[start], self.perm[start + 1] = (
                    self.perm[start + 1], self.perm[start])
            mid = start + 1
        else:
            c = self.centroid[idx, axi]
            off = np.where(cmax[axi] > cmin[axi],
                           (c - cmin[axi]) / (cmax[axi] - cmin[axi]),
                           c - cmin[axi])
            b = (N_BUCKETS * off).astype(np.int64)
            b[b == N_BUCKETS] = N_BUCKETS - 1

            # per-bucket bounds/counts (zero-box initialized, quirk applies)
            reg_min = np.zeros((N_BUCKETS, 3), np.float32)
            reg_max = np.zeros((N_BUCKETS, 3), np.float32)
            reg_cnt = np.zeros(N_BUCKETS, np.int64)
            for k in range(N_BUCKETS):
                sel = idx[b == k]
                reg_cnt[k] = sel.size
                if sel.size:
                    reg_min[k] = self.pmin[sel].min(axis=0)
                    reg_max[k] = self.pmax[sel].max(axis=0)

            denom = _area(bmin, bmax)
            costs = np.empty(N_BUCKETS - 1, np.float64)
            for i in range(N_BUCKETS - 1):
                amin = np.zeros(3, np.float32); amax = np.zeros(3, np.float32)
                ca = 0
                for j in range(i + 1):
                    amin, amax = _union_box(amin, amax, reg_min[j], reg_max[j])
                    ca += reg_cnt[j]
                bmin2 = np.zeros(3, np.float32); bmax2 = np.zeros(3, np.float32)
                cb = 0
                for j in range(i + 1, N_BUCKETS):
                    bmin2, bmax2 = _union_box(bmin2, bmax2, reg_min[j], reg_max[j])
                    cb += reg_cnt[j]
                # zero-area node bounds give inf cost -> leaf, same as C++ floats
                with np.errstate(divide="ignore", invalid="ignore"):
                    costs[i] = 1.0 + (ca * _area(amin, amax) + cb * _area(bmin2, bmax2)) / denom

            split = int(np.argmin(costs))  # first min (bvhtree.cpp:99-106)
            if costs[split] < ntris or ntris > MAX_PRIMS_IN_NODE:
                left = idx[b <= split]
                right = idx[b > split]
                self.perm[start:end] = np.concatenate([left, right])
                mid = start + left.size
            else:
                return self._make_leaf(start, end, bmin, bmax)

        node = self._emit(bmin, bmax, 0, axi, -1)
        self.build(start, mid)
        self.rchild[node] = self.build(mid, end)
        return node

    def finish(self):
        return FlatBVH(
            bounds_min=np.asarray(self.nmin, np.float32).reshape(-1, 3),
            bounds_max=np.asarray(self.nmax, np.float32).reshape(-1, 3),
            prim_count=np.asarray(self.count, np.int32),
            axis=np.asarray(self.axis, np.int32),
            prim_offset=np.asarray(self.poff, np.int32),
            right_child=np.asarray(self.rchild, np.int32),
        ), np.asarray(self.order, np.int64)


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray):
    """Build the global BVH.

    Returns (FlatBVH, order) where `order` maps new (leaf-contiguous)
    triangle position -> original triangle index, i.e. the tris.swap()
    reordering of bvhtree.cpp:173. The arrays equal those of the JAX
    package's builder (native C++ or NumPy), which this mirrors.
    """
    n = int(tri_min.shape[0])
    if n == 0:
        empty = FlatBVH(*(np.zeros((0, 3), np.float32),) * 2,
                        prim_count=np.zeros(0, np.int32),
                        axis=np.zeros(0, np.int32),
                        prim_offset=np.zeros(0, np.int32),
                        right_child=np.zeros(0, np.int32))
        return empty, np.zeros(0, np.int64)
    limit = max(10000, 64 * n)
    if sys.getrecursionlimit() < limit:
        sys.setrecursionlimit(limit)
    b = _Builder(tri_min, tri_max)
    b.build(0, n)
    return b.finish()
