"""Permutohedral-lattice high-dimensional Gaussian filtering (vectorized).

This is the filtering engine behind dense CRF inference (Adams et al. 2010,
as used by Kraehenbuehl & Koltun's densecrf — the C++ library the reference
consumes through pydensecrf, post_processing/crf_refine.py:110-129). The
implementation reproduces the densecrf permutohedral semantics: simplex
embedding with the canonical scale factors, splat with barycentric weights,
[0.5, 1, 0.5] blur along each of the d+1 lattice directions with a zero
virtual node for missing neighbors, and slice with the
alpha = 1 / (1 + 2^-d) normalization.

Pure numpy, fully vectorized (np.unique for lattice-point hashing); used by
postproc/crf.py. A copy of unsupervised_detection_tpu/postproc/permutohedral.py,
which the port does not import.
"""

from __future__ import annotations

import numpy as np


class PermutohedralLattice:
    def __init__(self, features: np.ndarray):
        """features: (N, d) float positions (already divided by sigmas)."""
        n, d = features.shape
        self.n = n
        self.d = d

        # --- elevate into the hyperplane H_d ---------------------------
        inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
        scale = inv_std_dev / np.sqrt((np.arange(d) + 1.0) * (np.arange(d) + 2.0))
        cf = features * scale[None, :]
        elevated = np.zeros((n, d + 1))
        sm = np.zeros(n)
        for j in range(d, 0, -1):
            elevated[:, j] = sm - j * cf[:, j - 1]
            sm = sm + cf[:, j - 1]
        elevated[:, 0] = sm

        # --- nearest remainder-0 lattice point -------------------------
        v = elevated / (d + 1)
        up = np.ceil(v) * (d + 1)
        down = np.floor(v) * (d + 1)
        rem0 = np.where(up - elevated < elevated - down, up, down)
        sum_val = (rem0.sum(axis=1) / (d + 1)).round().astype(np.int64)

        # --- rank differential coordinates -----------------------------
        diff = elevated - rem0
        # rank[i][j] = how many k have (diff[k] > diff[j]) (ties by index)
        order = np.argsort(-diff, axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(
            rank, order, np.broadcast_to(np.arange(d + 1), (n, d + 1)).copy(), axis=1
        )
        rank = rank + sum_val[:, None]
        low = rank < 0
        high = rank > d
        rank = rank + (d + 1) * low - (d + 1) * high
        rem0 = rem0 + (d + 1) * low - (d + 1) * high

        # --- barycentric coordinates ------------------------------------
        bary = np.zeros((n, d + 2))
        delta = (elevated - rem0) / (d + 1)
        rows = np.repeat(np.arange(n), d + 1)
        idx0 = (d - rank).ravel()
        np.add.at(bary, (rows, idx0), delta.ravel())
        np.add.at(bary, (rows, idx0 + 1), -delta.ravel())
        bary[:, 0] += 1.0 + bary[:, d + 1]
        self.barycentric = bary[:, : d + 1]  # (n, d+1)

        # --- splat keys for the d+1 simplex corners ----------------------
        # Corner `remainder` has key rem0[:d] + remainder, decremented by
        # (d+1) where rank >= d+1-remainder.
        keys = np.zeros((n, d + 1, d), np.int64)
        rem0_short = rem0[:, :d].astype(np.int64)
        rank_short = rank[:, :d]
        for remainder in range(d + 1):
            keys[:, remainder, :] = rem0_short + remainder
            keys[:, remainder, :] -= (d + 1) * (rank_short >= d + 1 - remainder)

        flat_keys = keys.reshape(n * (d + 1), d)
        unique_keys, inverse = np.unique(flat_keys, axis=0, return_inverse=True)
        self.m = unique_keys.shape[0]
        self.offsets = inverse.reshape(n, d + 1)  # (n, d+1) lattice indices

        # --- blur neighbor table -----------------------------------------
        # Along axis j: n1 = key + 1 except dim j which gets -d;
        #               n2 = key - 1 except dim j which gets +d.
        # Missing neighbors -> virtual zero node (index m).
        key_to_idx = {tuple(k): i for i, k in enumerate(unique_keys)}
        ones = np.ones(d, np.int64)
        self.blur_n1 = np.full((d + 1, self.m), self.m, np.int64)
        self.blur_n2 = np.full((d + 1, self.m), self.m, np.int64)
        for j in range(d + 1):
            off1 = ones.copy()
            off2 = -ones.copy()
            if j < d:
                off1[j] = -d
                off2[j] = d
            n1_keys = unique_keys + off1
            n2_keys = unique_keys + off2
            for i in range(self.m):
                self.blur_n1[j, i] = key_to_idx.get(tuple(n1_keys[i]), self.m)
                self.blur_n2[j, i] = key_to_idx.get(tuple(n2_keys[i]), self.m)

        self.alpha = 1.0 / (1.0 + 2.0 ** (-d))

    def compute(self, values: np.ndarray, reverse: bool = False) -> np.ndarray:
        """Filter (N, C) values through the lattice."""
        n, c = values.shape
        assert n == self.n
        d = self.d

        # splat
        lattice = np.zeros((self.m + 1, c))
        for k in range(d + 1):
            np.add.at(lattice, self.offsets[:, k],
                      self.barycentric[:, k : k + 1] * values)

        # blur (zero virtual node stays zero)
        axes = range(d, -1, -1) if reverse else range(d + 1)
        for j in axes:
            n1 = lattice[self.blur_n1[j]]
            n2 = lattice[self.blur_n2[j]]
            lattice[: self.m] = lattice[: self.m] + 0.5 * (n1 + n2)
            lattice[self.m] = 0.0

        # slice
        out = np.zeros((n, c))
        for k in range(d + 1):
            out += self.barycentric[:, k : k + 1] * lattice[self.offsets[:, k]]
        return out * self.alpha
