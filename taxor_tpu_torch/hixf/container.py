"""Hierarchical interleaved XOR filter (HIXF) container + host traversal.

Mirrors the bookkeeping of
src/hixf/build/hierarchical_interleaved_xor_filter.hpp:
  - ``ixfs``: the flat IXF vector (":113"),
  - ``next_ixf_id[i][b]``: child IXF of merged bin b in IXF i; == i when
    b is not a merged bin (":115-122"),
  - ``bin_to_user[i][b]``: user-bin id of bin b; -1 marks a merged bin
    ("ixf_bin_to_filename_position", ":172-178"),
  - ``user_bin_filenames``.

``membership`` replicates membership_agent::bulk_contains_impl
(":304-340"): per IXF count all bins, sum runs of consecutive bins with the
same user bin (split bins), emit (user_bin, sum) when sum >= threshold,
recurse into merged bins whose own count >= threshold.  Emission order is
the DFS order of the recursion — the search TSV row order depends on it.
It walks in C++ (``native/ref_baseline.cpp``) where the native library
loads, else in numpy (``membership_plain``): a read whose threshold every
merged bin passes visits every IXF, thousands in a large hierarchy.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np

from ..ixf.xor_filter import IXF

U64 = np.uint64
_FLAT_LOCK = threading.Lock()


@dataclass
class HIXF:
    ixfs: list[IXF]
    next_ixf_id: list[np.ndarray]  # int64 [bins] per IXF
    bin_to_user: list[np.ndarray]  # int64 [bins] per IXF, -1 = merged
    user_bin_filenames: list[str]

    @property
    def num_user_bins(self) -> int:
        return len(self.user_bin_filenames)

    def validate(self) -> None:
        assert len(self.ixfs) == len(self.next_ixf_id) == len(self.bin_to_user)
        for i, ixf in enumerate(self.ixfs):
            assert self.next_ixf_id[i].shape[0] == ixf.bin_count
            assert self.bin_to_user[i].shape[0] == ixf.bin_count

    # ------------------------------------------------------------------ #
    # run segmentation (precomputed structure for device + ordering)
    # ------------------------------------------------------------------ #

    def runs_of_ixf(self, i: int):
        """Segment bins of IXF i into maximal runs of equal user-bin id.

        Returns (run_start, run_end_exclusive, run_user) arrays; merged
        bins are single-bin runs with run_user == -1.  Mirrors the
        "end of split bin" walk (hierarchical_interleaved_xor_filter.hpp:
        313-334) — note merged bins always terminate a run even though two
        adjacent merged bins share user id -1.
        """
        b2u = self.bin_to_user[i]
        n = b2u.shape[0]
        starts, ends, users = [], [], []
        b = 0
        while b < n:
            u = int(b2u[b])
            if u < 0:
                starts.append(b)
                ends.append(b + 1)
                users.append(u)
                b += 1
                continue
            e = b + 1
            while e < n and int(b2u[e]) == u:
                e += 1
            starts.append(b)
            ends.append(e)
            users.append(u)
            b = e
        return (
            np.asarray(starts, dtype=np.int64),
            np.asarray(ends, dtype=np.int64),
            np.asarray(users, dtype=np.int64),
        )

    def user_bin_dfs_order(self) -> np.ndarray:
        """rank[user_bin] = position of its leaf run in the recursive
        traversal — used to reproduce the reference's emission order from
        device count matrices."""
        rank = np.full(self.num_user_bins, -1, dtype=np.int64)
        counter = [0]

        def visit(i: int):
            starts, ends, users = self.runs_of_ixf(i)
            for s, u in zip(starts, users):
                if u < 0:
                    visit(int(self.next_ixf_id[i][int(s)]))
                else:
                    if rank[u] == -1:
                        rank[u] = counter[0]
                    counter[0] += 1

        visit(0)
        return rank

    # ------------------------------------------------------------------ #
    # host oracle traversal
    # ------------------------------------------------------------------ #

    def membership(self, hashes: np.ndarray,
                   threshold: int) -> list[tuple[int, int]]:
        """(user_bin, count) pairs in reference emission order, from the
        native walk, or from ``membership_plain`` without the library."""
        from ..native import get_lib

        lib = get_lib()
        if lib is None:
            return self.membership_plain(hashes, threshold)
        hashes = np.ascontiguousarray(hashes, dtype=U64)
        cap = self.num_user_bins
        while True:
            users = np.empty(cap, dtype=np.int32)
            counts = np.empty(cap, dtype=np.int64)
            n = lib.hixf_membership(
                *self._native_args(hashes, threshold),
                users.ctypes.data_as(ctypes.c_void_p),
                counts.ctypes.data_as(ctypes.c_void_p), cap)
            if n <= cap:
                return list(zip(users[:n].tolist(), counts[:n].tolist()))
            cap = n

    def walk(self, hashes: np.ndarray, threshold: int) -> list[int]:
        """The IXFs the walk of ``membership`` visits for one hash list,
        in the order it enters them: the root, then each merged bin's
        child whose run sum reaches ``threshold``.  From the native walk,
        or from ``walk_plain`` without the library."""
        from ..native import get_lib

        lib = get_lib()
        if lib is None:
            return self.walk_plain(hashes, threshold)
        hashes = np.ascontiguousarray(hashes, dtype=U64)
        cap = len(self.ixfs)  # a tree: each IXF is entered at most once
        out = np.empty(cap, dtype=np.int32)
        n = lib.hixf_walk(*self._native_args(hashes, threshold),
                          out.ctypes.data_as(ctypes.c_void_p), cap)
        return out[:n].tolist()

    def _native_args(self, hashes: np.ndarray, threshold: int) -> list:
        """The leading arguments of the native walks: the flat view, the
        hashes (a contiguous uint64 array the caller keeps alive), the
        threshold and whether it is past every count."""
        flat = self._flat()
        impossible = threshold > 2**63 - 1  # past every count
        thr = 0 if impossible else max(int(threshold), -2**63)
        return [*(flat[key].ctypes.data_as(ctypes.c_void_p)
                  for key in ("fp", "fp_off")), flat["n_ixfs"],
                *(flat[key].ctypes.data_as(ctypes.c_void_p)
                  for key in ("bins", "block_len", "seeds", "bin_off",
                              "user_of", "next_ixf")),
                hashes.ctypes.data_as(ctypes.c_void_p), hashes.shape[0],
                thr, int(impossible)]

    def _flat(self) -> dict:
        """The contiguous view of the native walk, made at the first call
        (``native.baseline.flatten_hixf``)."""
        with _FLAT_LOCK:
            flat = self.__dict__.get("_flat_view")
            if flat is None:
                from ..native.baseline import flatten_hixf

                flat = self.__dict__["_flat_view"] = flatten_hixf(self)
            return flat

    def membership_plain(self, hashes: np.ndarray,
                         threshold: int) -> list[tuple[int, int]]:
        """``membership`` in numpy: the recursion above, one IXF's
        ``bulk_count`` at a time."""
        return self._recurse_plain(hashes, threshold)[1]

    def walk_plain(self, hashes: np.ndarray, threshold: int) -> list[int]:
        """``walk`` in numpy (the recursion of ``membership_plain``)."""
        return self._recurse_plain(hashes, threshold)[0]

    def _recurse_plain(self, hashes: np.ndarray, threshold: int):
        """(the IXFs visited, the (user_bin, count) pairs emitted) of the
        reference's recursion, in numpy."""
        seen: list[int] = []
        out: list[tuple[int, int]] = []
        hashes = np.asarray(hashes, dtype=U64)

        def impl(ixf_idx: int):
            seen.append(ixf_idx)
            counts = self.ixfs[ixf_idx].bulk_count(hashes)
            b2u = self.bin_to_user[ixf_idx]
            n = counts.shape[0]
            total = 0
            for b in range(n):
                total += int(counts[b])
                u = int(b2u[b])
                if u < 0:  # merged bin
                    if total >= threshold:
                        impl(int(self.next_ixf_id[ixf_idx][b]))
                    total = 0
                elif b + 1 == n or int(b2u[b + 1]) != u:  # end of split run
                    if total >= threshold:
                        out.append((u, total))
                    total = 0

        impl(0)
        return seen, out

    def bulk_count_users(self, hashes: np.ndarray,
                         threshold: int = 1) -> np.ndarray:
        """Per-user-bin counts (counting_agent semantics,
        hierarchical_interleaved_xor_filter.hpp:434-463)."""
        result = np.zeros(self.num_user_bins, dtype=np.int64)
        for u, c in self.membership(hashes, threshold):
            result[u] = c
        return result
