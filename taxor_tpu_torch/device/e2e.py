"""Fused search steps on device: packed reads in, top-k bins out.

Counterpart of ``taxor_tpu/device/e2e.py`` for the syncmer scheme:
``fused_e2e_step`` on a flat (single-IXF) index,

    2-bit packed reads -> K1 (extraction, dedup, wyhash)
      -> K2 (probe positions, probe/count) -> run sums -> top-k

and ``make_hixf_e2e_grouped_fn`` on a hierarchical index, where the
probe runs once per group of IXFs with a per-read descent mask (see its
docstring).

The packed int32 [R, 2*topk + 2] result is the reference's: top-k raw
run sums descending, their user bins, the per-read unique-hash count and
the pre-dedup emission count.  Thresholds and the exact float64 0.8*max
rule stay on the host (search/pipeline._pairs_from_e2e).

Three replacements against the JAX step:
  - run sums: exact integer sums over run offsets, where the TPU needed a
    HIGHEST-precision float one-hot matmul to stay exact above 256: on a
    descent group K2n sums each subgroup's runs in the kernel
    (probe_run_sums_grouped; a group wider than 512 bins takes K2's
    counts and an int64 segment sum); on a flat index an int64 segment
    sum of the counts, or the column slice where its runs are single
    bins;
  - top-k: a stable descending sort sliced to k, which keeps
    ``lax.top_k``'s lower-index-first order among ties (``torch.topk``
    does not promise it);
  - no tie rescue: K1 is exact for every read.

``USE_FUSED_EXTRACT = False`` swaps K1 for the split engine (the JAX
package's scan-exact path); the output is the same.
"""

from __future__ import annotations

import threading

import torch

from ..hash.device_syncmer import emission_min_gap
from .extract import hashes_of_kmers, syncmer_hashes, syncmer_track
from .probe import probe_counts, probe_run_sums_grouped, segment_sums
from .sort import dedup_fused

# Extraction engine of both steps, as in the JAX package: True runs K1
# (extraction, dedup and wyhash in one kernel); False runs the split
# engine, the tracker kernel syncmer_track, then the dedup kernel K3
# (dedup_fused) and the wyhash as tensor ops.  Both give the same
# output; flip it to A/B them.
USE_FUSED_EXTRACT = True


def _syncmer_hashes(packed, lengths, k: int, s: int, t: int, hcap: int):
    """(hi, lo, valid, n_unique, n_emit) of the wyhashed sorted syncmer
    k-mers (device/extract.py's contract) from the engine that
    USE_FUSED_EXTRACT selects."""
    if USE_FUSED_EXTRACT:
        return syncmer_hashes(packed, lengths, k, s, t, hcap)
    kmer, emit = syncmer_track(packed, lengths, k, s, t)
    srt, valid, n_unique, n_emit = dedup_fused(kmer, emit, hcap,
                                               emission_min_gap(k, s, t))
    return (*hashes_of_kmers(srt, valid), valid, n_unique, n_emit)


def run_sums(counts: torch.Tensor, run_offsets: torch.Tensor,
             prefix_runs: int = 0) -> torch.Tensor:
    """int32 [R, n_runs] sums of bins [offsets[j], offsets[j+1]).
    prefix_runs: every run is one bin at its own index, so the sums are
    the first columns."""
    if prefix_runs:
        return counts[:, :prefix_runs]
    starts = run_offsets[:-1]
    return segment_sums(counts[None], torch.zeros_like(starts), starts,
                        run_offsets[1:]).T


def topk_desc(vs: torch.Tensor, run_users: torch.Tensor, topk: int):
    """(vals, users) int32 [R, topk]: the k largest of vs per row, lower
    index first among equals, padded with -1; users are -1 where the
    value is negative."""
    kk = min(topk, vs.shape[1])
    vals, idx = torch.sort(vs, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :kk], idx[:, :kk]
    users = torch.where(vals >= 0, run_users[idx],
                        torch.full_like(vals, -1))
    if kk < topk:
        pad = torch.full((vs.shape[0], topk - kk), -1, dtype=vals.dtype,
                         device=vals.device)
        vals = torch.cat([vals, pad], dim=1)
        users = torch.cat([users, pad], dim=1)
    return vals, users


def _check_scheme(name: str, scheme_kind: str, scale_thresh: int,
                  descend_all: bool = False) -> None:
    if scheme_kind != "syncmer" or scale_thresh or descend_all:
        raise NotImplementedError(
            f"{name}: minimizer/k-mer extraction, FracMinHash scaling and "
            "the descend-all chain-min mode are not ported yet (ROADMAP "
            "A.7)")


def fused_e2e_step(table: torch.Tensor, packed: torch.Tensor,
                   lengths: torch.Tensor, run_offsets: torch.Tensor,
                   run_users: torch.Tensor, seed: int, block_length: int, *,
                   k: int, s: int, t: int, hcap: int, topk: int,
                   scheme_kind: str = "syncmer", scale_thresh: int = 0,
                   prefix_runs: int = 0) -> torch.Tensor:
    """Packed int32 [R, 2*topk + 2]: [:, :topk] descending raw run sums,
    [:, topk:2*topk] their user bins (-1 for merged runs and padding),
    [:, -2] unique hashes per read, [:, -1] emissions before dedup
    (> hcap => host fallback).

    table uint8 [S, Bpad]; packed uint8 [R, L/4] and lengths int32 [R]
    (pack_reads); run_offsets int64 [n_runs + 1]; run_users int32
    [n_runs]; all on one device."""
    _check_scheme("fused_e2e_step", scheme_kind, scale_thresh)
    hi, lo, valid, n_unique, n_emit = _syncmer_hashes(packed, lengths, k, s,
                                                      t, hcap)
    counts = probe_counts(hi, lo, valid, table, seed, block_length,
                          route="fused")
    sums = run_sums(counts, run_offsets, prefix_runs)
    vs = torch.where(run_users[None, :] >= 0, sums, torch.full_like(sums, -1))
    vals, users = topk_desc(vs, run_users, topk)
    return torch.cat([vals, users, n_unique[:, None], n_emit[:, None]],
                     dim=1)


class ActivityStats:
    """Active (subgroup, read) pairs over all pairs probed by the grouped
    step: a device-side sum, read once at the end (no sync per batch)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.active = None
            self.total = 0

    def add(self, act_mat: torch.Tensor) -> None:
        n = act_mat.sum(dtype=torch.int64)
        with self._lock:
            self.active = n if self.active is None else self.active + n
            self.total += act_mat.numel()

    def share(self) -> float:
        with self._lock:
            return (0.0 if not self.total
                    else int(self.active) / self.total)


def descend(groups, n_nodes: int, hi, lo, valid, thr,
            stats: ActivityStats | None = None, upto: int | None = None):
    """The level-grouped descent of K1's hashes (hi, lo, valid [R, H])
    with per-read thresholds thr int32 [R].  Returns the leaf values
    [n_leaves, R] of each group (the leaf run sums, -1 where the leaf's
    IXF was not descended); with ``upto``, the activity [G, R] that group
    ``upto`` would be probed with.

    The activity of every IXF is one row of a [n_nodes, R] mask indexed
    by BFS position; each group's bookkeeping (the JAX ``_emit_members``
    loop over members) is a few gathers over index tensors, so a group
    costs the same handful of launches whatever its member count."""
    R = hi.shape[0]
    active = torch.zeros((n_nodes, R), dtype=torch.bool, device=hi.device)
    active[0] = True
    leaf_vals = []
    for gi, g in enumerate(groups):
        G = g["tables"].shape[0]
        act_mat = torch.zeros((G, R), dtype=torch.int32,
                              device=hi.device).index_add_(
            0, g["member_sub"], active[g["member_bfs"]].to(torch.int32)) > 0
        if gi == upto:
            return act_mat
        if stats is not None:
            stats.add(act_mat)
        sums = probe_run_sums_grouped(hi, lo, valid, g["tables"], act_mat,
                                      g["run_off"], g["run_s"], g["run_e"],
                                      g["seed"], g["bl"], route="fused")
        if g["child_bfs"].numel():
            active[g["child_bfs"]] = active[g["child_parent"]] & (
                sums[g["child_run"]] >= thr[None, :])
        if g["leaf_run"].numel():
            leaf_vals.append(torch.where(active[g["leaf_bfs"]],
                                         sums[g["leaf_run"]], -1))
    if upto is not None:
        raise IndexError(f"no group {upto}")
    return leaf_vals


def make_hixf_e2e_grouped_fn(groups, leaf_users: torch.Tensor, k: int,
                             s: int, t: int, topk: int,
                             scheme_kind: str = "syncmer",
                             scale_thresh: int = 0,
                             descend_all: bool = False,
                             stats: ActivityStats | None = None):
    """Fused hierarchical search with level-grouped probing (the JAX
    ``make_hixf_e2e_grouped_fn``, syncmer scheme, count-indexed
    thresholds).  Returns ``run(packed, lengths, thr_table, hcap)`` ->
    packed int32 [R, 2*topk + 2]: the top-k leaf run sums descending (-1
    where the leaf's IXF was not descended), their user bins, the unique
    hash count and the emission count per read.

    K1 (or the split engine) extracts the hashes once.  Then, per group
    in order (ancestors before descendants, ``descend``): the group's G
    subgroup tables [G, S, Bpad] probe as one launch that sums each
    subgroup's runs (probe_run_sums_grouped: K2n probes only the active
    pairs, each subgroup with the OR of its members' descent masks, and
    writes [n_runs, R] sums, no dense counts; a group wider than 512 bins
    takes K2's counts and their segment sums); each merged run activates
    its child where ``active & (sum >= thr_table[n_unique])``; the leaf
    runs give the leaf values.  Top-k runs over the leaf columns concatenated
    in group, member, run order, with the stable sort of ``topk_desc``,
    which breaks ties as ``lax.top_k`` does.

    groups: DeviceHIXF.upload_groups dicts: tables uint8 [G, S, Bpad],
      seed, bl, and int64 index tensors: run_off (the CSR [G + 1] of each
      subgroup's runs), run_s/run_e (each run's column range in its
      subgroup's table), member_bfs/member_sub (each member's
      BFS position and subgroup), child_bfs/child_parent/child_run (each
      merged run's child, its parent member and the run), leaf_bfs/
      leaf_run (each leaf run's member and the run); members, the host
      member tuples, give the BFS positions' range.
    leaf_users: int32 [n_leaves], the user bin of each leaf column."""
    _check_scheme("make_hixf_e2e_grouped_fn", scheme_kind, scale_thresh,
                  descend_all)
    n_nodes = 1 + max(m[0] for g in groups for m in g["members"])

    def run(packed, lengths, thr_table, hcap: int) -> torch.Tensor:
        hi, lo, valid, n_unique, n_emit = _syncmer_hashes(packed, lengths,
                                                          k, s, t, hcap)
        thr = thr_table[n_unique.clamp(0, thr_table.shape[0] - 1).long()]
        leaf_vals = descend(groups, n_nodes, hi, lo, valid, thr, stats)
        vals, users = topk_desc(torch.cat(leaf_vals).T, leaf_users, topk)
        return torch.cat([vals, users, n_unique[:, None], n_emit[:, None]],
                         dim=1)

    return run
