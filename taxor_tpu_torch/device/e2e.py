"""Fused search steps on device: packed reads in, top-k bins out.

Counterpart of ``taxor_tpu/device/e2e.py``: ``fused_e2e_step`` on a flat
(single-IXF) index,

    2-bit packed reads -> extraction (K1 for syncmers, K5 for minimisers
      and plain k-mers) [-> FracMinHash keep]
      -> K2 (probe positions, probe/count) -> run sums -> top-k

and ``make_hixf_e2e_grouped_fn`` on a hierarchical index, where the
probe runs once per group of IXFs with a per-read descent mask, or on
every pair in the descend-all mode of length-dependent thresholds (see
its docstring).

The packed int32 [R, 2*topk + 2] result is the reference's: top-k raw
run sums descending, their user bins, the per-read hash count and the
emission count.  Thresholds and the exact float64 0.8*max rule stay on
the host (search/pipeline._pairs_from_e2e).

The schemes, as in the JAX step: syncmers hash through K1 (wyhashed,
deduplicated, hcap slots); minimisers and plain k-mers through K5 (the
XOR-seeded values probe as they are, duplicates kept, H = L, n_unique =
n_emit); with a FracMinHash scaling, the keep (``extract.scaling_keep``)
drops the hashes whose wyhash64 exceeds the integer threshold and
n_unique counts the rest: in K5 itself, or as tensor ops after K1.

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
from .extract import (hashes_of_kmers, minimizer_kmers, scaling_keep,
                      syncmer_hashes, syncmer_track)
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


def _hashes(packed, lengths, scheme_kind: str, k: int, s: int, t: int,
            window: int, hcap: int, scale_thresh: int):
    """(hi, lo, valid, n_unique, n_emit) of the step's scheme: K1 (or the
    split engine) for syncmers, then the FracMinHash keep as tensor ops
    where scale_thresh is set; K5 for minimisers and plain k-mers (hcap
    is then L), the keep computed in the kernel."""
    if scheme_kind != "syncmer":
        hi, lo, valid, n_emit, n_unique = minimizer_kmers(
            packed, lengths, k, window, scale_thresh)
        return hi, lo, valid, n_unique, n_emit
    hi, lo, valid, n_unique, n_emit = _syncmer_hashes(packed, lengths, k, s,
                                                      t, hcap)
    if scale_thresh:
        valid = valid & scaling_keep(hi, lo, scale_thresh)
        n_unique = valid.sum(dim=1, dtype=torch.int32)
    return hi, lo, valid, n_unique, n_emit


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


def _pad(x: torch.Tensor, topk: int) -> torch.Tensor:
    """x [R, kk] padded with -1 to [R, topk]."""
    if x.shape[1] == topk:
        return x
    pad = torch.full((x.shape[0], topk - x.shape[1]), -1, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


def topk_idx(vs: torch.Tensor, topk: int):
    """(vals, idx) [R, min(topk, n)]: the k largest of vs per row, lower
    index first among equals."""
    kk = min(topk, vs.shape[1])
    vals, idx = torch.sort(vs, dim=1, descending=True, stable=True)
    return vals[:, :kk], idx[:, :kk]


def topk_desc(vs: torch.Tensor, run_users: torch.Tensor, topk: int):
    """(vals, users) int32 [R, topk]: the k largest of vs per row, lower
    index first among equals, padded with -1; users are -1 where the
    value is negative."""
    vals, idx = topk_idx(vs, topk)
    users = torch.where(vals >= 0, run_users[idx],
                        torch.full_like(vals, -1))
    return _pad(vals, topk), _pad(users, topk)


def fused_e2e_step(table: torch.Tensor, packed: torch.Tensor,
                   lengths: torch.Tensor, run_offsets: torch.Tensor,
                   run_users: torch.Tensor, seed: int, block_length: int, *,
                   k: int, s: int, t: int, hcap: int, topk: int,
                   scheme_kind: str = "syncmer", window: int = 0,
                   scale_thresh: int = 0, prefix_runs: int = 0,
                   gather=None, reduce_sums=None) -> torch.Tensor:
    """Packed int32 [R, 2*topk + 2]: [:, :topk] descending raw run sums,
    [:, topk:2*topk] their user bins (-1 for merged runs and padding),
    [:, -2] the hash count per read (unique for syncmers, the emitted
    vector's size for minimisers and k-mers, after the FracMinHash keep),
    [:, -1] emissions before dedup (> hcap => host fallback; a minimiser
    step's hcap is L, so it never overflows).

    table uint8 [S, Bpad]; packed uint8 [R, L/4] and lengths int32 [R]
    (pack_reads); run_offsets int64 [n_runs + 1]; run_users int32
    [n_runs]; all on one device.  scheme_kind "syncmer" or "minimizer"
    (window: the minimiser window, k for plain k-mers); scale_thresh the
    FracMinHash threshold, 0 for none.

    The sharded step's hooks (device/sharding.py), None for none:
    ``gather`` maps the extraction's (hi, lo, valid, n_unique, n_emit) of
    these reads to those of the reads probed (the reads row's), and
    ``reduce_sums`` the run sums of this table to those of the whole
    index (the sum over the bins shards)."""
    hashes = _hashes(packed, lengths, scheme_kind, k, s, t, window, hcap,
                     scale_thresh)
    if gather is not None:
        hashes = gather(hashes)
    hi, lo, valid, n_unique, n_emit = hashes
    counts = probe_counts(hi, lo, valid, table, seed, block_length,
                          route="fused")
    sums = run_sums(counts, run_offsets, prefix_runs)
    if reduce_sums is not None:
        sums = reduce_sums(sums)
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
            stats: ActivityStats | None = None, upto: int | None = None,
            descend_all: bool = False, reduce_sums=None):
    """The level-grouped descent of the extracted hashes (hi, lo, valid
    [R, H]) with per-read thresholds thr int32 [R].  Returns (leaf_vals,
    leaf_sums), lists over the groups of [n_leaves, R]: leaf_vals the
    leaf run sums, -1 where the leaf's IXF was not descended, and
    leaf_sums None; with ``upto``, the activity [G, R] that group
    ``upto`` would be probed with.

    The activity of every IXF is one row of a [n_nodes, R] mask indexed
    by BFS position; each group's bookkeeping (the JAX ``_emit_members``
    loop over members) is a few gathers over index tensors, so a group
    costs the same handful of launches whatever its member count.

    descend_all (length-dependent thresholds; thr is not read): every
    (subgroup, read) pair is probed, and a chain [n_nodes, R] carries the
    minimum of the merged run sums on the path from the root (2^30 at the
    root): chain[child] = min(chain[parent], its run's sum).  leaf_vals
    are then min(chain, leaf sum), the value the host tests against the
    read's threshold, and leaf_sums the leaf sums it reports.

    reduce_sums: applied to each group's [n_runs, R] run sums before the
    descent reads them (the sharded step's sum over the bins shards);
    None for none."""
    R = hi.shape[0]
    dev = hi.device
    active = torch.zeros((n_nodes, R), dtype=torch.bool, device=dev)
    active[0] = True
    if descend_all:
        chain = torch.full((n_nodes, R), 2**30, dtype=torch.int32,
                           device=dev)
    leaf_vals, leaf_sums = [], []
    for gi, g in enumerate(groups):
        G = g["tables"].shape[0]
        if descend_all:
            act_mat = torch.ones((G, R), dtype=torch.bool, device=dev)
        else:
            act_mat = torch.zeros((G, R), dtype=torch.int32,
                                  device=dev).index_add_(
                0, g["member_sub"],
                active[g["member_bfs"]].to(torch.int32)) > 0
        if gi == upto:
            return act_mat
        if stats is not None:
            stats.add(act_mat)
        sums = probe_run_sums_grouped(hi, lo, valid, g["tables"], act_mat,
                                      g["run_off"], g["run_s"], g["run_e"],
                                      g["seed"], g["bl"], route="fused")
        if reduce_sums is not None:
            sums = reduce_sums(sums)
        if descend_all:
            if g["child_bfs"].numel():
                chain[g["child_bfs"]] = torch.minimum(
                    chain[g["child_parent"]], sums[g["child_run"]])
            if g["leaf_run"].numel():
                ls = sums[g["leaf_run"]]
                leaf_sums.append(ls)
                leaf_vals.append(torch.minimum(chain[g["leaf_bfs"]], ls))
            continue
        if g["child_bfs"].numel():
            active[g["child_bfs"]] = active[g["child_parent"]] & (
                sums[g["child_run"]] >= thr[None, :])
        if g["leaf_run"].numel():
            leaf_vals.append(torch.where(active[g["leaf_bfs"]],
                                         sums[g["leaf_run"]], -1))
    if upto is not None:
        raise IndexError(f"no group {upto}")
    return leaf_vals, (leaf_sums if descend_all else None)


def make_hixf_e2e_grouped_fn(groups, leaf_users: torch.Tensor, k: int,
                             s: int, t: int, topk: int,
                             scheme_kind: str = "syncmer", window: int = 0,
                             scale_thresh: int = 0,
                             descend_all: bool = False,
                             stats: ActivityStats | None = None,
                             gather=None, reduce_sums=None):
    """Fused hierarchical search with level-grouped probing (the JAX
    ``make_hixf_e2e_grouped_fn``).  Returns ``run(packed, lengths,
    thr_table, hcap)`` -> packed int32 [R, 2*topk + 2]: the top-k leaf run
    sums descending (-1 where the leaf's IXF was not descended), their
    user bins, the hash count and the emission count per read.

    The scheme's extraction runs once (K1 or the split engine for
    syncmers, K5 for minimisers and plain k-mers, then the FracMinHash
    keep; ``_hashes``).  Then, per group in order (ancestors before
    descendants, ``descend``): the group's G subgroup tables [G, S, Bpad]
    probe as one launch that sums each subgroup's runs
    (probe_run_sums_grouped: K2n probes only the active pairs, each
    subgroup with the OR of its members' descent masks, and writes
    [n_runs, R] sums, no dense counts; a group wider than 512 bins takes
    K2's counts and their segment sums); each merged run activates its
    child where ``active & (sum >= thr_table[n_unique])``; the leaf runs
    give the leaf values.  Top-k runs over the leaf columns concatenated
    in group, member, run order, with the stable sort of ``topk_idx``,
    which breaks ties as ``lax.top_k`` does.

    descend_all (length-dependent thresholds, the fracminhash model):
    the reference's descent and emission thresholds are the same per-read
    tau, so a leaf is emitted iff min(leaf sum, the merged sums above it)
    >= tau.  Every pair is probed (thr_table is not read), the leaf
    values are those chain minima, and the result is packed
    [R, 3*topk + 2]: the top-k minima descending | the leaf sums at the
    same leaves | their user bins | n_unique | n_emit.  The host applies
    the exact float64 tau to the minima and reports the sums.

    groups: DeviceHIXF.upload_groups dicts: tables uint8 [G, S, Bpad],
      seed, bl, and int64 index tensors: run_off (the CSR [G + 1] of each
      subgroup's runs), run_s/run_e (each run's column range in its
      subgroup's table), member_bfs/member_sub (each member's
      BFS position and subgroup), child_bfs/child_parent/child_run (each
      merged run's child, its parent member and the run), leaf_bfs/
      leaf_run (each leaf run's member and the run); members, the host
      member tuples, give the BFS positions' range.
    leaf_users: int32 [n_leaves], the user bin of each leaf column.
    gather, reduce_sums: the sharded step's hooks, as in fused_e2e_step
    (reduce_sums applies to each group's run sums, ``descend``)."""
    n_nodes = 1 + max(m[0] for g in groups for m in g["members"])

    def run(packed, lengths, thr_table, hcap: int) -> torch.Tensor:
        hashes = _hashes(packed, lengths, scheme_kind, k, s, t, window,
                         hcap, scale_thresh)
        if gather is not None:
            hashes = gather(hashes)
        hi, lo, valid, n_unique, n_emit = hashes
        thr = thr_table[n_unique.clamp(0, thr_table.shape[0] - 1).long()]
        leaf_vals, leaf_sums = descend(groups, n_nodes, hi, lo, valid, thr,
                                       stats, descend_all=descend_all,
                                       reduce_sums=reduce_sums)
        vals, idx = topk_idx(torch.cat(leaf_vals).T, topk)
        users = torch.where(vals >= 0, leaf_users[idx],
                            torch.full_like(vals, -1))
        parts = [_pad(vals, topk), _pad(users, topk)]
        if descend_all:
            sums_k = torch.gather(torch.cat(leaf_sums).T, 1, idx)
            parts.insert(1, _pad(sums_k, topk))
        return torch.cat([*parts, n_unique[:, None], n_emit[:, None]],
                         dim=1)

    return run
