"""Device-resident index for the search pipeline.

Counterpart of ``taxor_tpu/device/hixf_search.DeviceHIXF``.  ``from_hixf``
turns the host ``HIXF`` of a loaded ``TaxorIndex`` into device tensors.
The dispatch methods return the same collector tuples as the JAX class,
so ``search/pipeline.py`` decodes both the same way, apart from
``e2e_async``: its tuple always has six elements, the sixth the leaf sums
of the descend-all mode and None in the count-table and per-read ones.

A flat index (one IXF) keeps the uint8 fingerprint table [S, Bpad] with
bins contiguous per slot, the run offsets and run users, and the seed and
block length as Python ints (``fused_e2e_step``, ``topk_async_packed``).

A hierarchical index runs the level-grouped descent
(``e2e.make_hixf_e2e_grouped_fn``).  IXFs are grouped by (depth, seed,
block_length) in BFS order, each group split at member boundaries into
subgroups of at most 128 four-bin words (``_build_probe_groups``), and
consecutive subgroups of one geometry stack into one uint8 [G, S, Bpad]
table that one kernel launch probes (``_stack_host_groups``).  Members
pack column-wise at 4-bin boundaries, as the JAX package packs 4-bin
words; each run of a member is a column range [run_s, run_e) of its
subgroup's table run_g, int64 offsets in place of the JAX one-hot
matrices; a stack's runs are contiguous per subgroup, a CSR (run_off)
that K2n sums in the kernel.  Reads past L_CAP take the same step:
syncmer reads in pieces (``e2e_async`` on a bucket of pieces: hash_cap
slots a read, device/e2e._syncmer_hashes), minimiser and plain k-mer
reads whole (K5, hcap = L; the count-indexed table then has L + 1
thresholds, ``count_thresholds``).  Reads hashed on the host (of length 0, or
of a scheme no device extractor covers) take ``counts``: one
activity-masked probe launch per IXF in BFS order, the descent decided
on the host.

Left out against the JAX class, because only the TPU needed them:
  - the engine split at ``_FP_VMEM_TILE`` and the XLA-gather groups: one
    CUDA kernel reads tables of any size from HBM;
  - the p10 layouts (``p10_ok``);
  - the zero sentinel row: the kernels drop invalid slots;
  - the ``poskey`` position cache: the kernels compute the positions from
    (hash, seed, block_length);
  - the padding of group columns to 128 or 1024 words: a group pads to 16
    bins, and a stack pads its subgroups to the widest of them.

Under a reads x bins mesh (``mesh``, device/distributed.py) the index
uploads only this rank's column shard of the flat table and of every
stacked group (sharding.shard_ixf), with the runs clipped to the shard
(sharding.shard_runs: a run may be empty there, or start at the shard's
first column); the groups are the single-device ones.  The fused steps
then run bin-sharded (sharding.sharded_e2e_fn, sharded_hixf_e2e_fn) and
``counts`` sums each IXF's runs over the row before the descent reads
them.  As in the JAX class, ``flat_fast_path`` is off under a mesh: the
host-hashed reads of a flat index take ``counts``.

Every scheme the JAX steps take runs fused: syncmers (K1, hcap slots),
minimisers and plain k-mers (K5, hcap = L), either with a FracMinHash
scaling (``_scale_thresh``).  A hierarchy descends with the count-indexed
threshold table (search/thresholds.count_thresholds) for the count-only threshold models, and
with per-read thresholds computed on the host for the length-dependent
fracminhash model (``_per_read``): the read's hash count comes to the
host after the extraction, its exact float64 threshold
(search/thresholds.device_thresholds) goes up as int32, and K2n probes
only the pairs the reference walks.  The JAX step's descend-all
chain-min mode, which probes every pair and whose collector returns the
leaf sums to report as its sixth element, is taken only where a caller
asks for it (``descend_all=True``), as the parity reference of the
per-read mode.
"""

from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..hash.device_syncmer import hash_cap, supports, supports_minimizer
from ..hash.schemes import scaling_threshold_u64
from ..hixf.container import HIXF
from ..search.thresholds import count_thresholds, device_thresholds
from . import sharding
from .e2e import (ActivityStats, fused_e2e_step, make_hixf_e2e_grouped_fn,
                  run_sums, topk_desc)
from .probe import (pad_bins, pad_fingerprints, probe_counts,
                    probe_run_sums_grouped)

# threshold models that depend on the hash count only, which the
# count-indexed descent table covers (the JAX COUNT_ONLY_KINDS)
COUNT_ONLY_KINDS = ("percentage", "syncmer_model", "kmer_model")

# active (subgroup, read) pairs of the grouped descent, over the process
ACTIVITY = ActivityStats()


def _scale_thresh(scheme) -> int:
    """The FracMinHash keep threshold of the device steps; 0 means no
    downsampling (schemes.scaling_threshold_u64)."""
    return scaling_threshold_u64(scheme.scaling) if scheme.scaling > 1 else 0


def _per_read(thresholder) -> bool:
    """Length-dependent threshold models (fracminhash) cannot use the
    count-indexed descent table: the descent takes per-read thresholds
    computed on the host (the per-read mode)."""
    return thresholder is not None and \
        thresholder.kind not in COUNT_ONLY_KINDS


@dataclass
class _IXFInfo:
    """Host metadata of one IXF: its geometry and its runs."""

    seed: int
    block_length: int
    bins: int
    run_starts: np.ndarray  # int64 [n_runs]
    run_ends: np.ndarray  # int64 [n_runs], exclusive
    run_users: np.ndarray  # int64 [n_runs], -1 for merged runs
    run_children: np.ndarray  # int64 [n_runs], child IXF of merged runs


class DeviceHIXF:
    """An HIXF on one torch device, with BFS traversal metadata."""

    def __init__(self, hixf: HIXF, device, mesh=None):
        """mesh: a distributed.Mesh; this rank then holds its bins shard
        of every table (the module docstring)."""
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.device)
        self.hixf = hixf
        self.num_user_bins = hixf.num_user_bins
        self.ixfs: list[_IXFInfo] = []
        for i, ixf in enumerate(hixf.ixfs):
            starts, ends, users = hixf.runs_of_ixf(i)
            children = np.array(
                [int(hixf.next_ixf_id[i][int(s)]) if u < 0 else -1
                 for s, u in zip(starts, users)], dtype=np.int64)
            self.ixfs.append(_IXFInfo(int(ixf.seed), int(ixf.block_length),
                                      ixf.bin_count, starts, ends, users,
                                      children))
        # BFS order from the root (IXF 0), children via the merged runs
        order, seen, q = [0], {0}, deque([0])
        while q:
            for c in self.ixfs[q.popleft()].run_children:
                c = int(c)
                if c >= 0 and c not in seen:
                    seen.add(c)
                    order.append(c)
                    q.append(c)
        self.bfs_order = order
        # parent link: (parent IXF, run index in the parent) per IXF
        self.parent: dict[int, tuple[int, int]] = {}
        for i in order:
            for r, c in enumerate(self.ixfs[i].run_children):
                if int(c) >= 0:
                    self.parent[int(c)] = (i, r)
        self._thr_tables: dict = {}
        self._e2e_fns: dict = {}
        # per IXF: (its subgroup's table, or the flat table, as a stack of
        # one [1, S, Bpad] and its runs: the CSR [0, n_runs], column
        # starts, ends) for ``counts``
        self._ixf_probe: dict[int, tuple] = {}
        dev = self.device
        if len(self.ixfs) == 1:
            self._init_flat()
            return
        host_groups, leaf_users = self._build_probe_groups(max_group_b4=128)
        self.groups = self.upload_groups(
            self._stack_host_groups(host_groups))
        self.leaf_users = torch.from_numpy(
            leaf_users.astype(np.int32)).to(dev)

    def _init_flat(self) -> None:
        ixf = self.hixf.ixfs[0]
        info = self.ixfs[0]
        dev = self.device
        self.seed = info.seed
        self.block_length = info.block_length
        table = pad_fingerprints(ixf.fingerprints)
        offsets = np.append(info.run_starts, info.run_ends[-1])
        starts, ends = info.run_starts, info.run_ends
        n_runs = starts.shape[0]
        # every run one bin at its own index: run sums are a column slice
        # (of a shard only where the shard's columns are the runs' own)
        self.prefix_runs = (
            n_runs if (np.array_equal(starts, np.arange(n_runs))
                       and np.array_equal(ends, starts + 1)) else 0)
        if self.mesh is None:
            self.table = torch.from_numpy(table).to(dev)
        else:
            self.table = sharding.shard_ixf(self.mesh, table)
            offsets, starts, ends = sharding.shard_runs(
                self.mesh, self.table.shape[1], offsets, starts, ends)
            if self.mesh.nb > 1:
                self.prefix_runs = 0
        self.run_offsets = torch.from_numpy(
            offsets.astype(np.int64)).to(dev)
        self.run_users = torch.from_numpy(
            info.run_users.astype(np.int32)).to(dev)
        self._ixf_probe[0] = (
            self.table[None], self.run_offsets.new_tensor([0, n_runs]),
            torch.from_numpy(starts.astype(np.int64)).to(dev),
            torch.from_numpy(ends.astype(np.int64)).to(dev))

    @classmethod
    def from_hixf(cls, hixf: HIXF, device, mesh=None) -> "DeviceHIXF":
        return cls(hixf, device, mesh)

    @property
    def flat_fast_path(self) -> bool:
        """The compact top-k dispatch applies: one IXF, no mesh."""
        return len(self.ixfs) == 1 and self.mesh is None

    def e2e_capable(self, thresholder=None, scheme=None) -> bool:
        """Whether the fused reads -> top-k dispatch covers this index
        and, where given, ``scheme`` (the device extractors take
        syncmers, minimisers and plain k-mers, scaled or not): flat
        always qualifies (thresholds are applied on the host); a
        hierarchy needs a thresholder for its device-side descent.  The
        same under a mesh, whose steps are the sharded ones."""
        if scheme is not None and not (supports(scheme)
                                       or supports_minimizer(scheme)):
            return False
        return len(self.ixfs) == 1 or thresholder is not None

    # ------------------------------------------------------------ groups --
    def _depths(self) -> dict[int, int]:
        """ixf id -> tree depth (root = 0) via the parent links."""
        depths = {0: 0}
        for i in self.bfs_order[1:]:
            depths[i] = depths[self.parent[i][0]] + 1
        return depths

    def _build_probe_groups(self, max_group_b4: int | None = None):
        """Assemble the level-grouped probe structure on the host.

        IXFs group by (depth, seed, block_length), ancestors' groups
        first; members pack at 4-bin boundaries and the group pads its
        columns to 16 bins.  max_group_b4: split a group at member
        boundaries into subgroups of at most this many 4-bin words, so a
        read descending one subtree probes one narrow subgroup, not the
        whole level.

        Returns (groups, leaf_users): groups are dicts with the numpy
        table uint8 [S, Bpad], run_starts/run_ends int64 (columns of the
        table), seed, bl, depth and members [(bfs_pos, run_off, n_runs,
        children [(local_run, child_bfs_pos)], leaf_sel int64)];
        leaf_users is the user bin of each leaf run in group, member, run
        order."""
        bfs_pos = {ixf_id: p for p, ixf_id in enumerate(self.bfs_order)}
        depths = self._depths()
        group_key_order: list[tuple] = []
        group_members: dict[tuple, list[int]] = {}
        for i in self.bfs_order:
            info = self.ixfs[i]
            gk = (depths[i], info.seed, info.block_length)
            if gk not in group_members:
                group_members[gk] = []
                group_key_order.append(gk)
            group_members[gk].append(i)
        group_key_order.sort(key=lambda gk: gk[0])

        if max_group_b4 is not None:
            # split member lists greedily by cumulative packed width
            split_order: list[tuple] = []
            split_members: dict[tuple, list[int]] = {}
            for gk in group_key_order:
                part: list[int] = []
                width = 0
                sub = 0
                for i in group_members[gk]:
                    b4_i = -(-self.ixfs[i].bins // 4)
                    if part and width + b4_i > max_group_b4:
                        split_order.append(gk + (sub,))
                        split_members[gk + (sub,)] = part
                        part, width, sub = [], 0, sub + 1
                    part.append(i)
                    width += b4_i
                split_order.append(gk + (sub,))
                split_members[gk + (sub,)] = part
            group_key_order = split_order
            group_members = split_members

        groups = []
        leaf_users_parts = []
        for gk in group_key_order:
            members = group_members[gk]
            fps = [self.hixf.ixfs[i].fingerprints for i in members]
            widths = [4 * -(-self.ixfs[i].bins // 4) for i in members]
            # members of one level share their slot count (uniform level
            # geometry); the max is defensive
            table = np.zeros((max(f.shape[0] for f in fps),
                              pad_bins(sum(widths))), dtype=np.uint8)
            members_meta = []
            starts, ends = [], []
            run_off = 0
            col = 0
            for i, fp, w in zip(members, fps, widths):
                info = self.ixfs[i]
                table[:fp.shape[0], col:col + fp.shape[1]] = fp
                starts.append(col + info.run_starts)
                ends.append(col + info.run_ends)
                kids, leaves = [], []
                for r, c in enumerate(info.run_children):
                    if int(c) >= 0:
                        kids.append((r, bfs_pos[int(c)]))
                    else:
                        leaves.append(run_off + r)
                users = info.run_users
                leaf_users_parts.append(users[users >= 0] if leaves else
                                        np.zeros(0, dtype=np.int64))
                n_runs = info.run_starts.shape[0]
                members_meta.append((bfs_pos[i], run_off, n_runs, kids,
                                     np.array(leaves, dtype=np.int64)))
                run_off += n_runs
                col += w
            groups.append(dict(
                table=table, run_starts=np.concatenate(starts),
                run_ends=np.concatenate(ends), seed=gk[1], bl=gk[2],
                depth=gk[0], members=members_meta))
        return groups, np.concatenate(leaf_users_parts)

    @staticmethod
    def _stack_host_groups(host_groups):
        """Stack runs of consecutive groups that share (depth, seed,
        block_length, slots) into one group with tables uint8
        [G, S, Bpad] (Bpad the widest), each run tagged with its subgroup
        (run_g) and the members' run offsets re-based to the concatenated
        runs.  One launch over G then probes the whole run of groups, each
        subgroup with its own members' activity (sub_members), so the
        result equals the unstacked groups'.  A group that stacks with
        none becomes a stack of one."""
        def key(h):
            return h["depth"], h["seed"], h["bl"], h["table"].shape[0]

        out = []
        i = 0
        while i < len(host_groups):
            g = host_groups[i]
            j = i + 1
            while j < len(host_groups) and key(host_groups[j]) == key(g):
                j += 1
            sub = host_groups[i:j]
            Bp = max(s["table"].shape[1] for s in sub)
            tables = np.zeros((len(sub), g["table"].shape[0], Bp),
                              dtype=np.uint8)
            members, run_g, sub_members = [], [], []
            run_adj = 0
            for gi, s in enumerate(sub):
                tables[gi, :, :s["table"].shape[1]] = s["table"]
                run_g.append(np.full(s["run_starts"].shape[0], gi))
                for bfs, run_off, n_runs, kids, leaf_sel in s["members"]:
                    members.append((bfs, run_off + run_adj, n_runs, kids,
                                    leaf_sel + run_adj))
                sub_members.append([m[0] for m in s["members"]])
                run_adj += s["run_starts"].shape[0]
            out.append(dict(
                tables=tables, run_g=np.concatenate(run_g),
                run_s=np.concatenate([s["run_starts"] for s in sub]),
                run_e=np.concatenate([s["run_ends"] for s in sub]),
                seed=g["seed"], bl=g["bl"], members=members,
                sub_members=sub_members))
            i = j
        return out

    def upload_groups(self, stacked) -> list[dict]:
        """The stacked host groups as device tensors, with the index
        tensors of the vectorised descent (e2e.descend); also records each
        member's table and runs for the counts traversal.  Under a mesh,
        this rank's column shard of each stack, its runs clipped to it."""
        dev = self.device
        mesh = self.mesh

        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64)).to(dev)

        groups = []
        for g in stacked:
            run_s, run_e = g["run_s"], g["run_e"]
            if mesh is None:
                tables = torch.from_numpy(g["tables"]).to(dev)
            else:
                tables = sharding.shard_ixf(mesh, g["tables"])
                run_s, run_e = sharding.shard_runs(mesh, tables.shape[2],
                                                   run_s, run_e)
            # the runs of one subgroup are contiguous (_stack_host_groups
            # concatenates them subgroup by subgroup): a CSR over G
            G = g["tables"].shape[0]
            if np.any(np.diff(g["run_g"]) < 0):
                raise AssertionError("a subgroup's runs are not contiguous")
            run_off = t(np.concatenate(
                [[0], np.cumsum(np.bincount(g["run_g"], minlength=G))]))
            run_s, run_e = t(run_s), t(run_e)
            sub_of = {b: gi for gi, sub in enumerate(g["sub_members"])
                      for b in sub}
            members = g["members"]
            kids = [(b, ro + r, c) for b, ro, _, ks, _ in members
                    for r, c in ks]
            leaves = [(b, int(x)) for b, _, _, _, ls in members for x in ls]
            groups.append(dict(
                tables=tables, seed=g["seed"], bl=g["bl"], run_off=run_off,
                run_s=run_s, run_e=run_e,
                member_bfs=t([m[0] for m in members]),
                member_sub=t([sub_of[m[0]] for m in members]),
                child_bfs=t([c for _, _, c in kids]),
                child_parent=t([b for b, _, _ in kids]),
                child_run=t([r for _, r, _ in kids]),
                leaf_bfs=t([b for b, _ in leaves]),
                leaf_run=t([r for _, r in leaves]), members=members))
            for b, ro, n, _, _ in members:
                gi = sub_of[b]
                self._ixf_probe[self.bfs_order[b]] = (
                    tables[gi:gi + 1], t([0, n]), run_s[ro:ro + n],
                    run_e[ro:ro + n])
        return groups

    # --------------------------------------------------------- dispatch --
    def topk_async_packed(self, hi: np.ndarray, lo: np.ndarray,
                          valid: np.ndarray, n_reads: int, thresholds,
                          k: int = 16):
        """Probe host-extracted hashes (pack_hash_lists) against a flat
        index and compact each read to its top-k bins at or above its
        threshold (finalize_topk).  Returns a collector yielding (vals,
        users) int32 [n_reads, k]."""
        dev = self.device
        thr = np.minimum(np.asarray(thresholds, dtype=np.int64),
                         np.iinfo(np.int32).max).astype(np.int32)
        counts = probe_counts(
            torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev),
            torch.from_numpy(valid).to(dev), self.table, self.seed,
            self.block_length, route="host_hashes")
        sums = run_sums(counts, self.run_offsets, self.prefix_runs)
        packed = finalize_topk(sums, torch.from_numpy(thr).to(dev),
                               self.run_users, k)

        def collect():
            out = packed.cpu().numpy()[:n_reads]
            return out[:, :k], out[:, k:]

        return collect

    def _hixf_e2e_fn(self, scheme, k: int, mode: str, thresholder=None):
        """The cached grouped step for (scheme, top-k, mode) and, in the
        per-read mode, the thresholder whose thresholds it computes."""
        key = (scheme.kmer_size, scheme.syncmer_size, scheme.t_syncmer,
               scheme.use_syncmer, scheme.window_size, scheme.scaling, k,
               mode, repr(thresholder) if mode == "per_read" else None)
        fn = self._e2e_fns.get(key)
        if fn is None:
            kw = dict(k=scheme.kmer_size, s=scheme.syncmer_size,
                      t=scheme.t_syncmer, topk=k,
                      scheme_kind=("syncmer" if scheme.use_syncmer
                                   else "minimizer"),
                      window=scheme.window_size,
                      scale_thresh=_scale_thresh(scheme),
                      descend_all=mode == "descend_all",
                      thresholds_of=(functools.partial(
                          device_thresholds, thresholder,
                          kmer_size=scheme.kmer_size)
                          if mode == "per_read" else None),
                      stats=ACTIVITY)
            fn = self._e2e_fns[key] = (
                make_hixf_e2e_grouped_fn(self.groups, self.leaf_users, **kw)
                if self.mesh is None else sharding.sharded_hixf_e2e_fn(
                    self.mesh, self.groups, self.leaf_users, **kw))
        return fn

    def e2e_step(self, scheme, thresholder=None, k: int = 16,
                 L: int = 256, descend_all: bool = False):
        """(step, hcap, mode): ``step(reads, lengths, host_lengths=None)``
        runs the fused step of this index on packed reads of length bucket
        L already on its device and returns the packed int32 result
        (device/e2e.py); hcap is the hash slots a read takes; mode names
        the step: "flat", or a hierarchy's descent.  Under a mesh the step
        is the sharded one: the reads are the whole batch (a multiple of
        nr * nb) and the result this rank's reads row's
        (sharding.host_view gathers the rows).

        A hierarchy needs a thresholder, whose kind alone picks the
        descent: count-only models "count_table", with the count-indexed
        table (built on the host once per (thresholder, hcap)); the
        others "per_read", whose step needs the reads' lengths on the host
        as well (``host_lengths``, numpy [R]).  descend_all=True asks for
        the JAX step's "descend_all" mode instead, whose result is
        [R, 3k + 2]; no search path asks for it."""
        # minimisers and plain k-mers: one value a position
        hcap = (hash_cap(L, scheme.kmer_size, scheme.syncmer_size,
                         scheme.t_syncmer) if scheme.use_syncmer else L)
        kind = "syncmer" if scheme.use_syncmer else "minimizer"
        if len(self.ixfs) == 1:
            kw = dict(k=scheme.kmer_size, s=scheme.syncmer_size,
                      t=scheme.t_syncmer, hcap=hcap, topk=k, scheme_kind=kind,
                      window=scheme.window_size,
                      scale_thresh=_scale_thresh(scheme))
            fused = (functools.partial(fused_e2e_step, **kw)
                     if self.mesh is None
                     else sharding.sharded_e2e_fn(self.mesh, **kw))

            def step(reads, lens, host_lengths=None):
                return fused(self.table, reads, lens, self.run_offsets,
                             self.run_users, self.seed, self.block_length,
                             prefix_runs=self.prefix_runs)
            return step, hcap, "flat"
        if thresholder is None:
            raise ValueError("a hierarchical index descends with a "
                             "thresholder")
        mode = ("descend_all" if descend_all else
                "per_read" if _per_read(thresholder) else "count_table")
        tbl = None
        if mode == "count_table":
            tkey = (repr(thresholder), hcap)
            tbl = self._thr_tables.get(tkey)
            if tbl is None:
                tbl = self._thr_tables[tkey] = torch.from_numpy(
                    count_thresholds(thresholder, hcap)).to(self.device)
        fn = self._hixf_e2e_fn(scheme, k, mode, thresholder)
        return (lambda reads, lens, host_lengths=None: fn(
            reads, lens, tbl, hcap, host_lengths)), hcap, mode

    def e2e_async(self, raw_reads: np.ndarray, lengths: np.ndarray, scheme,
                  thresholder=None, k: int = 16, descend_all: bool = False):
        """Whole-search dispatch from 2-bit packed reads (pack_reads):
        uint8 [R, L/4] and int32 [R].  Returns a collector -> (vals [R,k],
        users [R,k], hash counts [R], n_emit [R], hcap, sums): sums is
        None, or in the descend-all mode (``descend_all``, e2e_step) the
        leaf sums [R, k] to report (vals are then the chain minima the
        thresholds test).  The per-read mode waits here for the
        extraction's hash counts, the rest of the step is queued."""
        L = raw_reads.shape[1] * 4  # bases: 4 per packed byte
        step, hcap, mode = self.e2e_step(scheme, thresholder, k, L,
                                         descend_all)
        R0 = raw_reads.shape[0]
        if self.mesh is not None:  # equal parts for every rank
            rpad = -R0 % (self.mesh.nr * self.mesh.nb)
            raw_reads = np.pad(raw_reads, ((0, rpad), (0, 0)))
            lengths = np.pad(lengths, (0, rpad))
        packed = step(torch.from_numpy(raw_reads).to(self.device),
                      torch.from_numpy(lengths.astype(np.int32)).to(
                          self.device), lengths)

        def collect():
            out = (packed.cpu().numpy() if self.mesh is None
                   else sharding.host_view(packed, self.mesh)[:R0])
            if mode == "descend_all":  # minv | sums | users | counts
                return (out[:, :k], out[:, 2 * k:3 * k], out[:, 3 * k],
                        out[:, 3 * k + 1], hcap, out[:, k:2 * k])
            return (out[:, :k], out[:, k:2 * k], out[:, 2 * k],
                    out[:, 2 * k + 1], hcap, None)

        return collect

    def counts_async(self, hi: np.ndarray, lo: np.ndarray,
                     valid: np.ndarray, thresholds):
        """The synchronous traversal ``counts`` behind a collector (the
        descent decisions need the parent sums on the host)."""
        result = self.counts(hi, lo, valid, thresholds)
        return lambda: result

    def counts(self, hi: np.ndarray, lo: np.ndarray, valid: np.ndarray,
               thresholds):
        """Per-read, per-user-bin (counts int64, emitted bool) numpy
        arrays [R, num_user_bins] of host-extracted hashes
        (pack_hash_lists) and int64 thresholds [R].

        One activity-masked probe launch per IXF in BFS order, each on
        its subgroup's table and summed into the IXF's runs in the kernel
        (probe_run_sums_grouped); an IXF no read descends into is
        skipped.
        ``emitted[r, u]`` replicates the reference's emission rule: the
        user bin's split-run sum reached the threshold AND every merged
        bin on the path down was descended.

        Under a mesh, reads row r takes its part of the reads, each rank
        probes its bins shard, one all_reduce over the row adds each
        IXF's run sums before the descent reads them, and host_view
        gathers the rows' results."""
        dev = self.device
        mesh = self.mesh
        R0 = hi.shape[0]
        thresholds = np.asarray(thresholds, dtype=np.int64)
        if mesh is not None:
            sharding.COLLECTIVES.batch()
            rpad = -R0 % mesh.nr
            part = sharding.row_part(mesh, R0 + rpad)
            hi, lo, valid = (np.pad(x, ((0, rpad), (0, 0)))[part]
                             for x in (hi, lo, valid))
            # a padding read reaches no threshold: it descends nowhere
            thresholds = np.pad(thresholds, (0, rpad),
                                constant_values=2**62)[part]
        R = hi.shape[0]
        hi_t, lo_t, valid_t = (torch.from_numpy(np.ascontiguousarray(x)).to(
            dev) for x in (hi, lo, valid))
        run_sums_h: dict[int, np.ndarray] = {}
        active: dict[int, np.ndarray] = {0: np.ones(R, dtype=bool)}
        for i in self.bfs_order:
            info = self.ixfs[i]
            act = active.get(i)
            if act is None or not act.any():
                continue
            tables, run_off, run_s, run_e = self._ixf_probe[i]
            sums = probe_run_sums_grouped(
                hi_t, lo_t, valid_t, tables,
                torch.from_numpy(act[None]).to(dev), run_off, run_s, run_e,
                info.seed, info.block_length, route="host_hashes")
            if mesh is not None:
                sums = sharding.row_sum(mesh, sums)
            sums = sums.T.cpu().numpy()
            run_sums_h[i] = sums.astype(np.int64)
            for r, child in enumerate(info.run_children):
                if child >= 0:
                    active[int(child)] = act & (sums[:, r] >= thresholds)

        counts = np.zeros((R, self.num_user_bins), dtype=np.int64)
        emitted = np.zeros((R, self.num_user_bins), dtype=bool)
        for i, sums in run_sums_h.items():
            users = self.ixfs[i].run_users
            leaf = users >= 0
            if not leaf.any():
                continue
            s = sums[:, leaf]
            u = users[leaf]
            emit = active[i][:, None] & (s >= thresholds[:, None])
            counts[:, u] = np.where(emit, s, counts[:, u])
            emitted[:, u] |= emit
        if mesh is not None:
            counts = sharding.host_view(torch.from_numpy(counts).to(dev),
                                        mesh)[:R0]
            emitted = sharding.host_view(torch.from_numpy(emitted).to(dev),
                                         mesh)[:R0]
        return counts, emitted


def finalize_topk(sums: torch.Tensor, thresholds: torch.Tensor,
                  run_users: torch.Tensor, k: int) -> torch.Tensor:
    """Packed int32 [R, 2k]: per read the k largest run sums at or above
    its threshold, descending (-1 = none), then their user bins (merged
    runs excluded).  The host applies the exact 0.8*max rule and falls
    back to the host oracle when all k slots survive."""
    ok = (sums >= thresholds[:, None]) & (run_users >= 0)[None, :]
    vs = torch.where(ok, sums, torch.full_like(sums, -1))
    vals, users = topk_desc(vs, run_users, k)
    return torch.cat([vals, users], dim=1)
