"""Reads x bins sharding of the search steps over ``torch.distributed``.

Counterpart of ``taxor_tpu/device/sharding.py``.  The JAX package states
the steps once under ``shard_map`` and lets XLA place the collectives; a
port rank runs the single-device step's code on its own shard with the
collectives written out (``distributed.Mesh`` holds the groups):

  - ``bins`` (index parallel): every fingerprint table [S, Bpad] (or
    stack [G, S, Bpad]) pads its columns to LANE * nb and splits them
    evenly, as the JAX ``P(None, "bins")``; rank (r, b) holds slice b
    (``shard_ixf``).  A run of bins keeps its columns clipped to the
    shard (``shard_runs``), so a run that straddles a shard boundary
    sums part on each side and a run outside the shard is empty;
  - ``reads`` (data parallel): reads row r takes batch rows [r R/nr,
    (r + 1) R/nr); within the row, extraction splits again over the bins
    axis (rank (r, b) extracts slice r * nb + b, the JAX
    ``P(("reads", "bins"))``), and one all_gather over the row group
    re-collects the row's hashes;
  - after the probe of the rank's shard, one all_reduce(SUM) over the
    row group adds the run sums (the JAX ``psum``): exact int32, so the
    descent decided from them is the same on every rank of the row;
  - ``host_view`` gathers the rows' results over the column group, so
    every rank holds the whole batch (the JAX ``process_allgather``).

The steps are ``e2e.fused_e2e_step`` and ``e2e.make_hixf_e2e_grouped_fn``
themselves, given the row gather of the hashes and the row reduce of the
run sums as hooks: the single-device and sharded steps share one code
path.  Every collective is timed (``COLLECTIVES``): CUDA events around it
on a card and the host clock everywhere.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .distributed import Mesh, make_mesh  # noqa: F401  (re-exported)
from .e2e import fused_e2e_step, make_hixf_e2e_grouped_fn, run_sums
from .probe import LANE, pad_bins, probe_counts


class CollectiveStats:
    """Seconds spent in the collectives of the sharded steps, over the
    process: the host clock around each call and, on a card, CUDA events
    around it (read once at the end: no sync per call)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.calls = 0
            self.batches = 0
            self.host_s = 0.0
            self._events: list = []
            self.mesh = ""

    def batch(self) -> None:
        with self._lock:
            self.batches += 1

    def timed(self, device: torch.device, fn):
        """fn() with its time recorded."""
        ev = None
        if device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        if ev is not None:
            ev[1].record()
        with self._lock:
            self.calls += 1
            self.host_s += dt
            if ev is not None:
                self._events.append(ev)
        return out

    def device_s(self) -> float | None:
        """CUDA-event seconds of every call so far (None off the card);
        waits for the last one."""
        with self._lock:
            events = list(self._events)
        if not events:
            return None
        events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / 1e3

    def summary(self) -> dict:
        return {"mesh": self.mesh, "calls": self.calls,
                "batches": self.batches, "host_s": self.host_s,
                "device_s": self.device_s()}


COLLECTIVES = CollectiveStats()


def _all_gather(mesh: Mesh, group, x: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """x of every rank of ``group``, concatenated along ``dim`` in the
    group's order; x itself where there is no process group."""
    if group is None:
        return x
    import torch.distributed as dist

    def gather():
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    return COLLECTIVES.timed(mesh.device, gather)


def row_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks of this rank's reads row (the bins
    shards): one all_reduce(SUM)."""
    if mesh.row_group is None:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    COLLECTIVES.timed(mesh.device, lambda: dist.all_reduce(
        x, group=mesh.row_group))
    return x


def row_gather_hashes(mesh: Mesh, hashes):
    """The extraction results (hi, lo, valid [n, H], n_unique, n_emit
    [n]) of the reads row's ranks, concatenated in bins order: one
    all_gather of one int32 [n, 3H + 2] buffer."""
    if mesh.row_group is None:
        return hashes
    hi, lo, valid, n_unique, n_emit = hashes
    H = hi.shape[1]
    buf = torch.cat([hi, lo, valid.to(torch.int32), n_unique[:, None],
                     n_emit[:, None]], dim=1)
    out = _all_gather(mesh, mesh.row_group, buf)
    return (out[:, :H].contiguous(), out[:, H:2 * H].contiguous(),
            out[:, 2 * H:3 * H].bool().contiguous(), out[:, 3 * H].contiguous(),
            out[:, 3 * H + 1].contiguous())


def host_view(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The whole batch on this host: the reads rows' [R / nr, ...]
    results gathered over the column group (the JAX ``host_view``)."""
    if x.dtype == torch.bool:
        return host_view(x.to(torch.uint8), mesh).astype(bool)
    return _all_gather(mesh, mesh.col_group, x).cpu().numpy()


# ------------------------------------------------------------- shards --
def shard_width(mesh: Mesh, bins: int) -> int:
    """Columns of one bins shard of a table of ``bins`` columns."""
    return pad_bins(bins, LANE * mesh.nb) // mesh.nb


def shard_ixf(mesh: Mesh, fp) -> torch.Tensor:
    """This rank's column shard of a uint8 table [..., S, B] (numpy or
    CPU tensor): the columns pad to LANE * nb and split evenly over the
    bins axis (the JAX ``P(None, "bins")``); on the mesh's device."""
    fp = torch.as_tensor(fp)
    w = shard_width(mesh, fp.shape[-1])
    lo = mesh.b * w
    out = torch.zeros((*fp.shape[:-1], w), dtype=fp.dtype)
    part = fp[..., lo:lo + w]
    out[..., :part.shape[-1]] = part
    return out.to(mesh.device)


def shard_runs(mesh: Mesh, width: int, *cols):
    """Column arrays (run starts, ends or CSR offsets) clipped to this
    rank's shard of ``width`` columns, in shard coordinates: a run keeps
    the part of its columns that lies in the shard, possibly none."""
    lo = mesh.b * width
    return [np.clip(np.asarray(c, dtype=np.int64) - lo, 0, width)
            for c in cols]


def _part(R: int, parts: int, i: int) -> slice:
    """Batch rows of part i of R reads split into ``parts`` equal parts."""
    if R % parts:
        raise ValueError(f"{R} reads do not split over {parts} shards: "
                         "pad the batch")
    n = R // parts
    return slice(i * n, (i + 1) * n)


def row_part(mesh: Mesh, R: int) -> slice:
    """The reads of this rank's reads row."""
    return _part(R, mesh.nr, mesh.r)


def _extract_part(mesh: Mesh, R: int) -> slice:
    """The reads this rank extracts: slice r * nb + b of nr * nb."""
    return _part(R, mesh.nr * mesh.nb, mesh.r * mesh.nb + mesh.b)


# -------------------------------------------------------------- steps --
def sharded_count_fn(mesh: Mesh):
    """The sharded count step: ``step(table, hi, lo, valid, seed,
    block_length)`` -> int32 [R / nr, nb * Bshard] counts of this rank's
    reads row against every bins shard.  table: this rank's shard
    (shard_ixf); hi, lo, valid [R, H] the whole batch.  Each rank probes
    its shard (K2 or K2n, ``probe.probe_counts``), one all_gather over
    the row group puts the shards' columns side by side."""

    def step(table, hi, lo, valid, seed: int, block_length: int):
        rows = row_part(mesh, hi.shape[0])
        COLLECTIVES.batch()
        counts = probe_counts(hi[rows], lo[rows], valid[rows], table, seed,
                              block_length, route="sharded")
        return _all_gather(mesh, mesh.row_group, counts, dim=1)

    return step


def sharded_search_step_fn(mesh: Mesh):
    """Full classification step over the mesh: the sharded counts, then
    the run sums and the threshold compare.  ``step(table, hi, lo, valid,
    seed, block_length, run_offsets, thresholds)`` -> (run sums int32
    [R / nr, n_runs], emitted bool [R / nr, n_runs]) of this rank's reads
    row; run_offsets int64 [n_runs + 1] are columns of the whole table,
    thresholds int32 [R]."""
    count = sharded_count_fn(mesh)

    def step(table, hi, lo, valid, seed: int, block_length: int,
             run_offsets, thresholds):
        counts = count(table, hi, lo, valid, seed, block_length)
        sums = run_sums(counts, run_offsets)
        rows = row_part(mesh, hi.shape[0])
        return sums, sums >= thresholds[rows, None]

    return step


def sharded_e2e_fn(mesh: Mesh, k: int, s: int, t: int, hcap: int,
                   topk: int, scheme_kind: str = "syncmer", window: int = 0,
                   scale_thresh: int = 0):
    """The flat fused step over the mesh (the JAX ``sharded_e2e_fn``):
    ``step(table, packed, lengths, run_offsets, run_users, seed,
    block_length, prefix_runs=0)`` -> packed int32 [R / nr, 2 topk + 2]
    (``fused_e2e_step``'s layout) of this rank's reads row.

    table: this rank's shard; run_offsets: the CSR of the runs clipped to
    it (shard_runs); packed [R, L/4] and lengths [R] the whole batch, R a
    multiple of nr * nb.  Extraction (K1, or K5 with its keep) runs on
    this rank's slice, one all_gather over the row group re-collects the
    row's hashes, K2 probes the shard, the shard's partial run sums add
    over the row with one all_reduce, then the replicated top-k."""

    def step(table, packed, lengths, run_offsets, run_users, seed: int,
             block_length: int, prefix_runs: int = 0):
        part = _extract_part(mesh, packed.shape[0])
        COLLECTIVES.batch()
        return fused_e2e_step(
            table, packed[part], lengths[part], run_offsets, run_users, seed,
            block_length, k=k, s=s, t=t, hcap=hcap, topk=topk,
            scheme_kind=scheme_kind, window=window,
            scale_thresh=scale_thresh, prefix_runs=prefix_runs,
            gather=lambda h: row_gather_hashes(mesh, h),
            reduce_sums=lambda x: row_sum(mesh, x))

    return step


def sharded_hixf_e2e_fn(mesh: Mesh, groups, leaf_users: torch.Tensor,
                        k: int, s: int, t: int, topk: int,
                        scheme_kind: str = "syncmer", window: int = 0,
                        scale_thresh: int = 0, descend_all: bool = False,
                        stats=None):
    """The hierarchical fused step over the mesh (the JAX
    ``sharded_hixf_e2e_fn``), in the count-table and the descend-all
    modes: ``run(packed, lengths, thr_table, hcap)`` -> packed int32
    [R / nr, 2 topk + 2] ([R / nr, 3 topk + 2] descending all) of this
    rank's reads row.

    groups: ``DeviceHIXF.upload_groups`` dicts whose tables are this
    rank's column shards and whose run columns are clipped to them.  Per
    group in order: K2n (or K2 past 512 bins) sums the shard's runs,
    one all_reduce over the row adds them, and the descent (activity, or
    the chain minima) is decided from the reduced sums."""
    inner = make_hixf_e2e_grouped_fn(
        groups, leaf_users, k=k, s=s, t=t, topk=topk,
        scheme_kind=scheme_kind, window=window, scale_thresh=scale_thresh,
        descend_all=descend_all, stats=stats,
        gather=lambda h: row_gather_hashes(mesh, h),
        reduce_sums=lambda x: row_sum(mesh, x))

    def run(packed, lengths, thr_table, hcap: int) -> torch.Tensor:
        part = _extract_part(mesh, packed.shape[0])
        COLLECTIVES.batch()
        return inner(packed[part], lengths[part], thr_table, hcap)

    return run
