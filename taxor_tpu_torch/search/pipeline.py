"""The taxor-search pipeline on a torch device.

Counterpart of ``search_single`` and ``run_search`` in
``taxor_tpu/search/pipeline.py``, which cannot be reused as they are:
``search_single`` imports the JAX device extractor before it looks at
the engine, and ``run_search`` builds the JAX ``DeviceHIXF``.  The text
is the reference's by construction: the row formatting, the thresholds
and the device-result decoders are imported from the JAX package's host
layer, not copied.

Engines:
  - 'device': per batch, reads up to L_CAP go through the fused step
    (device/e2e.py: K1, then K2 or K2n, flat or in the level-grouped
    descent of a hierarchical index) in power-of-two length buckets;
    longer reads are hashed on the host and probed on the device: top-k
    on a flat index (DeviceHIXF.topk_async_packed), the per-IXF
    traversal on a hierarchical one (DeviceHIXF.counts_async).  Reads the
    device result cannot decide exactly (hash capacity overflow, top-k
    truncation) take the host oracle, as in the reference package.
  - 'host': the numpy oracle recursion; it runs without JAX and without
    a GPU.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from taxor_tpu.hash import schemes as _schemes
from taxor_tpu.hash.schemes import search_hashes
from taxor_tpu.hixf.index import TaxorIndex, load_index
from taxor_tpu.io.fastx import iter_fastx_chunks
from taxor_tpu.search.pipeline import (HEADER, SearchConfig, _format_rows,
                                       _pairs_from_counts, _pairs_from_e2e,
                                       _pairs_from_topk, _scaling_ratio)
from taxor_tpu.search.thresholds import Thresholder

from ..device.hixf_search import DeviceHIXF
from ..device.probe import pack_hash_lists
from ..hash import device_syncmer as dsync

# positions per fused dispatch: bounds the device working set per call
POS_BUDGET = 2048 * 2048


class RouteCounts:
    """How many reads took each route of the device engine, summed over
    the searches of the process: 'fused' (the fused step), 'host_hashes'
    (hashed on the host, probed on the device: reads over L_CAP) and
    'host_fallback' (of either, decided by the host oracle after the
    device pass)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {"fused": 0, "host_hashes": 0, "host_fallback": 0}

    def add(self, **kw) -> None:
        with self._lock:
            for key, n in kw.items():
                self.counts[key] += int(n)

    def reset(self) -> None:
        with self._lock:
            for key in self.counts:
                self.counts[key] = 0


ROUTES = RouteCounts()


def search_single(index: TaxorIndex, query_file: str, out_handle,
                  config: SearchConfig, device_hixf=None) -> dict:
    """Search one query file against one loaded index; returns phase
    timings (the <out>.time analog, taxor_search.cpp:328-336)."""
    scheme = index.scheme
    thresholder = Thresholder.make(
        kmer_size=scheme.kmer_size,
        window_size=scheme.window_size,
        error_rate=config.error_rate,
        percentage=config.percentage,
        use_syncmer=scheme.use_syncmer,
    )
    ub2sp = index.user_bin_to_species()
    dfs_rank = index.hixf.user_bin_dfs_order()
    # the fused step covers unscaled syncmer schemes; other schemes hash
    # on the host and probe on the device
    use_e2e = (config.engine == "device" and device_hixf is not None
               and device_hixf.e2e_capable(thresholder)
               and dsync.supports(scheme) and scheme.scaling == 1)

    def _hash_thresholds(hash_counts, seqs):
        # size_t-wrapped "impossible" thresholds are >= 2^63; any value
        # above every possible count is equivalent downstream
        return np.array(
            [min(thresholder.get(
                hc, _scaling_ratio(hc, len(s), scheme.kmer_size)), 2**62)
             for hc, s in zip(hash_counts, seqs)],
            dtype=np.int64,
        )

    def rows_text(chunk, hash_counts, all_pairs) -> str:
        return "".join(
            _format_rows(rec.id, len(rec.seq), hc, pairs, index, ub2sp)
            for rec, hc, pairs in zip(chunk, hash_counts, all_pairs))

    reads_io = 0.0
    compute = 0.0

    if config.engine == "host":
        t_io = time.perf_counter()
        for chunk in iter_fastx_chunks(query_file, config.batch_size):
            reads_io += time.perf_counter() - t_io
            t0 = time.perf_counter()
            seqs = [rec.seq for rec in chunk]
            hash_lists = search_hashes(seqs, scheme)
            hash_counts = [h.shape[0] for h in hash_lists]
            thresholds = _hash_thresholds(hash_counts, seqs)
            all_pairs = [index.hixf.membership(h, int(t))
                         for h, t in zip(hash_lists, thresholds)]
            out_handle.write(rows_text(chunk, hash_counts, all_pairs))
            compute += time.perf_counter() - t0
            t_io = time.perf_counter()
        return {"reads_io": reads_io, "compute": compute}

    # device top-k candidate slots, shared across batches and escalated
    # (16 -> 64 -> 256) when a batch shows a noticeable truncation
    # fallback; workers race on it, so escalation is a locked
    # compare-and-step from the k the batch ran at
    topk_state = {"k": max(1, int(config.topk),
                           int(getattr(index, "suggested_topk", 16))),
                  "lock": threading.Lock()}

    def _escalate_topk(ran_at_k: int):
        with topk_state["lock"]:
            if topk_state["k"] == ran_at_k and ran_at_k < 256:
                topk_state["k"] = min(256, ran_at_k * 4)

    def process(chunk):
        """One batch: reads up to L_CAP go to the fused step in
        power-of-two length buckets (sub-batches of POS_BUDGET/L reads);
        longer reads take host extraction + device probe."""
        seqs = [rec.seq for rec in chunk]
        n = len(seqs)
        all_pairs: list = [None] * n
        hash_counts: list = [None] * n
        hash_idx: list[int] = []
        topk = topk_state["k"]
        if use_e2e:
            buckets: dict[int, list[int]] = {}
            for i, s in enumerate(seqs):
                if 0 < len(s) <= dsync.L_CAP:
                    buckets.setdefault(dsync.pad_len_bucket(len(s)),
                                       []).append(i)
                else:
                    hash_idx.append(i)
            pend = []
            for L in sorted(buckets):
                idxs = buckets[L]
                sub = max(16, min(config.batch_size, POS_BUDGET // L))
                for off in range(0, len(idxs), sub):
                    part = idxs[off:off + sub]
                    gseqs = [seqs[i] for i in part]
                    packed, lengths = dsync.pack_reads(gseqs, L)
                    pend.append((part, gseqs, device_hixf.e2e_async(
                        packed, lengths, scheme, thresholder, k=topk)))
            for part, gseqs, collect in pend:
                vals, users, counts, n_emit, hcap = collect()
                trunc_out: list = []
                prs, hcs = _pairs_from_e2e(
                    vals, users, counts, n_emit, gseqs, index, scheme,
                    thresholder, dfs_rank, hcap, trunc_out=trunc_out)
                ROUTES.add(fused=len(part), host_fallback=(
                    (n_emit[:len(part)] > hcap) | trunc_out[0]).sum())
                if trunc_out[0].mean() > 0.02:
                    _escalate_topk(topk)
                for j, i in enumerate(part):
                    all_pairs[i] = prs[j]
                    hash_counts[i] = hcs[j]
        else:
            hash_idx = list(range(n))
        if hash_idx:
            hseqs = [seqs[i] for i in hash_idx]
            hash_lists = search_hashes(hseqs, scheme)
            hcs = [h.shape[0] for h in hash_lists]
            thresholds = _hash_thresholds(hcs, hseqs)
            kind, collect = _device_dispatch(device_hixf, hash_lists,
                                             thresholds)
            if kind == "topk":
                vals, users = collect()
                kk = vals.shape[1]
                trunc = ((vals >= 0).sum(axis=1) == kk) & (
                    vals[:, kk - 1].astype(np.float64)
                    >= vals[:, 0].astype(np.float64) * 0.8)
                prs = _pairs_from_topk(vals, users, thresholds, hash_lists,
                                       index, dfs_rank)
            else:  # exact per-user-bin emissions: no fallback
                counts, emitted = collect()
                trunc = np.zeros(len(hash_idx), dtype=bool)
                prs = _pairs_from_counts(counts, emitted, dfs_rank)
            ROUTES.add(host_hashes=len(hash_idx), host_fallback=trunc.sum())
            for j, i in enumerate(hash_idx):
                all_pairs[i] = prs[j]
                hash_counts[i] = hcs[j]
        return rows_text(chunk, hash_counts, all_pairs)

    # P batches in flight on worker threads; the main thread writes them
    # in submission order, so the output is deterministic
    depth = max(1, config.pipeline_depth)
    t_start = time.perf_counter()
    with ThreadPoolExecutor(depth) as ex:
        q: deque = deque()
        t_io = time.perf_counter()
        for chunk in iter_fastx_chunks(query_file, config.batch_size):
            reads_io += time.perf_counter() - t_io
            q.append(ex.submit(process, chunk))
            if len(q) >= depth:
                out_handle.write(q.popleft().result())
            t_io = time.perf_counter()
        while q:
            out_handle.write(q.popleft().result())
    compute = (time.perf_counter() - t_start) - reads_io
    return {"reads_io": reads_io, "compute": compute}


def _device_dispatch(device_hixf, hash_lists, thresholds):
    """Pad host-extracted hashes to a power-of-two width and dispatch
    them to the device probe; returns (kind, collector): 'topk' yields
    (vals, users) on a flat index, 'dense' (counts, emitted) on a
    hierarchical one."""
    H = max(1, max((h.shape[0] for h in hash_lists), default=1))
    Hpad = 1 << (H - 1).bit_length()
    hi, lo, valid = pack_hash_lists(hash_lists, Hpad)
    if device_hixf.flat_fast_path:
        return "topk", device_hixf.topk_async_packed(
            hi, lo, valid, len(hash_lists), thresholds)
    return "dense", device_hixf.counts_async(hi, lo, valid, thresholds)


def run_search(config: SearchConfig, device="cuda") -> dict:
    """Outer product over comma-separated query and index lists
    (taxor_search.cpp:340-360); the device engine runs on ``device``.
    Returns the phase timings written to <out>.time."""
    if config.engine not in ("device", "host"):
        raise ValueError(f"engine {config.engine!r} is not ported yet "
                         "(device and host run; sharded is ROADMAP A.8)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu to run the plain twins)")
    _schemes.NUM_THREADS = max(1, int(config.threads))
    index_files = config.index_file.split(",")
    query_files = config.query_file.split(",")

    # scheme-consistency check across indexes (taxor_search.cpp:110-137)
    loaded = [load_index(f) for f in index_files]
    keys = {(ix.scheme.kmer_size, ix.scheme.window_size, ix.scheme.scaling,
             ix.scheme.syncmer_size, ix.scheme.t_syncmer,
             ix.scheme.use_syncmer) for ix in loaded}
    if len(keys) > 1:
        raise ValueError(
            "At least two index files have been created with different "
            "kmer selection schemes")

    timings = {"index_io": 0.0, "reads_io": 0.0, "compute": 0.0}
    with open(config.report_file, "w") as out:
        out.write(HEADER)
        for query in query_files:
            for index in loaded:
                dhixf = None
                if config.engine == "device":
                    t0 = time.perf_counter()
                    dhixf = DeviceHIXF.from_hixf(index.hixf, device)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    timings["index_io"] += time.perf_counter() - t0
                t = search_single(index, query, out, config, dhixf)
                timings["reads_io"] += t["reads_io"]
                timings["compute"] += t["compute"]

    if config.write_time:
        with open(config.report_file + ".time", "w") as fh:
            fh.write("Index I/O\tReads I/O\tCompute\n")
            fh.write(f"{timings['index_io']:.2f}\t{timings['reads_io']:.2f}"
                     f"\t{timings['compute']:.2f}")
    return timings
