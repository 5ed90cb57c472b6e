"""The taxor-search pipeline on a torch device.

Counterpart of ``search_single`` and ``run_search`` in
``taxor_tpu/search/pipeline.py``, which cannot be reused as they are:
``search_single`` imports the JAX device extractor before it looks at
the engine, and ``run_search`` builds the JAX ``DeviceHIXF``.  The text
is the reference's: the row formatting, the thresholds and the
device-result decoders below are copies of the JAX package's, held to
it by tests/test_torch_hostlayer.py and the TSV parity tests.

Engines:
  - 'device': per batch, reads up to L_CAP go through the fused step
    (device/e2e.py: K1 for syncmers or K5 for minimisers and plain
    k-mers, the FracMinHash keep of a scaled scheme, then K2 or K2n, flat
    or in the level-grouped descent of a hierarchical index) in
    power-of-two length buckets;
    longer reads are hashed on the host and probed on the device: top-k
    on a flat index (DeviceHIXF.topk_async_packed), the per-IXF
    traversal on a hierarchical one (DeviceHIXF.counts_async).  Reads the
    device result cannot decide exactly (hash capacity overflow, top-k
    truncation) take the host oracle, as in the reference package.
  - 'sharded': the device engine over a reads x bins mesh of ranks
    (device/sharding.py): every rank holds its bins shard of the index,
    the fused steps and the long reads' traversal run bin-sharded, and
    every rank ends with the whole result; only rank 0 writes the report.
    One process drives one device, so a mesh of more than one rank needs
    ``--distributed`` (device/distributed.py).
  - 'host': the numpy oracle recursion; it runs without JAX and without
    a GPU.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..device.hixf_search import DeviceHIXF
from ..device.probe import pack_hash_lists
from ..hash import device_syncmer as dsync
from ..hash import schemes as _schemes
from ..hash.schemes import search_hashes
from ..hixf.index import TaxorIndex, load_index
from ..io.fastx import iter_fastx_chunks
from ..utils.logging import maybe_profile
from .thresholds import Thresholder

# positions per fused dispatch: bounds the device working set per call
POS_BUDGET = 2048 * 2048


@dataclass
class SearchConfig:
    index_file: str = ""
    query_file: str = ""
    report_file: str = "search.out"
    threads: int = 1  # host hashing threads (hash/schemes.NUM_THREADS)
    percentage: float = -1.0
    error_rate: float = 0.04
    engine: str = "device"  # 'device' | 'host' | 'sharded'
    batch_size: int = 1024
    # batches in flight on worker threads: packing, upload, the device
    # step, download and decoding of consecutive batches overlap
    pipeline_depth: int = 4
    write_time: bool = False
    topk: int = 16  # device candidate slots; auto-escalates on truncation
    profile_trace: str = ""  # torch.profiler trace directory (utils/logging)
    # sharded engine mesh ('reads' x 'bins'); 0 = the default over the world
    mesh_reads: int = 0
    mesh_bins: int = 0


HEADER = (
    "#QUERY_NAME\tACCESSION\tREFERENCE_NAME\tTAXID\tREF_LEN\tQUERY_LEN\t"
    "QHASH_COUNT\tQHASH_MATCH\tTAX_STR\tTAX_ID_STR\n"
)


def _format_rows(
    rec_id: str,
    seq_len: int,
    hash_count: int,
    pairs: list[tuple[int, int]],
    index: TaxorIndex,
    ub2sp: dict[int, int],
) -> str:
    """The rows of one read (taxor_search.cpp:268-307): every bin within
    0.8 of the read's best count, or the 6-column no-hit row."""
    if not pairs:
        return f"{rec_id}\t-\t-\t-\t-\t{seq_len}\n"
    max_count = max(c for _, c in pairs)
    out = []
    for user_bin, count in pairs:
        if float(count) < float(max_count) * 0.8:
            continue
        sp = index.species[ub2sp[user_bin]]
        out.append(
            f"{rec_id}\t{sp.accession_id}\t{sp.organism_name}\t{sp.taxid}\t"
            f"{sp.seq_len}\t{seq_len}\t{hash_count}\t{count}\t"
            f"{sp.taxnames_string}\t{sp.taxid_string}\n"
        )
    return "".join(out)


def _scaling_ratio(hash_count: int, seq_len: int, kmer_size: int) -> float:
    """(double)hash_count / ((double)len - k + 1.0) with C double
    semantics (taxor_search.cpp:263): seq_len == k-1 yields 0/0 = NaN
    (hash_count is always 0 for such reads), which the fracminhash model
    propagates to the size_t sentinel — 'no read can pass', exactly as
    the reference binary computes it.  Only that model consumes the
    ratio."""
    denom = float(seq_len) - float(kmer_size) + 1.0
    if denom == 0.0:
        return float("nan") if hash_count == 0 else float("inf")
    return float(hash_count) / denom


def _read_threshold(thresholder, hash_count, seq_len, kmer_size):
    """The per-read threshold exactly as the host prepare computes it."""
    return int(thresholder.get(
        hash_count, _scaling_ratio(hash_count, seq_len, kmer_size)))


def e2e_thresholds(thresholder, counts, lens, kmer_size) -> np.ndarray:
    """int64 [R]: the threshold of each read of the fused result (its
    hash count, its length), memoized on that pair, the only inputs the
    models consume; exact host float64 math."""
    thr_cache = getattr(thresholder, "_e2e_thr_cache", None)
    if thr_cache is None:
        thr_cache = thresholder._e2e_thr_cache = {}
    thr = np.empty(len(lens), dtype=np.int64)
    for r, key in enumerate(zip(np.asarray(counts).tolist(), lens)):
        t = thr_cache.get(key)
        if t is None:
            t = thr_cache[key] = _read_threshold(
                thresholder, key[0], key[1], kmer_size)
        # size_t-wrapped "impossible" thresholds are >= 2^63 and would
        # overflow int64; any value above every possible count is
        # equivalent for the comparisons that use them
        thr[r] = min(t, 2**62)
    return thr


def _pairs_from_e2e(vals, users, counts, n_emit, seqs, index, scheme,
                    thresholder, dfs_rank, hcap, sums=None,
                    trunc_out: list | None = None):
    """Decode the fused device result (device/e2e.py).

    The device returns top-k RAW run sums; this applies the per-read
    threshold (exact host float64: no device float math in the parity
    path) and detects the two truncation cases that need the host
    oracle: raw emissions overflowing the device hash capacity (n_emit
    counts pre-dedup emissions, and duplicates can push unique k-mers
    past the hcap slice even when counts <= hcap; hcap is the capacity
    the device step used, passed through the collector), and all k
    candidate slots surviving the threshold and the 0.8*max pre-filter.
    ``trunc_out`` receives the second set: the pipeline's top-k
    escalation trigger (a larger k cannot fix an hcap overflow).

    sums (the descend-all chain-min mode): vals are then min(leaf sum,
    ancestor merged sums), the emission test value, and sums the leaf
    sums to report.  The 0.8 shortcut is unsound there (a dropped slot's
    sum may exceed the kept maximum), so truncation falls back whenever
    all k slots pass the threshold."""
    k_sch = scheme.kmer_size
    kk = vals.shape[1]

    def host_fallback(seq):
        hl = search_hashes([seq], scheme)[0]
        hc = hl.shape[0]
        thr = _read_threshold(thresholder, hc, len(seq), k_sch)
        return index.hixf.membership(hl, int(thr)), hc

    Rs = len(seqs)  # device rows may include batch padding: drop it
    counts = np.asarray(counts, dtype=np.int64)[:Rs]
    n_emit = np.asarray(n_emit, dtype=np.int64)[:Rs]
    vals = np.asarray(vals, dtype=np.int64)[:Rs]
    users = np.asarray(users, dtype=np.int64)[:Rs]
    thr = e2e_thresholds(thresholder, counts,
                          [len(s) for s in seqs], k_sch)
    ok = (vals >= thr[:, None]) & (users >= 0)
    n = ok.sum(axis=1)  # vals descending => ok is a prefix
    f64 = np.float64
    if sums is not None:
        sums = np.asarray(sums, dtype=np.int64)[:Rs]
        trunc = n == kk  # no 0.8 shortcut on chain-min candidates
        vals = sums  # report the leaf sums, not the emission-test minima
    else:
        trunc = (n == kk) & (
            vals[:, kk - 1].astype(f64) >= vals[:, 0].astype(f64) * 0.8)
    if trunc_out is not None:
        trunc_out.append(trunc)
    need_fallback = (n_emit > hcap) | trunc
    # dfs ordering of the candidate slots (argsort only for multi-hit
    # reads)
    vals_l = vals.tolist()
    users_l = users.tolist()
    n_l = n.tolist()
    counts_l = counts.tolist()
    fb_l = need_fallback.tolist()
    pairs_per_read = []
    hash_counts = []
    for r, seq in enumerate(seqs):
        if fb_l[r]:
            pairs, hc = host_fallback(seq)
            pairs_per_read.append(pairs)
            hash_counts.append(hc)
            continue
        nn = n_l[r]
        if nn == 0:
            pairs_per_read.append([])
        elif nn == 1:
            pairs_per_read.append([(users_l[r][0], vals_l[r][0])])
        else:
            u = users[r, :nn]
            order = np.argsort(dfs_rank[u], kind="stable")
            vr, ur = vals_l[r], users_l[r]
            pairs_per_read.append([(ur[i], vr[i]) for i in order])
        hash_counts.append(counts_l[r])
    return pairs_per_read, hash_counts


def _pairs_from_topk(vals, users, thresholds, hash_lists, index, dfs_rank):
    """Per-read pairs from the compact device result.  A read whose k-th
    candidate still passes the 0.8*max rule may have lost qualifying bins
    to truncation: the exact host oracle decides it (rare)."""
    k = vals.shape[1]
    pairs_per_read = []
    for r in range(vals.shape[0]):
        n = int((vals[r] >= 0).sum())
        if n == k and float(vals[r, k - 1]) >= float(vals[r, 0]) * 0.8:
            pairs_per_read.append(
                index.hixf.membership(hash_lists[r], int(thresholds[r]))
            )
            continue
        u = users[r, :n]
        order = np.argsort(dfs_rank[u], kind="stable")
        pairs_per_read.append(
            [(int(u[i]), int(vals[r, i])) for i in order]
        )
    return pairs_per_read


def _pairs_from_counts(counts, emitted, dfs_rank):
    """Per-read pairs from exact per-user-bin counts and emission masks."""
    pairs_per_read = []
    for r in range(counts.shape[0]):
        ubs = np.nonzero(emitted[r])[0]
        order = np.argsort(dfs_rank[ubs], kind="stable")
        pairs_per_read.append(
            [(int(u), int(counts[r, u])) for u in ubs[order]]
        )
    return pairs_per_read


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
    # the fused step covers every device-extractable scheme: syncmers,
    # minimisers and plain k-mers, with or without FracMinHash scaling
    use_e2e = (config.engine in ("device", "sharded")
               and device_hixf is not None
               and device_hixf.e2e_capable(thresholder, scheme))

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
                # sums: the descend-all mode's leaf sums to report, or None
                vals, users, counts, n_emit, hcap, sums = collect()
                trunc_out: list = []
                prs, hcs = _pairs_from_e2e(
                    vals, users, counts, n_emit, gseqs, index, scheme,
                    thresholder, dfs_rank, hcap, sums=sums,
                    trunc_out=trunc_out)
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
    # in submission order, so the output is deterministic.  Under a mesh
    # one worker: every rank must issue its collectives in the same order
    depth = (1 if getattr(device_hixf, "mesh", None) is not None
             else max(1, config.pipeline_depth))
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


def search_mesh(config: SearchConfig, device):
    """The sharded engine's reads x bins mesh: over the world of ranks
    where a process group is up (``--distributed``), else the one
    process's 1 x 1 mesh (one process drives one device)."""
    import torch.distributed as dist

    from ..device.distributed import global_mesh, make_mesh
    from ..device.sharding import COLLECTIVES

    if dist.is_initialized():
        mesh = global_mesh(config.mesh_reads or None,
                           config.mesh_bins or None, device)
    else:
        mesh = make_mesh(config.mesh_reads or 1, config.mesh_bins or 1,
                         device)
    COLLECTIVES.mesh = mesh.describe()
    return mesh


def run_search(config: SearchConfig, device="cuda") -> dict:
    """Outer product over comma-separated query and index lists
    (taxor_search.cpp:340-360); the device engines run on ``device``.
    Returns the phase timings written to <out>.time.  The sharded engine
    leaves the world of ranks (destroys the process group) at its end."""
    if config.engine not in ("device", "host", "sharded"):
        raise ValueError(f"unknown engine {config.engine!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu to run the plain twins)")
    if config.engine != "sharded":
        return _run_search(config, device)
    from ..device.distributed import shutdown

    try:
        return _run_search(config, device)
    finally:
        shutdown()


def _run_search(config: SearchConfig, device: torch.device) -> dict:
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
    mesh = None
    report_file = config.report_file
    if config.engine == "sharded":
        t0 = time.perf_counter()
        mesh = search_mesh(config, device)
        timings["index_io"] += time.perf_counter() - t0
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank():
            # every rank computes the whole result; rank 0 writes it
            report_file = os.devnull
    with open(report_file, "w") as out, \
            maybe_profile(config.profile_trace, device):
        out.write(HEADER)
        for query in query_files:
            for index in loaded:
                dhixf = None
                if config.engine != "host":
                    t0 = time.perf_counter()
                    dhixf = DeviceHIXF.from_hixf(index.hixf, device, mesh)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    timings["index_io"] += time.perf_counter() - t0
                t = search_single(index, query, out, config, dhixf)
                timings["reads_io"] += t["reads_io"]
                timings["compute"] += t["compute"]

    if config.write_time and report_file == config.report_file:
        with open(config.report_file + ".time", "w") as fh:
            fh.write("Index I/O\tReads I/O\tCompute\n")
            fh.write(f"{timings['index_io']:.2f}\t{timings['reads_io']:.2f}"
                     f"\t{timings['compute']:.2f}")
    return timings
