"""HIXF construction from a layout tree.

Mirrors the recursive reference build (src/hixf/build/hierarchical_build.cpp,
create_ixfs_from_chopper_pack.cpp) with the same post-order semantics:
children (merged bins) are built first, a merged bin's technical bin in the
parent stores the *union* of all hashes of its subtree, leaf records hash
their FASTA files, split records chunk their hash set over consecutive
technical bins (insert_into_bins.cpp:9-30: chunk_size = n/num_bins + 1).

Deviations (documented):
  - peak-RSS bounding uses an optional spill directory holding per-file and
    per-subtree hash arrays as .npy files (the analog of the reference's
    hixf_tmp/ temp hash files, hierarchical_build.cpp:69-117 /
    temp_hash_file.cpp) instead of spilling only the top two levels,
  - hash-set chunking for split bins follows sorted hash order rather than
    the C++ unordered-set iteration order.  Split-bin membership totals per
    user bin are unchanged (runs are summed at query time), so
    classification output is identical,
  - user-bin / IXF ids are assigned in deterministic DFS order.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

from ..hash.schemes import HashScheme, build_hashes
from ..io.fastx import iter_fastx
from ..ixf.xor_filter import build_ixf
from .container import HIXF
from .layout import LayoutNode

U64 = np.uint64


def hashes_for_files(filenames: list[str], scheme: HashScheme) -> np.ndarray:
    """Union hash set over the records of the given FASTA files
    (compute_hashes.cpp:76-142)."""
    record_seqs: list[bytes] = []
    for f in filenames:
        for rec in iter_fastx(f):
            record_seqs.append(rec.seq)
    return build_hashes(record_seqs, scheme)


_STORE_SEQ = itertools.count()


class HashStore:
    """file/key -> uint64 hash array, optionally spilled to .npy files on
    disk (the reference's hixf_tmp/ analog) so GTDB-scale builds bound
    their peak RSS.

    Multiple stores may share one spill directory (run_build uses one
    for per-file hash sets and the build uses another for per-node
    unions), so filenames carry a per-store prefix — without it the
    second store's counter collides with the first's and a pop() on one
    deletes the other's live file."""

    def __init__(self, spill_dir: str | None = None):
        self.spill_dir = spill_dir
        self._data: dict[str, np.ndarray | str] = {}
        # itertools.count: next() is atomic under the GIL, so put() from
        # the root-parallel build_node threads can never mint the same
        # spill filename twice (a bare `+= 1` read-modify-write could,
        # silently aliasing two keys to one overwritten file)
        self._counter = itertools.count(1)
        self._prefix = f"hashes_s{next(_STORE_SEQ)}"
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def put(self, key: str, hashes: np.ndarray) -> None:
        if self.spill_dir:
            path = os.path.join(self.spill_dir,
                                f"{self._prefix}_{next(self._counter):06d}.npy")
            np.save(path, hashes)
            self._data[key] = path
        else:
            self._data[key] = hashes

    def get(self, key: str) -> np.ndarray:
        v = self._data[key]
        if isinstance(v, str):
            return np.load(v)
        return v

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def pop(self, key: str) -> None:
        v = self._data.pop(key, None)
        if isinstance(v, str) and os.path.exists(v):
            os.remove(v)


# target bytes of raw sequence hashed per batch in streaming mode
_GROUP_BYTES = 256 * 1024 * 1024


def precompute_file_hashes(
    filenames: list[str],
    scheme: HashScheme,
    spill_dir: str | None = None,
) -> HashStore:
    """Hash every file's records in batched scans (the scanners need many
    lanes/threads to amortize; per-file calls starve them).  Files are
    processed in bounded groups so raw sequence never exceeds ~_GROUP_BYTES
    of RAM; results land in a HashStore (RAM or spilled)."""
    from ..hash.encode import build_record_seq, encode_dna4
    from ..hash.minimizer import minimiser_hashes
    from ..hash.schemes import _syncmer_sets_batch, scaling_filter

    uniq_files = list(dict.fromkeys(filenames))
    store = HashStore(spill_dir)

    def flush(group_files, record_seqs, owner):
        if scheme.use_syncmer:
            trimmed = [build_record_seq(x) for x in record_seqs]
            sets = _syncmer_sets_batch(trimmed, scheme, dna5=False)
        else:
            sets = [
                minimiser_hashes(encode_dna4(x), scheme.kmer_size,
                                 scheme.window_size)
                for x in record_seqs
            ]
        per_file: dict[str, list[np.ndarray]] = {f: [] for f in group_files}
        for i, h in zip(owner, sets):
            per_file[group_files[i]].append(h)
        for f in group_files:
            parts = per_file[f]
            h = (np.unique(np.concatenate(parts)) if parts
                 else np.zeros(0, dtype=U64))
            if scheme.scaling > 1:
                h = scaling_filter(h, scheme.scaling)
            store.put(f, h)

    group_files: list[str] = []
    record_seqs: list[bytes] = []
    owner: list[int] = []
    group_bytes = 0
    for f in uniq_files:
        group_files.append(f)
        fi = len(group_files) - 1
        for rec in iter_fastx(f):
            record_seqs.append(rec.seq)
            owner.append(fi)
            group_bytes += len(rec.seq)
        if group_bytes >= _GROUP_BYTES:
            flush(group_files, record_seqs, owner)
            group_files, record_seqs, owner = [], [], []
            group_bytes = 0
    if group_files:
        flush(group_files, record_seqs, owner)
    return store


def split_chunks(hashes: np.ndarray, number_of_bins: int) -> list[np.ndarray]:
    """Reference chunking: chunk_size = n // num_bins + 1
    (insert_into_bins.cpp:15)."""
    n = hashes.shape[0]
    chunk = n // number_of_bins + 1
    return [hashes[i : i + chunk] for i in range(0, max(n, 1), chunk)]


def build_hixf_from_layout(
    root: LayoutNode,
    scheme: HashScheme,
    hash_fn=None,
    spill_dir: str | None = None,
    threads: int = 1,
    uniform_level_geometry: bool = True,
    timings: dict | None = None,
) -> tuple[HIXF, dict[str, int]]:
    """Build the full HIXF.  ``hash_fn(filenames) -> uint64 array`` may be
    injected for tests; defaults to hashing the FASTA files.  With
    ``spill_dir``, per-file hash sets and subtree unions live on disk and
    are loaded per node, bounding peak RSS to ~one IXF's contents.

    uniform_level_geometry (documented divergence #13): every IXF at the
    same tree depth is sized for the LEVEL's maximum bin cardinality, so
    siblings share (block_length, seed) and the device traversal can
    probe a whole level as ONE wide kernel call (probe positions are a
    function of (hash, seed, block_length) only).  The reference sizes
    each IXF individually (construct_ixf.cpp:28,58); equal sizing only
    adds slack slots — membership semantics are unchanged, false-positive
    noise re-rolls (see the layout-invariance waiver in DIVERGENCES.md).

    Returns (hixf, user_bin_of_filename) where filenames are joined with
    ';' per record like the reference (update_user_bins.cpp:24-29).
    """
    spill = HashStore(spill_dir) if spill_dir else None
    if hash_fn is None:
        cache = precompute_file_hashes(root.all_filenames(), scheme,
                                       spill_dir=spill_dir)

        def hash_fn(filenames):
            parts = [cache.get(f) for f in filenames]
            if len(parts) == 1:
                return parts[0]
            return (np.unique(np.concatenate(parts)) if parts
                    else np.zeros(0, dtype=U64))

    ixfs: list = []
    next_ids: list = []
    bin_maps: list = []
    filenames: list[str] = []
    user_bin_of_filename: dict[str, int] = {}
    import threading as _threading

    lock = _threading.Lock()

    # two-phase when equalizing level geometry: phase 1 collects every
    # node's per-bin hash lists (spilled when a spill dir is given),
    # phase 2 sizes each level by its max bin cardinality and constructs
    pending: list[tuple[int, int, object]] = []  # (ixf_pos, depth, bins)

    def _stash_bins(ixf_pos: int, depth: int, per_bin):
        if spill is not None:
            keys = []
            for b, arr in enumerate(per_bin):
                key = f"bins_{ixf_pos}_{b}"
                spill.put(key, arr)
                keys.append(key)
            pending.append((ixf_pos, depth, keys))
        else:
            pending.append((ixf_pos, depth, list(per_bin)))

    def build_node(node: LayoutNode, is_root: bool = False, depth: int = 0):
        """Returns (ixf_pos, union-of-subtree hashes)."""
        with lock:
            ixf_pos = len(ixfs)
            ixfs.append(None)  # reserve slot; children appended after
            nb = node.num_technical_bins
            next_ids.append(np.full(nb, ixf_pos, dtype=np.int64))
            bin_maps.append(np.full(nb, -1, dtype=np.int64))

        per_bin: list[np.ndarray] = [
            np.zeros(0, dtype=U64) for _ in range(nb)
        ]

        # children first (loop_over_children.cpp:43-87); parallel at the
        # root only, like the reference (threads>1 only at root level)
        child_bins = sorted(node.children)
        if is_root and threads > 1 and len(child_bins) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=threads) as ex:
                results = list(ex.map(
                    lambda b: (b, build_node(node.children[b],
                                             depth=depth + 1)),
                    child_bins,
                ))
        else:
            results = [(b, build_node(node.children[b], depth=depth + 1))
                       for b in child_bins]
        for b, (child_pos, child_ref) in results:
            next_ids[ixf_pos][b] = child_pos
            if spill is not None:
                per_bin[b] = spill.get(child_ref)
                spill.pop(child_ref)
            else:
                per_bin[b] = child_ref
            # bin_maps stays -1: merged bin

        for rec in node.records:
            with lock:
                ub = len(filenames)
                joined = ";".join(rec.filenames)
                filenames.append(joined)
                user_bin_of_filename[joined] = ub
            hashes = hash_fn(rec.filenames)
            if rec.number_of_bins == 1:
                per_bin[rec.bin_index] = hashes
            else:
                for j, chunk in enumerate(
                    split_chunks(hashes, rec.number_of_bins)
                ):
                    per_bin[rec.bin_index + j] = chunk
            bin_maps[ixf_pos][
                rec.bin_index : rec.bin_index + rec.number_of_bins
            ] = ub

        union = (
            np.unique(np.concatenate([b for b in per_bin if b.size]))
            if any(b.size for b in per_bin)
            else np.zeros(0, dtype=U64)
        )
        if uniform_level_geometry:
            with lock:
                _stash_bins(ixf_pos, depth, per_bin)
        else:
            ixfs[ixf_pos] = build_ixf(per_bin)
        per_bin.clear()
        if spill is not None:
            key = f"union_{ixf_pos}"
            spill.put(key, union)
            return ixf_pos, key
        return ixf_pos, union

    import time as _time

    t0 = _time.perf_counter()
    build_node(root, is_root=True)
    if timings is not None:
        timings["collect_bins_s"] = _time.perf_counter() - t0

    t0 = _time.perf_counter()
    if uniform_level_geometry:
        # phase 2: size each level for its maximum bin cardinality so
        # siblings share geometry.  Construction parallelizes over ALL
        # pending IXFs of all levels (the reference only parallelizes
        # the root's children, loop_over_children.cpp:74-87): once each
        # level's max cardinality is known the per-IXF peels are
        # independent, and the C++ peeler (native/xor_peel.cpp) releases
        # the GIL for the duration of the call.
        from collections import defaultdict

        by_depth: dict[int, list[tuple[int, object]]] = defaultdict(list)
        for ixf_pos, depth, bins_ref in pending:
            by_depth[depth].append((ixf_pos, bins_ref))

        def _load_bins(bins_ref):
            if spill is not None:
                return [spill.get(k) for k in bins_ref]
            return bins_ref

        level_max: dict[int, int] = {}
        for depth, level in by_depth.items():
            mx = 0
            for _, bins_ref in level:
                for arr in _load_bins(bins_ref):
                    # build_ixf dedups before sizing; match that here
                    mx = max(mx, int(np.unique(arr).shape[0]))
            level_max[depth] = max(mx, 1)

        jobs = [(depth, ixf_pos, bins_ref)
                for depth in sorted(by_depth)
                for ixf_pos, bins_ref in by_depth[depth]]
        # divide the native peeler's threads among the outer workers:
        # each build_ixf defaults to os.cpu_count() peel threads, so an
        # outer pool of W would otherwise oversubscribe to W x ncpu
        outer = min(threads, len(jobs)) if threads > 1 else 1
        inner = max(1, (os.cpu_count() or 1) // max(outer, 1))

        def _construct(job):
            depth, ixf_pos, bins_ref = job
            ixfs[ixf_pos] = build_ixf(
                _load_bins(bins_ref),
                max_elements_per_bin=level_max[depth],
                threads=inner)
            if spill is not None:
                for k in bins_ref:
                    spill.pop(k)

        if outer > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=outer) as ex:
                list(ex.map(_construct, jobs))
        else:
            for job in jobs:
                _construct(job)
    if timings is not None:
        timings["peel_s"] = _time.perf_counter() - t0
    hixf = HIXF(
        ixfs=ixfs,
        next_ixf_id=next_ids,
        bin_to_user=bin_maps,
        user_bin_filenames=filenames,
    )
    hixf.validate()
    return hixf, user_bin_of_filename
