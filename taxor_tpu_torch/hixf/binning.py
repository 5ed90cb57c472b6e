"""Hierarchical binning layout DP — the chopper equivalent.

The reference shells out to chopper's ``hierarchical_binning`` DP
(taxor_build.cpp:168-233, 461-491): order user bins, pick the best
``t_max`` from a sweep {64, 128, ..., 4096, ~sqrt(n)} by expected query
cost, and assign every user bin either to a run of SPLIT technical bins or
into a MERGED technical bin whose members recurse into a child IXF.

This is a faithful reimplementation of the published HIBF DP (Mehringer
et al. 2023) rather than a byte-port of chopper:

  M[i][j] = minimal possible maximum technical-bin cardinality when the
  first j+1 user bins occupy the first i+1 technical bins, with
    split transition:  bin j alone spread over bins i'..i
                       (size ceil(c_j / (i-i'+1))),
    merge transition:  bins j'..j together in technical bin i
                       (size = HLL union estimate of their hash sets).

Documented deviations from chopper:
  - union estimates come from HLL sketches built over the *index* hash
    sets (dna4 path) rather than a separate dna5 counting pass — layout
    sizing only, classification output is unaffected,
  - transition ranges are capped (MAX_SPLIT; merge window =
    _merge_window(n), scaling with n so balance survives at scale)
    where chopper searches the full range; the degenerate full-span
    one-bin merge is excluded (see _merge_window / the DP base case),
  - similarity-based user-bin rearrangement uses greedy HLL-Jaccard
    nearest-neighbor chaining (see ``rearrange_bins``) instead of
    chopper's interval-wise agglomerative clustering,
  - the expected-query-cost model is TPU-native: probing a level with B
    technical bins costs ``c0 + B/512`` relative units (lane tiles per
    probe row), weighted by each user bin's share of hashes, instead of
    chopper's CPU-measured interpolation table.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..utils.u64np import wyhash64
from .hll import HyperLogLog
from .layout import LayoutNode, LayoutRecord

MAX_SPLIT = 128
MAX_MERGE = 1024
_SKETCH_BITS = 10


def _merge_window(n: int) -> int:
    """DP merge-window width.  A FIXED cap silently breaks balance at
    scale: packing n user bins into t technical bins needs merges of
    ~n/t members, and when n/64 exceeds the cap the DP is forced into
    window-sized merges with whatever unions the order happens to give
    — on a skewed build of tens of thousands of bins the root's largest
    bin grew to several times the balanced size, and because every
    IXF's slot count is 1.23x its MAX bin (the reference's shared
    geometry, construct_ixf.cpp:28), the whole index padded to about
    three times its balanced size.  Scale the window with
    n (2x the largest merge the 64-bin sweep floor can need); band and
    DP costs are linear in it."""
    return min(n, max(MAX_MERGE, -(-n // 32)))


def next_multiple_of_64(n: int) -> int:
    return ((n + 63) // 64) * 64


@dataclass
class _Bin:
    filenames: list[str]
    count: float
    sketch: HyperLogLog


def make_sketch(hashes: np.ndarray, bits: int = _SKETCH_BITS) -> HyperLogLog:
    """Sketch over re-mixed hash values (minimizer-path values are not
    uniform; wyhash64 whitens both paths)."""
    sk = HyperLogLog(bits)
    sk.add_many(wyhash64(hashes))
    return sk


_POW2 = 2.0 ** -np.arange(70, dtype=np.float64)


def _estimate_from_registers(regs: np.ndarray) -> float:
    m = regs.shape[0]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / _POW2[regs].sum()
    if e <= 2.5 * m:
        zeros = int((regs == 0).sum())
        if zeros:
            e = m * math.log(m / zeros)
    return e


def _nthreads() -> int:
    import os

    return max(1, os.cpu_count() or 1)


def _union_band(bins: list[_Bin], W: int) -> np.ndarray:
    """ubT[j, d] = estimated union cardinality of bins (j-d .. j),
    monotone non-decreasing along d (a superset union cannot shrink;
    estimator dips are HLL noise — monotonizing makes the DP merge
    walk's early exit exact).  ubT[j, 0] = max(count_j, est_j), the
    diagonal the DP's single-bin merges consume.  Entries with d > j
    are +inf.

    Computed ONCE per layout: children of the recursion are contiguous
    slices of the same bin order, so a child's band is a row slice of
    the parent's (the global window (j-d..j) coincides with the local
    one).  Native kernel in native/layout_dp.cpp; numpy fallback below
    is the test oracle.
    """
    from ..native import get_lib

    n = len(bins)
    regs = np.stack([b.sketch.registers for b in bins])  # [n, m] uint8
    m = regs.shape[1]
    P = np.ascontiguousarray(_POW2[regs])  # [n, m] f64, exact pow2
    counts = np.array([b.count for b in bins], dtype=np.float64)
    ubT = np.full((n, W), np.inf)
    lib = get_lib()
    if lib is not None and hasattr(lib, "hll_union_band"):
        lib.hll_union_band(P.ctypes.data, counts.ctypes.data, n, m, W,
                           ubT.ctypes.data, _nthreads())
        return ubT
    for j in range(n):
        acc = P[j].copy()
        prev = max(counts[j], _est_from_pow(acc, m))
        ubT[j, 0] = prev
        for d in range(1, min(W - 1, j) + 1):
            np.minimum(acc, P[j - d], out=acc)
            e = max(prev, _est_from_pow(acc, m))
            ubT[j, d] = e
            prev = e
    return ubT


def _est_from_pow(acc: np.ndarray, m: int) -> float:
    """HLL estimate from the 2^-register representation (union by
    elementwise min); same formula as _estimate_from_registers."""
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / acc.sum()
    if e <= 2.5 * m:
        zeros = int((acc == 1.0).sum())
        if zeros:
            e = m * math.log(m / zeros)
    return e


def _dp_layout(bins: list[_Bin], tmax: int, ubT: np.ndarray | None = None):
    """Returns (max_size, placements) where placements is a list of
    ('split', j, start_bin, n_bins) and ('merge', j_from, j_to, bin)."""
    from ..native import get_lib

    n = len(bins)
    counts = np.array([b.count for b in bins], dtype=np.float64)
    if ubT is None:
        ubT = _union_band(bins, _merge_window(n))
    lib = get_lib()
    if lib is not None and hasattr(lib, "layout_dp"):
        return _dp_layout_native(lib, counts, ubT, tmax)
    return _dp_layout_numpy(counts, ubT, tmax)


def _dp_layout_native(lib, counts: np.ndarray, ubT: np.ndarray, tmax: int):
    import ctypes

    n = counts.shape[0]
    W = ubT.shape[1]
    counts = np.ascontiguousarray(counts)
    ubT = np.ascontiguousarray(ubT)
    kind = np.empty(n, dtype=np.int32)
    a = np.empty(n, dtype=np.int32)
    b = np.empty(n, dtype=np.int32)
    c = np.empty(n, dtype=np.int32)
    ms = ctypes.c_double()
    cnt = lib.layout_dp(counts.ctypes.data, n, ubT.ctypes.data, W, tmax,
                        MAX_SPLIT, ctypes.byref(ms), kind.ctypes.data,
                        a.ctypes.data, b.ctypes.data, c.ctypes.data,
                        _nthreads())
    if cnt < 0:
        raise RuntimeError("DP backtrack failed")
    placements = []
    for idx in range(cnt - 1, -1, -1):  # C++ emits backtrack order
        if kind[idx] == 0:
            placements.append(("split", int(a[idx]), int(b[idx]),
                               int(c[idx])))
        else:
            placements.append(("merge", int(a[idx]), int(b[idx]),
                               int(c[idx])))
    return float(ms.value), placements


def _dp_layout_numpy(counts: np.ndarray, ubT: np.ndarray, tmax: int):
    """Pure-numpy DP over the union band — the oracle the native kernel
    is tested against (same transition order and tie-breaking: first
    minimum in ascending i' / ascending j')."""
    n = counts.shape[0]
    W = ubT.shape[1]
    INF = np.inf
    rows = max(1, min(tmax, n * MAX_SPLIT))
    M = np.full((rows, n), INF)
    back_kind = np.full((rows, n), -1, dtype=np.int8)
    back_arg = np.full((rows, n), -1, dtype=np.int32)

    # base row: user bin 0 split across bins 0..i
    for i in range(min(rows, MAX_SPLIT)):
        M[i, 0] = math.ceil(counts[0] / (i + 1))
        back_kind[i, 0] = 0
        back_arg[i, 0] = 0
    # merged-at-bin-0 base: bins 0..j all in technical bin 0.  The full
    # span (j == n-1) is excluded — it ties the optimum on plateaued
    # union bands and recurses into a child identical to its parent
    # (see the native kernel's comment)
    jmax0 = min(n - 1, W)
    jj = np.arange(1, jmax0)
    if jj.size:
        M[0, 1:jmax0] = ubT[jj, jj]
        back_kind[0, 1:jmax0] = 1
        back_arg[0, 1:jmax0] = 0

    for i in range(1, rows):
        # split transitions, vectorized over j and i'
        lo = max(0, i - MAX_SPLIT + 1)
        ip = np.arange(max(1, lo), i + 1)  # i' >= 1 (i'-1 >= 0)
        if ip.size:
            nbins = (i - ip + 1)[:, None]  # [k,1]
            corrected = np.ceil(counts[None, 1:] / nbins)  # [k, n-1]
            cand = np.maximum(M[ip - 1, :-1], corrected)  # [k, n-1]
            k_best = np.argmin(cand, axis=0)
            v_best = cand[k_best, np.arange(n - 1)]
            better = v_best < M[i, 1:]
            M[i, 1:] = np.where(better, v_best, M[i, 1:])
            back_kind[i, 1:][better] = 0
            back_arg[i, 1:][better] = ip[k_best[better]]

        # merge transitions: for each j the best j' of
        # max(M[i-1, j'-1], U[j'..j]); vectorized over j per window
        # offset d = j - j'.  First-min over ASCENDING j' == largest d
        # among ties, hence the reversed-axis argmin.
        mprev = M[i - 1]
        cand = np.full((n, W), INF)
        for d in range(min(W, n - 1)):
            j0 = d + 1
            cand[j0:, d] = np.maximum(mprev[: n - 1 - d], ubT[j0:, d])
        dbest = (W - 1) - np.argmin(cand[:, ::-1], axis=1)
        v = cand[np.arange(n), dbest]
        better = v < M[i]
        better[0] = False
        M[i][better] = v[better]
        back_kind[i][better] = 1
        back_arg[i][better] = (np.arange(n) - dbest)[better]

    # best final row: smallest max-size using at most tmax bins
    i = int(np.argmin(M[:, n - 1]))
    max_size = M[i, n - 1]
    placements = []
    j = n - 1
    while j >= 0:
        kind = back_kind[i, j]
        arg = int(back_arg[i, j])
        if kind == 0:
            placements.append(("split", j, arg, i - arg + 1))
            i, j = arg - 1, j - 1
        elif kind == 1:
            placements.append(("merge", arg, j, i))
            i, j = i - 1, arg - 1
        else:
            raise RuntimeError("DP backtrack failed")
    placements.reverse()
    return max_size, placements


def _build_node(bins: list[_Bin], tmax: int,
                ubT: np.ndarray | None = None) -> LayoutNode:
    if ubT is None:
        ubT = _union_band(bins, _merge_window(len(bins)))
    max_size, placements = _dp_layout(bins, tmax, ubT)
    node = LayoutNode()
    bin_sizes: list[tuple[int, float]] = []
    ntb = 0
    for p in placements:
        if p[0] == "split":
            _, j, start, nbins = p
            node.records.append(
                LayoutRecord(bins[j].filenames, start, nbins)
            )
            ntb = max(ntb, start + nbins)
            bin_sizes.append((start, bins[j].count / nbins))
        else:
            _, jf, jt, tb = p
            ntb = max(ntb, tb + 1)
            if jf == jt:
                node.records.append(
                    LayoutRecord(bins[jf].filenames, tb, 1)
                )
                bin_sizes.append((tb, bins[jf].count))
            else:
                members = bins[jf : jt + 1]
                child_tmax = min(
                    tmax, next_multiple_of_64(max(64, len(members)))
                )
                # the child's union band IS the parent's row slice
                # (contiguous order); no re-sketching down the tree
                child = _build_node(members, child_tmax,
                                    ubT[jf : jt + 1])
                node.children[tb] = child
                # merged-bin cardinality straight from the band (the
                # count-floored, monotonized estimate — >= the raw
                # register-merge value, so IXF geometry only rounds up)
                bin_sizes.append((tb, float(ubT[jt, jt - jf])))
    node.num_technical_bins = ntb
    node.max_bin_index = (
        max(bin_sizes, key=lambda t: t[1])[0] if bin_sizes else 0
    )
    # estimated max bin cardinality -> IXF geometry for the device cost
    node.est_max_card = max((sz for _, sz in bin_sizes), default=1.0)
    return node


def _expected_query_cost(node: LayoutNode, c0: float = 1.0) -> float:
    """TPU-native proxy for chopper's expected_HIBF_query_cost: reaching a
    user bin costs, for every level on its path, c0 + bins/512 relative
    units (probe rows are processed in 512-bin packed lane tiles).
    Averaged over user bins (uniform read weights)."""

    def count_leaves(n: LayoutNode) -> int:
        return len(n.records) + sum(
            count_leaves(ch) for ch in n.children.values()
        )

    def cost(n: LayoutNode, path_cost: float) -> float:
        here = path_cost + c0 + n.num_technical_bins / 512.0
        total_c = len(n.records) * here
        for ch in n.children.values():
            total_c += cost(ch, here)
        return total_c

    return cost(node, 0.0) / max(1, count_leaves(node))


def _expected_query_cost_device(node: LayoutNode) -> float:
    """Expected per-read probe cost under the TPU engine, in units of
    one narrow VMEM probe pass.  This is the JAX package's TPU model,
    kept as it is; a model of the H100 kernels is ROADMAP A.10.

    The TPU probe is SCALAR-ISSUE bound (PHASES_r04.md §1): per level a
    read pays the column-tile count of the
    fingerprint block it must touch, NOT the per-bin byte count the CPU
    model rewards.  Pruning therefore only helps once a level's block
    exceeds one VMEM tile: at the root every read is active in every
    subgroup (full width); a descended child costs one 512-bin subgroup
    of its level.  This flips the layout choice for mid-size references
    — a few thousand bins fit ONE VMEM tile, where flat (one pass) beats
    any tree (>= 2 passes) — while at GTDB scale deep trees win again.
    """
    from ..ixf.xor_filter import ixf_geometry

    TILE = 7 * 2 ** 20  # scoped-VMEM budget per block (pallas_probe)
    C0 = 0.25           # launch/metadata overhead per level, in passes

    def tiles(n: LayoutNode, is_root: bool) -> float:
        card = max(1.0, float(getattr(n, "est_max_card", 1.0)))
        _, slots = ixf_geometry(int(math.ceil(card)))
        s1 = max(3 * 1024, slots)  # p10 block padding floor
        bins_pad = max(512, -(-n.num_technical_bins // 512) * 512)
        width = bins_pad if is_root else min(512, bins_pad)
        return max(1.0, (s1 * width) / TILE)

    def count_leaves(n: LayoutNode) -> int:
        return len(n.records) + sum(
            count_leaves(ch) for ch in n.children.values()
        )

    def cost(n: LayoutNode, path_cost: float, is_root: bool) -> float:
        here = path_cost + C0 + tiles(n, is_root)
        total_c = len(n.records) * here
        for ch in n.children.values():
            total_c += cost(ch, here, False)
        return total_c

    return cost(node, 0.0, True) / max(1, count_leaves(node))


_REARRANGE_BLOCK = 8192


def rearrange_bins(entries: list[_Bin]) -> list[_Bin]:
    """Similarity-based reordering — the analog of chopper's
    ``rearrange_user_bins`` + ``estimate_union`` (enabled by the reference
    at taxor_build.cpp:470-472).  Greedy nearest-neighbor chaining by
    HLL-estimated Jaccard similarity: start from the largest bin, always
    append the unplaced bin most similar to the last placed one.  Similar
    genomes become adjacent, which shrinks merged-bin unions in the DP.
    (chopper uses interval-wise agglomerative clustering; the greedy chain
    is a documented simplification with the same objective.)"""
    n = len(entries)
    if n <= 2:
        return entries
    if n > _REARRANGE_BLOCK:
        # the greedy chain is O(n^2 * m) on HLL registers (m = 4096) —
        # ~2.5e12 element ops at 25k bins.  At GTDB scale chopper itself
        # clusters within sorted intervals; chain within bounded blocks
        # of the cardinality-sorted order instead (O(n * B * m)), which
        # keeps similar-size genomes adjacent and bounds build time.
        out: list[_Bin] = []
        for off in range(0, n, _REARRANGE_BLOCK):
            out.extend(rearrange_bins(entries[off : off + _REARRANGE_BLOCK]))
        return out
    ests = np.array(
        [_estimate_from_registers(b.sketch.registers) for b in entries]
    )
    regs = np.stack([b.sketch.registers for b in entries])  # [n, m]
    from ..native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "rearrange_chain"):
        # native chain (layout_dp.cpp): f32 pow2 values are exact
        # (registers <= 55), union sums accumulate in double like here
        P32 = np.ascontiguousarray(_POW2[regs].astype(np.float32))
        order = np.empty(n, dtype=np.int32)
        start = int(np.argmax([b.count for b in entries]))
        lib.rearrange_chain(P32.ctypes.data,
                            np.ascontiguousarray(ests).ctypes.data,
                            n, regs.shape[1], start, order.ctypes.data,
                            _nthreads())
        return [entries[i] for i in order]
    placed = np.zeros(n, dtype=bool)
    cur = int(np.argmax([b.count for b in entries]))
    order = [cur]
    placed[cur] = True
    for _ in range(n - 1):
        union_regs = np.maximum(regs[cur][None, :], regs)  # [n, m]
        inv = _POW2[union_regs].sum(axis=1)
        m = regs.shape[1]
        alpha = 0.7213 / (1.0 + 1.079 / m)
        u = alpha * m * m / inv
        # small-range correction vectorized (approximate: apply where e<2.5m)
        zeros = (union_regs == 0).sum(axis=1)
        small = (u <= 2.5 * m) & (zeros > 0)
        with np.errstate(divide="ignore"):
            u = np.where(small, m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0)), u)
        jac = (ests[cur] + ests - u) / np.maximum(u, 1e-9)
        jac[placed] = -np.inf
        nxt = int(np.argmax(jac))
        order.append(nxt)
        placed[nxt] = True
        cur = nxt
    return [entries[i] for i in order]


def compute_layout_from_hashes(
    file_hashes,
    clusters: dict[str, list[str]],
    tmax: int = 4096,
    verbose: bool = False,
    artifacts_prefix: str = "",
    cost_model: str = "cpu",
) -> LayoutNode:
    """Layout for accession clusters given precomputed per-file hash sets.
    Runs the reference's t_max sweep (taxor_build.cpp:173-228): powers of
    two from 64 plus next_multiple_of_64(sqrt(n)), keeping the layout
    with the lowest expected query cost; stops as soon as the cost
    worsens (force_all_binnings is off in the reference).

    verbose: print the per-tmax cost summary, the analog of chopper's
    hibf_statistics::print_summary behind --output-verbose-statistics
    (taxor_build.cpp:213).
    cost_model: 'cpu' scores candidate layouts with the reference-style
    expected-HIBF-query-cost proxy; 'device' scores them with the TPU
    probe-pass model (_expected_query_cost_device) and additionally
    considers a FLAT layout — on the device a single-VMEM-tile flat
    index beats any tree, which the CPU model can never discover.
    artifacts_prefix: emit the counting-stage artifacts the reference
    leaves behind (taxor_build.cpp:437-442): <prefix>.count (one line per
    cluster: files;...<TAB>estimate<TAB>accession) and
    <prefix>_sketches/<accession>.hll (HLL register dumps).  chopper
    itself is not in the reference tree, so the exact byte format is
    reconstructed from the call sites; the artifacts exist for build
    RESUME (apps/build.py) and debugging, like the reference's."""
    def load(f):
        return file_hashes.get(f) if hasattr(file_hashes, "get") and not isinstance(file_hashes, dict) else file_hashes[f]

    count_fh = None
    if artifacts_prefix:
        import os

        os.makedirs(f"{artifacts_prefix}_sketches", exist_ok=True)
        count_fh = open(f"{artifacts_prefix}.count", "w")
    entries: list[_Bin] = []
    for acc in clusters:
        files = clusters[acc]
        hashes = (
            np.unique(np.concatenate([load(f) for f in files]))
            if len(files) > 1
            else load(files[0])
        )
        sketch = make_sketch(hashes)
        if count_fh is not None:
            import os

            count_fh.write(
                f"{';'.join(files)}\t{int(sketch.estimate())}\t{acc}\n")
            np.save(os.path.join(f"{artifacts_prefix}_sketches",
                                 f"{acc}.hll.npy"), sketch.registers)
        entries.append(
            _Bin(
                filenames=list(files),
                count=float(hashes.shape[0]),
                sketch=sketch,
            )
        )
    if count_fh is not None:
        count_fh.close()
    # order by descending cardinality (ties broken by filename so the
    # layout is invariant to taxonomy-input order), then chain by
    # similarity (chopper: sort + rearrange_user_bins)
    entries.sort(key=lambda b: (-b.count, b.filenames[0]))
    entries = rearrange_bins(entries)

    n = len(entries)
    candidates = sorted(
        {64 << k for k in range(20) if 64 << k <= tmax}
        | {next_multiple_of_64(math.ceil(math.sqrt(n)))}
    )
    candidates = [t for t in candidates if t <= max(tmax, 64)] or [64]

    cost_fn = (_expected_query_cost_device if cost_model == "device"
               else _expected_query_cost)
    # ONE union band for the whole sweep: it depends only on the entry
    # order, so every tmax candidate and every recursion level (row
    # slices) share it — at 24.5k bins this was most of the 63-minute
    # round-4 layout wall
    ubT = _union_band(entries, _merge_window(max(1, n)))
    best_node = None
    best_cost = np.inf
    best_t = None
    if cost_model == "device":
        # flat candidate: every user bin its own technical bin
        flat = LayoutNode()
        for b in entries:
            flat.records.append(
                LayoutRecord(b.filenames, len(flat.records), 1))
        flat.num_technical_bins = len(entries)
        flat.est_max_card = max((b.count for b in entries), default=1.0)
        flat.max_bin_index = int(np.argmax([b.count for b in entries])) \
            if entries else 0
        best_node = flat
        best_cost = cost_fn(flat)
        best_t = 0
        if verbose:
            print(f"## flat\texpected device query cost = "
                  f"{best_cost:.4f}", flush=True)
    for t in candidates:
        node = _build_node(entries, t, ubT)
        cost = cost_fn(node)
        if verbose:
            print(f"## t_max = {t}\texpected query cost = {cost:.4f}",
                  flush=True)
        if cost < best_cost:
            best_cost = cost
            best_node = node
            best_t = t
        else:
            break
    if verbose:
        print(f"## chosen t_max = {best_t}\t(expected query cost "
              f"{best_cost:.4f}, {n} user bins)", flush=True)
    return best_node


def compute_layout(clusters: dict[str, list[str]], scheme, tmax: int = 4096,
                   threads: int = 1) -> LayoutNode:
    """Full layout pipeline: hash all files once, sketch, DP."""
    from .build import precompute_file_hashes

    all_files = [f for files in clusters.values() for f in files]
    file_hashes = precompute_file_hashes(all_files, scheme)
    return compute_layout_from_hashes(file_hashes, clusters, tmax=tmax)
