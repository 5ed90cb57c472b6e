"""IXF probe/count: CUDA kernels K2 and K2n and their plain twins.

Counterpart of ``taxor_tpu/device/probe.py`` (the XLA gather
``count_xla`` and ``pad_fingerprints``) and of the Pallas probe family
of ``taxor_tpu/device/pallas_probe.py``.  All of them compute

    counts[r, b] = sum over valid hashes h of read r of
                   [T[p0, b] ^ T[p1, b] ^ T[p2, b] == fprint(h)]

for the uint8 fingerprint table T [S, Bpad] (bins contiguous per slot).
The wrappers take the wyhashed keys as (hi, lo) int32 bit patterns with a
validity mask, as K1 returns them, and the IXF's seed and block length;
the probe slots and fingerprints come from ``mix_split`` as in
``ixf/xor_filter.compute_probes``.

``probe_counts_grouped`` probes a stack of G tables of one geometry with
a per-(g, r) activity mask into dense int32 [G, R, Bpad] counts (an
inactive read gets zeros); ``probe_counts`` is its G = 1, all-active
case, which the flat fused step takes.  ``probe_run_sums_grouped`` is
what the hierarchical descent takes (device/e2e.descend,
device/hixf_search.DeviceHIXF.counts): the same probe of a descent
group's subgroups, summed into each subgroup's runs of bins, int32
[n_runs, R].  On a group of at most ``NARROW_MAX_BINS`` bins (every
stacked group, and every IXF of a layout built with tmax <= 512) K2n
sums the runs in the kernel, with no dense counts in between; a wider
group (an IXF of more than 512 bins, which ``_stack_host_groups`` gives
a group of its own) takes K2's dense counts and their segment sums.  It
replaces the TPU's ``lax.scan`` over stacked subgroups, its zero trip
counts (``pallas_probe._body_counts``) and its one-hot run matmul.

On a CUDA tensor a table of at most ``NARROW_MAX_BINS`` bins goes to K2n
(``csrc/probe_narrow.cu``, the port of ``pallas_probe._kernel_repl``),
whose dense counts are its case of one-bin runs, and a wider one to K2,
the port of the other five probe kernels (``_probe_call_chunked``'s
kernels); on a CPU tensor both take the gather twins.  The shape picks each kernel's variant: K2's slab route
(``csrc/probe_slab.cu``) holds the table in shared memory one bin slab
at a time, as the TPU kernels held a bin tile in VMEM, where a slab fits
one block (``slab_bins``: 16 bins or more, or for reads of at least
8,192 hash slots a thin slab of 8 or 4 bins of every slot, up to 58,112
slots), else its rows route (``csrc/probe.cu``) reads the rows from L2
or HBM; K2n's smem mode holds a whole subgroup table in a
block's shared memory where it fits (``narrow_mode``), else its rows
mode reads the rows from L2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.u64 import join32, probe_positions_and_fprint4
from . import cuda_build

# bins pad to a multiple of 16: 16-byte aligned rows, 4-byte words per
# kernel thread (the TPU's 512-bin lane tiles are not reproduced)
LANE = 16
# K2n's domain: B4 <= 128 words, the bound of pallas_probe._repl_eligible
NARROW_MAX_BINS = 512
# K2's slab route: u16 positions within a segment of S / 3 slots
SLAB_MAX_SLOTS = 196_608
# k2_counts' variants (None: the shape's pick)
K2_VARIANTS = (None, "slab", "split", "rows")


def pad_bins(n_bins: int, lane: int = LANE) -> int:
    return max(lane, -(-n_bins // lane) * lane)


def pad_fingerprints(fp: np.ndarray, lane: int = LANE) -> np.ndarray:
    """Pad the bins axis to a lane multiple (padded columns stay 0 and are
    sliced off the counts)."""
    slots, bins = fp.shape
    padded = pad_bins(bins, lane)
    if padded == bins:
        return np.ascontiguousarray(fp)
    out = np.zeros((slots, padded), dtype=fp.dtype)
    out[:, :bins] = fp
    return out


def count_plain(table: torch.Tensor, positions: torch.Tensor,
                fprints: torch.Tensor, mask: torch.Tensor,
                budget: int = 1 << 26) -> torch.Tensor:
    """int32 [R, Bpad] counts — the gather formulation of count_xla.

    table uint8 [S, Bpad], positions int [R, H, 3], fprints uint8 [R, H],
    mask bool [R, H].  Hashes go in chunks so the gathered
    [R, chunk, 3, Bpad] tile stays under ``budget`` bytes."""
    R, H, _ = positions.shape
    Bp = table.shape[1]
    acc = torch.zeros((R, Bp), dtype=torch.int32, device=table.device)
    chunk = max(1, min(H, budget // max(1, R * 3 * Bp)))
    pos = positions.to(torch.int64)
    for a in range(0, H, chunk):
        rows = table[pos[:, a:a + chunk]]  # [R, C, 3, Bp]
        x = rows[:, :, 0] ^ rows[:, :, 1] ^ rows[:, :, 2] \
            ^ fprints[:, a:a + chunk, None]
        hit = (x == 0) & mask[:, a:a + chunk, None]
        acc += hit.sum(dim=1, dtype=torch.int32)
    return acc


def probe_counts_grouped_plain(hi, lo, valid, tables, active, seed: int,
                               block_length: int) -> torch.Tensor:
    """Plain PyTorch twin of K2 and K2n (same contract as
    probe_counts_grouped): per table, count_plain over the active reads
    only."""
    G, _, Bp = tables.shape
    R = hi.shape[0]
    pos, f4 = probe_positions_and_fprint4(join32(hi, lo), seed, block_length)
    fpr = (f4 & 0xFF).to(torch.uint8)
    out = torch.zeros((G, R, Bp), dtype=torch.int32, device=tables.device)
    for g in range(G):
        rows = (torch.arange(R, device=hi.device) if active is None
                else torch.nonzero(active[g]).flatten())
        if rows.numel():
            out[g, rows] = count_plain(tables[g], pos[rows], fpr[rows],
                                       valid[rows])
    return out


def probe_counts_plain(hi, lo, valid, table, seed: int, block_length: int):
    """Plain PyTorch twin of probe_counts."""
    return probe_counts_grouped_plain(hi, lo, valid, table[None], None,
                                      seed, block_length)[0]


def segment_sums(counts: torch.Tensor, run_g: torch.Tensor,
                 run_s: torch.Tensor, run_e: torch.Tensor) -> torch.Tensor:
    """int32 [n_runs, R]: run j sums columns [run_s[j], run_e[j]) of table
    run_g[j] of counts [G, R, Bpad] — exact int64 segment sums of the
    cumulative sum along the bins.  An empty run (run_e <= run_s, as a
    run clipped to a bins shard it misses) sums to 0."""
    cs = torch.cumsum(counts, dim=2, dtype=torch.int64)

    def before(col):  # sum of the columns < col
        return torch.where((col > 0)[:, None],
                           cs[run_g, :, (col - 1).clamp(min=0)], 0)

    return (before(torch.maximum(run_e, run_s)) - before(run_s)).to(
        torch.int32)


def run_groups(run_off: torch.Tensor) -> torch.Tensor:
    """int64 [n_runs]: the subgroup of each run of the CSR run_off."""
    G = run_off.shape[0] - 1
    return torch.repeat_interleave(torch.arange(G, device=run_off.device),
                                   run_off[1:] - run_off[:-1])


def probe_run_sums_grouped_plain(hi, lo, valid, tables, active, run_off,
                                 run_s, run_e, seed: int,
                                 block_length: int) -> torch.Tensor:
    """Plain PyTorch twin of probe_run_sums_grouped: the dense counts of
    probe_counts_grouped_plain, then their segment sums."""
    counts = probe_counts_grouped_plain(hi, lo, valid, tables, active, seed,
                                        block_length)
    return segment_sums(counts, run_groups(run_off), run_s, run_e)


def _check(name: str, hi, lo, valid, tables, active,
           block_length: int) -> tuple[int, int, int, int, int]:
    """Check the inputs of probe kernel ``name``; (G, S, Bpad, R, H)."""
    if tables.dtype != torch.uint8 or tables.dim() != 3:
        raise ValueError(f"{name}: tables must be uint8 [G, S, Bpad]")
    G, S, Bp = tables.shape
    if hi.dim() != 2:
        raise ValueError(f"{name}: hashes must be [R, H]")
    R, H = hi.shape
    for arg, x, dt, shape in (("hi", hi, torch.int32, (R, H)),
                              ("lo", lo, torch.int32, (R, H)),
                              ("valid", valid, torch.bool, (R, H)),
                              ("active", active, torch.bool, (G, R))):
        if x is not None and (x.dtype != dt or x.shape != shape
                              or x.device != tables.device):
            raise ValueError(f"{name}: {arg} must be {dt} {list(shape)} on "
                             "the tables' device")
    if not all(x.is_contiguous() for x in (hi, lo, valid, tables, active)
               if x is not None):
        raise ValueError(f"{name}: inputs must be contiguous")
    if Bp % 4 or tables.data_ptr() % 4:
        raise ValueError(f"{name}: Bpad must be a multiple of 4 on 4-byte "
                         "aligned rows")
    if not (0 < block_length and 3 * block_length <= S < 2**31):
        raise ValueError(f"{name}: block_length {block_length} does not "
                         f"fit {S} slots")
    return G, S, Bp, R, H


def _launch(hi, lo, valid, tables, active, seed: int, block_length: int,
            slab: int) -> torch.Tensor:
    """Launch K2 (launch_probe_count) after the checks; int32 [G, R,
    Bpad].  ``slab``: the slab width (0: the rows route); the scratch of
    the slab route's records is allocated here."""
    name = "launch_probe_count"
    G, S, Bp, R, H = _check(name, hi, lo, valid, tables, active,
                            block_length)
    out = torch.empty((G, R, Bp), dtype=torch.int32, device=tables.device)
    rec = nrec = None
    if slab:
        if Bp % 16 or tables.data_ptr() % 16 or S >= SLAB_MAX_SLOTS:
            raise ValueError(f"{name}: the slab route takes a Bpad that is "
                             "a multiple of 16 on 16-byte aligned rows and "
                             f"fewer than {SLAB_MAX_SLOTS} slots")
        # one 8-byte record a slot: 32 MB at the fused step's R x H =
        # POS_BUDGET (H = L for minimisers and plain k-mers)
        rec = torch.empty((R, H), dtype=torch.int64, device=out.device)
        nrec = torch.empty(R, dtype=torch.int32, device=out.device)
    err = cuda_build.lib().launch_probe_count(
        hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), R, H,
        tables.data_ptr(), G, S, Bp,
        None if active is None else active.data_ptr(),
        int(seed) & (2**64 - 1), int(block_length), slab,
        *(None if x is None else x.data_ptr() for x in (rec, nrec)),
        out.data_ptr(), cuda_build.stream_of(tables))
    cuda_build.check(err, name)
    return out


def _launch_split(hi, lo, valid, tables, active, seed: int,
                  block_length: int, C: int) -> torch.Tensor:
    """Launch K2's split variant (launch_probe_split, csrc/probe_cluster.cu)
    in clusters of C blocks after the checks; int32 [G, R, Bpad].  The
    scratch of its records is allocated here."""
    name = "launch_probe_split"
    G, S, Bp, R, H = _check(name, hi, lo, valid, tables, active,
                            block_length)
    if Bp % 16 or tables.data_ptr() % 16 or S >= SLAB_MAX_SLOTS:
        raise ValueError(f"{name}: the split variant takes a Bpad that is "
                         "a multiple of 16 on 16-byte aligned rows and fewer "
                         f"than {SLAB_MAX_SLOTS} slots")
    out = torch.empty((G, R, Bp), dtype=torch.int32, device=tables.device)
    rec = torch.empty((R, H), dtype=torch.int64, device=out.device)
    nrec = torch.empty(R, dtype=torch.int32, device=out.device)
    err = cuda_build.lib().launch_probe_split(
        hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), R, H,
        tables.data_ptr(), G, S, Bp,
        None if active is None else active.data_ptr(),
        int(seed) & (2**64 - 1), int(block_length), C, rec.data_ptr(),
        nrec.data_ptr(), out.data_ptr(), cuda_build.stream_of(tables))
    cuda_build.check(err, name)
    return out


def _index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def slab_bins(S: int, Bpad: int, H: int, device: torch.device,
              fit: bool = False) -> int:
    """Slab width in bins of K2's slab route for tables [S, Bpad] and
    reads of H hash slots on CUDA ``device`` (probe_slab_bins of
    csrc/probe_slab.cu): the widest of 128, 64, 32, 16, 8, 4, 2 and 1
    bins whose [S, b] slab fits one block's shared memory, where it has
    16 bins or more, or 8 or 4 and H is at least 8,192 (a thin slab of
    every slot, which the card measured faster than the rows route only
    for reads of many hashes); 0 where none, the rows route.  ``fit``:
    the widest that fits, whatever H (probe_slab_fit).  A function of the
    shape and of the card's shared memory a block, never of a launch's
    outcome."""
    return _slab_bins(S, Bpad, -1 if fit else H, _index(device))


@functools.lru_cache(maxsize=4096)
def _slab_bins(S: int, Bpad: int, H: int, index: int) -> int:
    lib = cuda_build.lib()
    b = (lib.probe_slab_fit(S, Bpad, index) if H < 0
         else lib.probe_slab_bins(S, Bpad, H, index))
    if b < 0:
        raise RuntimeError("probe_slab_bins: CUDA error")
    return b


def split_cluster(S: int, Bpad: int, block_length: int,
                  device: torch.device) -> int:
    """The cluster of K2's split variant (never the shape's pick): 3m
    blocks, each [ceil(block_length / m), 16] rows of one segment; 0
    where no m up to 5 fits (probe_cluster_split)."""
    C = cuda_build.lib().probe_cluster_split(S, Bpad, int(block_length),
                                             _index(device))
    if C < 0:
        raise RuntimeError("probe_cluster_split: CUDA error")
    return C


def k2_counts(hi, lo, valid, tables, active, seed: int, block_length: int,
              route: str | None = None,
              variant: str | None = None) -> torch.Tensor:
    """K2 on CUDA tensors: int32 [G, R, Bpad] counts of a stack of tables
    uint8 [G, S, Bpad] of any width; active bool [G, R] or None (every
    read active).  The shape picks the variant: "slab" (csrc/probe_slab.cu,
    the table in shared memory one bin slab at a time) where slab_bins
    finds a slab for the tables and the reads' H hash slots, else "rows"
    (csrc/probe.cu, rows from L2 or HBM).  ``variant`` forces one:
    "slab" takes the widest slab that fits whatever H (slab_bins' fit),
    "split" (csrc/probe_cluster.cu: a 16-bin slab held across a
    thread-block cluster, timed beside the slab route, never the shape's
    pick) its cluster; both raise where none fits.  route: the caller's
    route, counted in k2_counts.ROUTES; the variant in k2_counts.VARIANTS,
    both beside k2_counts.LAUNCHES.  No variant falls back to another: a
    failed launch raises."""
    if variant not in K2_VARIANTS:
        raise ValueError(f"k2_counts: unknown variant {variant!r}")
    b = C = 0
    if tables.dim() == 3:
        S, Bp = tables.shape[1:]
        if variant in (None, "slab"):
            b = slab_bins(S, Bp, hi.shape[-1], tables.device,
                          fit=variant == "slab")
        elif variant == "split":
            C = split_cluster(S, Bp, block_length, tables.device)
        if (variant == "slab" and not b) or (variant == "split" and not C):
            raise ValueError(f"k2_counts: tables {list(tables.shape)} do not "
                             f"fit the {variant} route")
    if C:
        out = _launch_split(hi, lo, valid, tables, active, seed,
                            block_length, C)
    else:
        variant = "slab" if b else "rows"
        out = _launch(hi, lo, valid, tables, active, seed, block_length, b)
    if out.numel():
        cuda_build.count_launch(k2_counts, route, k2_counts.VARIANTS,
                                variant)
    return out


def narrow_mode(S: int, Bpad: int, device: torch.device) -> str:
    """K2n's mode for tables [S, Bpad] on CUDA ``device``
    (probe_narrow_mode of csrc/probe_narrow.cu): "smem" where a whole
    table and the block's scratch fit one block's shared memory, else
    "rows".  A function of the shape and of the card's shared memory a
    block, never of a launch's outcome."""
    idx = torch.device(device).index
    return _narrow_mode(S, Bpad,
                        torch.cuda.current_device() if idx is None else idx)


@functools.lru_cache(maxsize=None)
def _narrow_mode(S: int, Bpad: int, index: int) -> str:
    m = cuda_build.lib().probe_narrow_mode(S, Bpad, index)
    if m < 0:
        raise RuntimeError("probe_narrow_mode: CUDA error")
    return "smem" if m else "rows"


def _launch_narrow(hi, lo, valid, tables, active, runs, seed: int,
                   block_length: int, route: str | None,
                   mode: str | None) -> torch.Tensor:
    """Launch K2n after the checks: int32 [n_runs, R] run sums for runs
    = (run_off, run_s, run_e), int32 [G, R, Bpad] counts for runs None.
    The shape picks the mode (narrow_mode) unless ``mode`` forces one
    ("smem" raises where a table does not fit); the launch is counted in
    k2n_counts.LAUNCHES, .ROUTES and .MODES."""
    name = "launch_probe_narrow"
    G, S, Bp, R, H = _check(name, hi, lo, valid, tables, active,
                            block_length)
    if Bp > NARROW_MAX_BINS or Bp % 16 or tables.data_ptr() % 16:
        raise ValueError(f"{name}: Bpad {Bp} exceeds {NARROW_MAX_BINS} "
                         "bins or is no multiple of 16 on 16-byte aligned "
                         "tables")
    if mode not in (None, "smem", "rows"):
        raise ValueError(f"{name}: unknown mode {mode!r}")
    fits = narrow_mode(S, Bp, tables.device)
    if mode == "smem" and fits != "smem":
        raise ValueError(f"{name}: tables {list(tables.shape)} do not fit "
                         "shared memory")
    mode = mode or fits
    if runs is None:
        out = torch.empty((G, R, Bp), dtype=torch.int32,
                          device=tables.device)
        ptrs, n_runs = (None, None, None), 0
    else:
        run_off, run_s, run_e = runs
        n_runs = run_s.shape[0]
        for arg, x, n in (("run_off", run_off, G + 1), ("run_s", run_s, n_runs),
                          ("run_e", run_e, n_runs)):
            if (x.dtype != torch.int64 or x.shape != (n,)
                    or x.device != tables.device or not x.is_contiguous()):
                raise ValueError(f"{name}: {arg} must be int64 [{n}] on the "
                                 "tables' device")
        out = torch.empty((n_runs, R), dtype=torch.int32,
                          device=tables.device)
        ptrs = tuple(x.data_ptr() for x in runs)
    err = cuda_build.lib().launch_probe_narrow(
        hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), R, H,
        tables.data_ptr(), G, S, Bp,
        None if active is None else active.data_ptr(),
        int(seed) & (2**64 - 1), int(block_length), *ptrs, n_runs,
        1 if mode == "smem" else 0, out.data_ptr(),
        cuda_build.stream_of(tables))
    cuda_build.check(err, name)
    if out.numel():
        cuda_build.count_launch(k2n_counts, route, k2n_counts.MODES, mode)
    return out


def k2n_counts(hi, lo, valid, tables, active, seed: int, block_length: int,
               route: str | None = None,
               mode: str | None = None) -> torch.Tensor:
    """K2n (csrc/probe_narrow.cu): the contract of k2_counts for tables
    of at most NARROW_MAX_BINS bins, its case of one-bin runs.  mode:
    "smem" or "rows" forces one (see _launch_narrow)."""
    return _launch_narrow(hi, lo, valid, tables, active, None, seed,
                          block_length, route, mode)


def k2n_run_sums(hi, lo, valid, tables, active, run_off, run_s, run_e,
                 seed: int, block_length: int, route: str | None = None,
                 mode: str | None = None) -> torch.Tensor:
    """K2n on CUDA tensors: int32 [n_runs, R] run sums (the contract of
    probe_run_sums_grouped) of tables of at most NARROW_MAX_BINS bins."""
    return _launch_narrow(hi, lo, valid, tables, active,
                          (run_off, run_s, run_e), seed, block_length, route,
                          mode)


k2_counts.LAUNCHES = k2n_counts.LAUNCHES = 0
k2_counts.ROUTES, k2n_counts.ROUTES = {}, {}
k2_counts.VARIANTS = {}
k2n_counts.MODES = {}


def probe_counts_grouped(hi: torch.Tensor, lo: torch.Tensor,
                         valid: torch.Tensor, tables: torch.Tensor,
                         active: torch.Tensor | None, seed: int,
                         block_length: int,
                         route: str | None = None) -> torch.Tensor:
    """int32 [G, R, Bpad] per-bin counts of reads [R, H] against tables
    uint8 [G, S, Bpad] (zero where active[g, r] is False): K2n or K2 on a
    CUDA tensor, the plain twin on a CPU tensor."""
    if tables.device.type == "cpu":
        return probe_counts_grouped_plain(hi, lo, valid, tables, active,
                                          seed, block_length)
    if tables.device.type != "cuda":
        raise ValueError(f"probe_counts: unsupported device {tables.device}")
    narrow = tables.dim() == 3 and tables.shape[2] <= NARROW_MAX_BINS
    return (k2n_counts if narrow else k2_counts)(
        hi, lo, valid, tables, active, seed, block_length, route)


def probe_counts(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
                 table: torch.Tensor, seed: int, block_length: int,
                 route: str | None = None) -> torch.Tensor:
    """int32 [R, Bpad] per-bin counts against one table uint8 [S, Bpad],
    every read active."""
    if table.dim() != 2:
        raise ValueError("probe_counts: table must be uint8 [S, Bpad]")
    return probe_counts_grouped(hi, lo, valid, table[None], None, seed,
                                block_length, route)[0]


def probe_run_sums_grouped(hi: torch.Tensor, lo: torch.Tensor,
                           valid: torch.Tensor, tables: torch.Tensor,
                           active: torch.Tensor | None,
                           run_off: torch.Tensor, run_s: torch.Tensor,
                           run_e: torch.Tensor, seed: int, block_length: int,
                           route: str | None = None) -> torch.Tensor:
    """int32 [n_runs, R] run sums of reads [R, H] against the subgroup
    tables uint8 [G, S, Bpad]: run j of subgroup g (run_off[g] <= j <
    run_off[g + 1], int64 CSR [G + 1]) sums g's per-bin counts over
    columns [run_s[j], run_e[j]), 0 where active[g, r] is False; exactly
    segment_sums(probe_counts_grouped(...), run_groups(run_off), run_s,
    run_e).  On a CUDA tensor K2n's run sums for tables of at most
    NARROW_MAX_BINS bins, K2's dense counts and their segment sums for a
    wider group; the plain twin on a CPU tensor."""
    if tables.device.type == "cpu":
        return probe_run_sums_grouped_plain(hi, lo, valid, tables, active,
                                            run_off, run_s, run_e, seed,
                                            block_length)
    if tables.device.type != "cuda":
        raise ValueError(f"probe_run_sums: unsupported device "
                         f"{tables.device}")
    if tables.dim() == 3 and tables.shape[2] > NARROW_MAX_BINS:
        counts = k2_counts(hi, lo, valid, tables, active, seed, block_length,
                           route)
        return segment_sums(counts, run_groups(run_off), run_s, run_e)
    return k2n_run_sums(hi, lo, valid, tables, active, run_off, run_s, run_e,
                        seed, block_length, route)


def pack_hash_lists(hash_lists, Hpad: int):
    """(hi int32 [R, Hpad], lo int32 [R, Hpad], valid bool [R, Hpad]) numpy
    arrays from ragged per-read uint64 hash arrays (the host-hash route
    for reads over L_CAP)."""
    R = len(hash_lists)
    hi = np.zeros((R, Hpad), dtype=np.uint32)
    lo = np.zeros((R, Hpad), dtype=np.uint32)
    valid = np.zeros((R, Hpad), dtype=bool)
    for r, h in enumerate(hash_lists):
        n = h.shape[0]
        lo_hi = np.ascontiguousarray(h, dtype=np.uint64).view(
            np.uint32).reshape(n, 2)  # little-endian: [lo, hi]
        hi[r, :n] = lo_hi[:, 1]
        lo[r, :n] = lo_hi[:, 0]
        valid[r, :n] = True
    return hi.view(np.int32), lo.view(np.int32), valid
