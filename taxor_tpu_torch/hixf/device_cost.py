"""The layout DP's ``device`` cost model: the port's probe kernels on the
NVIDIA H100.

``--layout-cost device`` scores a candidate layout by the device
milliseconds a read of a search batch costs in the port's probe launches
(``device/probe.py``): the flat fused step's one probe, or one launch
for each stacked descent group (``device/hixf_search.DeviceHIXF``).  The
model rebuilds, on the host, what the search will run:

  - the groups: the IXFs of each depth in BFS order, packed at 4-bin
    boundaries into subgroups of at most 512 bins (each padded to 16),
    consecutive subgroups of one slot count stacked into one launch
    [G, S, Bpad] (``_build_probe_groups``, ``_stack_host_groups``);
  - the slots of each depth: the level's largest estimated bin
    cardinality through ``ixf_geometry`` (the build sizes every IXF of a
    depth for the level's largest bin);
  - the route each launch takes: K2n (``csrc/probe_narrow.cu``) for at
    most 512 bins, in smem mode where a whole table fits a block's shared
    memory (``narrow_mode``); K2 (``csrc/probe.cu``,
    ``csrc/probe_slab.cu``) for wider tables,
    on its slab route where a bin slab fits a block (``slab_bins``: 16
    bins or more, or a thin slab of 8 or 4 bins of every slot for reads
    of 8,192 hash slots or more, never at the model's batch of 2,048
    slots a read), else its rows route.  These are host copies of
    ``probe_narrow_mode`` and ``probe_slab_bins`` with the H100's opt-in
    shared memory a block as a constant, so that a build needs no card;
    ``chip_smoke.py`` phase 16a and the GPU tests hold them equal to the
    card's.

A launch then costs the larger of its host call (``CALL_MS`` for the
flat step's probe, ``GROUP_MS`` for a descent group, which adds the
descent's bookkeeping around the launch) and its device time: a cost per
probed hash for its route and width, per (subgroup, read) pair or
subgroup where the kernel pays one, and its output bytes over the
memory rate (``device_ms``).  A batch holds ``BATCH`` reads spread
uniformly over the user bins (the leaves): a read probes one subgroup on
each level of its user bin's path, so a stacked level's active pairs are
the batch's share of the leaves below its members.  A scaled scheme
(FracMinHash, ``scaling`` > 1) descends all pairs: every subgroup is
probed by every read, with ``HASHES_PER_READ / scaling`` hashes a read.
The result is milliseconds a read: the batch's launches over ``BATCH``.

The coefficients were fitted on the card by
``taxor_tpu_torch/tools/bench_gather_scale.py`` (``FIT_CARD``).
"""

from __future__ import annotations

import math

from ..ixf.xor_filter import ixf_geometry

# the card the coefficients below were fitted on (nvidia-smi's name and
# power limit)
FIT_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# cudaDevAttrMaxSharedMemoryPerBlockOptin of the H100 (227 KiB)
SMEM_OPTIN = 232_448
L2_BYTES = 50 * 2**20  # the H100's L2
HBM_BPS = 3.35e12  # the H100 SXM's device memory rate
BATCH = 512  # reads of a search batch (the L = 8,192 bucket)
# valid hashes a read of the L = 8,192 bucket: 259,494 over 512 reads in
# chip_smoke.py's flat cell (k = 22, s = 12 syncmers)
HASHES_PER_READ = 500
LANE = 16  # bins of a probe table pad to a multiple of 16
NARROW_MAX_BINS = 512  # K2n's domain; wider groups take K2
GROUP_B4 = 128  # 4-bin words of a descent subgroup

# K2n's block (csrc/probe_narrow.cu): 256 threads, 8 warps, kTile 1,024
_NARROW_THREADS, _NARROW_WARPS, _NARROW_TILE = 256, 8, 1024

# The H100's streaming multiprocessors and shared memory an SM (K2n's
# smem mode launches one wave of blocks: probe_narrow.cu plan_of)
SMS = 132
SMEM_PER_SM = 233_472

# K2's slab route (csrc/probe_slab.cu): no slot count from 196,608 (u16
# positions within a segment); a thin slab (fewer than 16 bins) of no
# fewer than 4 bins, for reads of no fewer than 8,192 hash slots (the
# card measured thin slabs slower than the rows route elsewhere).  The
# model's batch, the L = 8,192 bucket of a syncmer scheme, has
# hash_cap(8,192, 22, 12, 5) = 2,048 slots a read, so it never takes a
# thin slab: the model prices syncmer batches of k - s + 1 >= 8, and the
# plain k-mer and minimiser schemes' batches of 8,192 slots and narrow
# syncmer schemes' wider ones only as such (ROADMAP D.5).
SLAB_MAX_SLOTS = 196_608
THIN_MIN_BINS = 4
THIN_MIN_SLOTS = 8192
BATCH_SLOTS = 2048

# Fitted coefficients, ns, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (FIT_CARD; tools/bench_gather_scale.py --shapes all --fit, K2's thin
# slabs with --shapes thin --fit --fit-only k2_thin; the host
# floors from its default shapes over three runs).  A probed hash costs
# "a" + "b" x Bpad on a rows route, its L2 part and its HBM part weighed
# by the share of the table the L2 keeps (L2_EFF over the table's
# bytes); on K2's slab route "a" + slabs x ("c0" + "c1" x the slab's
# bins); on its thin slabs slabs x ("c0" + "c1" x W), a slab for every W
# bins, and each slab's block pays "read" an active read.  K2n's rows
# mode pays "pair" a (subgroup, read) block, its smem mode "block" a
# block of its wave; outputs and smem mode's table copies cost their
# bytes over WRITE_BPS.
CALL_MS = 0.040  # a probe launch's host call (0.028-0.059 measured)
GROUP_MS = 0.30  # a descent group's step as a call (0.19-0.36 measured)
L2_EFF = 25.26 * 2**20
WRITE_BPS = 1.518e12
COEF = {
    "k2_slab": {"a": 0.03839, "c0": 0.004712, "c1": 8.601e-05},
    "k2_thin": {"c0": 8.885e-04, "c1": 1.713e-04, "read": 0.9470},
    "k2_rows": {"l2": (0.1433, 0.0003891), "hbm": (0.1383, 0.0007495)},
    "k2n_rows": {"l2": (0.03254, 0.0005078), "hbm": (0.07005, 0.0008544),
                 "pair": 1.944},
    "k2n_smem": {"a": 0.06507, "b": 0.000176, "block": 41.51},
}


def pad_bins(n_bins: int) -> int:
    """Bins padded to the probe kernels' multiple of 16 (probe.pad_bins)."""
    return max(LANE, -(-n_bins // LANE) * LANE)


def slab_fit(S: int, Bpad: int) -> int:
    """Host copy of probe_slab_fit (csrc/probe_slab.cu): the widest of 128,
    64, 32, 16 bins (no wider than Bpad needs), 8, 4, 2 and 1 whose [S, b]
    slab fits one block's shared memory; 0 from SLAB_MAX_SLOTS slots or
    where none fits."""
    if not 0 < S < SLAB_MAX_SLOTS or Bpad <= 0 or Bpad % 16:
        return 0
    b = 128
    while b > 16 and b // 2 >= Bpad:
        b //= 2
    while b >= 1:
        if S * b <= SMEM_OPTIN:
            return b
        b //= 2
    return 0


def slab_bins(S: int, Bpad: int, H: int) -> int:
    """Host copy of probe_slab_bins for reads of H hash slots: slab_fit
    where it has 16 bins or more, or THIN_MIN_BINS or more and H is at
    least THIN_MIN_SLOTS; else 0 (the rows route)."""
    b = slab_fit(S, Bpad)
    return b if b >= 16 or (b >= THIN_MIN_BINS and H >= THIN_MIN_SLOTS) \
        else 0


def _align16(x: int) -> int:
    return (x + 15) & ~15


def narrow_block_bytes(smem_mode: bool, S: int, Bpad: int) -> int:
    """Host copy of block_bytes (csrc/probe_narrow.cu): K2n's dynamic
    shared memory a block."""
    ctrl = _align16(4 * (_NARROW_WARPS + _NARROW_THREADS))
    pref = _align16(4 * (Bpad + 1))
    if smem_mode:
        scratch = _NARROW_WARPS * (32 * 16 + pref)
        return _align16(S * Bpad) + ctrl + scratch
    return (ctrl + 16 * _NARROW_THREADS + 16 * _NARROW_TILE
            + _align16(4 * _NARROW_WARPS) + pref)


def narrow_mode(S: int, Bpad: int) -> str:
    """Host copy of probe_narrow_mode (csrc/probe_narrow.cu): "smem"
    where a whole [S, Bpad] table and the block's scratch fit one block's
    shared memory, else "rows"."""
    if S <= 0 or Bpad <= 0 or Bpad > NARROW_MAX_BINS or Bpad % 16:
        return "rows"
    return ("smem" if narrow_block_bytes(True, S, Bpad) <= SMEM_OPTIN
            else "rows")


def route(S: int, Bpad: int, H: int = BATCH_SLOTS) -> str:
    """The probe route of a launch over tables [G, S, Bpad] and reads of
    H hash slots (the model's batch: BATCH_SLOTS): "k2n_smem" or
    "k2n_rows" for at most 512 bins, else "k2_slab" (16 bins or more),
    "k2_thin" (a thin slab) or "k2_rows"."""
    if Bpad <= NARROW_MAX_BINS:
        return "k2n_" + narrow_mode(S, Bpad)
    b = slab_bins(S, Bpad, H)
    return "k2_rows" if not b else "k2_slab" if b >= 16 else "k2_thin"


def narrow_blocks(G: int, S: int, Bpad: int, R: int) -> int:
    """The blocks of a K2n smem-mode launch (probe_narrow.cu launch):
    each subgroup's reads in as many chunks as fill one wave of blocks,
    each chunk at least 8 reads."""
    occ = max(1, min(8, SMEM_PER_SM // (narrow_block_bytes(True, S, Bpad)
                                         + 1024)))
    chunks = min(max(1, -(-SMS * occ // G)), max(1, -(-R // 8)))
    return G * chunks


def _rows_hash_ns(c: dict, table_bytes: int, Bpad: int) -> float:
    hit = min(1.0, L2_EFF / max(1, table_bytes))
    return sum(w * (c[k][0] + c[k][1] * Bpad)
               for k, w in (("l2", hit), ("hbm", 1.0 - hit)))


def device_ms(rt: str, G: int, S: int, Bpad: int, R: int, pairs: float,
              hashes: float, out_elems: float, loaded: float | None = None
              ) -> float:
    """Modelled device milliseconds of one probe launch on route ``rt``
    over tables [G, S, Bpad] and R reads: ``pairs`` active (subgroup,
    read) pairs probing ``hashes`` valid hashes in all, ``out_elems``
    int32 outputs written; ``loaded``: the subgroups with an active read
    (smem mode copies their tables; default: min(G, pairs))."""
    c = COEF[rt]
    nbytes = 4.0 * out_elems
    if rt == "k2_slab":
        b = slab_fit(S, Bpad)
        ns = hashes * (c["a"] + -(-Bpad // b) * (c["c0"] + c["c1"] * b))
    elif rt == "k2_thin":
        W = slab_fit(S, Bpad)
        ns = Bpad // W * (hashes * (c["c0"] + c["c1"] * W)
                          + pairs * c["read"])
    elif rt == "k2n_smem":
        ns = (hashes * (c["a"] + c["b"] * Bpad)
              + narrow_blocks(G, S, Bpad, R) * c["block"])
        nbytes += (min(G, pairs) if loaded is None else loaded) * S * Bpad
    else:
        ns = hashes * _rows_hash_ns(c, G * S * Bpad, Bpad)
        if rt == "k2n_rows":
            ns += G * R * c["pair"]
    return ns * 1e-6 + nbytes / WRITE_BPS * 1e3


class _Level:
    """The IXFs of one depth in BFS order: each as (bins, leaf share of
    the batch, runs)."""

    def __init__(self):
        self.ixfs: list[tuple[int, float, int]] = []
        self.slots = 0


def _levels(root, bins_of, slots_of, children_of, leaves_of,
            runs_of) -> list[_Level]:
    """BFS over a tree given by accessors; each IXF's leaf share is the
    leaves below it (its own included) over all leaves."""
    below: dict[int, int] = {}

    def key(n) -> int:  # an IXF id, or a LayoutNode (unhashable)
        return n if isinstance(n, int) else id(n)

    def count(n) -> int:
        k = leaves_of(n) + sum(count(c) for c in children_of(n))
        below[key(n)] = k
        return k

    total = max(1, count(root))
    levels: list[_Level] = []
    frontier = [root]
    while frontier:
        lv = _Level()
        for n in frontier:
            lv.ixfs.append((bins_of(n), below[key(n)] / total, runs_of(n)))
            lv.slots = max(lv.slots, slots_of(n))
        levels.append(lv)
        frontier = [c for n in frontier for c in children_of(n)]
    return levels


def _stack(level: _Level) -> list[tuple[int, int, float]]:
    """The subgroups of one level: (Bpad, runs, active share), packed as
    _build_probe_groups packs them (members at 4-bin boundaries, at most
    GROUP_B4 words, a wider IXF alone)."""
    subs, width, share, runs = [], 0, 0.0, 0
    for bins, sh, nr in level.ixfs:
        b4 = -(-bins // 4)
        if width and width + b4 > GROUP_B4:
            subs.append((pad_bins(4 * width), runs, share))
            width, share, runs = 0, 0.0, 0
        width += b4
        share += sh
        runs += nr
    subs.append((pad_bins(4 * width), runs, share))
    return subs


def batch_launches(levels: list[_Level], scaling: int = 1) -> list[dict]:
    """One record a launch of a search batch of BATCH reads: its route,
    shape, active pairs, hashes and modelled ms (a call)."""
    R = BATCH
    h = HASHES_PER_READ / max(1, scaling)
    flat = len(levels) == 1 and len(levels[0].ixfs) == 1
    out = []
    for lv in levels:
        subs = _stack(lv)
        G = len(subs)
        Bpad = max(b for b, _, _ in subs)
        S = lv.slots
        rt = route(S, Bpad)
        if scaling > 1:  # descend-all: every pair
            pairs = float(G * R)
        else:
            pairs = R * sum(min(1.0, sh) for _, _, sh in subs)
        n_runs = sum(nr for _, nr, _ in subs)
        # the flat step and K2 write dense counts; K2n's descent run sums
        out_elems = (G * R * Bpad if flat or rt.startswith("k2_")
                     else n_runs * R)
        loaded = float(G) if scaling > 1 else sum(
            1.0 - (1.0 - min(1.0, sh)) ** R for _, _, sh in subs)
        ms = max(CALL_MS if flat else GROUP_MS,
                 device_ms(rt, G, S, Bpad, R, pairs, pairs * h, out_elems,
                           loaded))
        out.append(dict(route=rt, shape=[G, S, Bpad], pairs=pairs,
                        hashes=pairs * h, ms=ms))
    return out


def _ms_per_read(levels: list[_Level], scaling: int) -> float:
    return sum(x["ms"] for x in batch_launches(levels, scaling)) / BATCH


def layout_levels(node) -> list[_Level]:
    """The levels of a LayoutNode (hixf/layout.py) with the slots its
    estimated bin cardinalities give (est_max_card, ixf_geometry)."""
    def slots(n) -> int:
        card = max(1.0, float(getattr(n, "est_max_card", 1.0)))
        return ixf_geometry(int(math.ceil(card)))[1]

    def runs(n) -> int:
        return len(n.records) + len(n.children)

    return _levels(node, lambda n: n.num_technical_bins, slots,
                   lambda n: [n.children[b] for b in sorted(n.children)],
                   lambda n: len(n.records), runs)


def layout_ms_per_read(node, scaling: int = 1) -> float:
    """Modelled device ms a read of the probe launches of a search batch
    on the index that layout ``node`` gives (the module docstring)."""
    return _ms_per_read(layout_levels(node), scaling)


def hixf_levels(hixf) -> list[_Level]:
    """The levels of a built HIXF (hixf/container.py) with its IXFs' own
    slots and bins."""
    runs = [hixf.runs_of_ixf(i) for i in range(len(hixf.ixfs))]

    def children(i: int) -> list[int]:
        s, _, u = runs[i]
        return [int(hixf.next_ixf_id[i][int(b)]) for b, x in zip(s, u)
                if x < 0]

    return _levels(0, lambda i: hixf.ixfs[i].bin_count,
                   lambda i: hixf.ixfs[i].fingerprints.shape[0], children,
                   lambda i: int((runs[i][2] >= 0).sum()),
                   lambda i: int(runs[i][0].shape[0]))


def hixf_ms_per_read(hixf, scaling: int = 1) -> float:
    """The model of layout_ms_per_read on a built index."""
    return _ms_per_read(hixf_levels(hixf), scaling)


def routing_grid() -> list[tuple[int, int]]:
    """The (S, Bpad) points on which chip_smoke.py phase 16a and the GPU
    tests hold the host copies of the routing rules to the card's: Bpad
    16 to 4,096 in steps of 16; S from 1 to 200,000 on a geometric grid,
    with each slab width's limit, each narrow width's smem limit (411/412
    at 512 bins) and their neighbours, 65,535/65,536 and
    196,607/196,608."""
    top = 200_000
    slots = {1, 2, 3, 65535, 65536, SLAB_MAX_SLOTS - 1, SLAB_MAX_SLOTS, top}
    x = 1.0
    while x < top:
        slots.add(int(x))
        x *= 1.05
    lims = [SMEM_OPTIN // b for b in (1, 2, 4, 8, 16, 32, 64, 128)]
    lims += [(SMEM_OPTIN - narrow_block_bytes(True, 0, b)) // b
             for b in range(16, NARROW_MAX_BINS + 1, 16)]
    slots |= {s + d for s in lims for d in (-1, 0, 1)}
    return [(s, b) for s in sorted(slots) if 1 <= s <= top
            for b in range(16, 4097, 16)]
