"""The tools' diagnostic CUDA kernels (``csrc/diag/``) and their twins.

Counterparts of the four Pallas kernels of the JAX package's tooling:

  probe_bounds       bench_probe_bounds.call / make_kernel: probe variants
                     that leave out part of the per-hash work on purpose
  probe_experiment   bench_probe_r4.call / make_kernel / make_smemflood:
                     position layouts, interleaved reads, extra ALU work,
                     a loop of position-word loads
  extract_stage      tools/debug_extract.run / _stage_kernel: one stage of
                     the syncmer extractor per launch; emit and pre run
                     the reference tracker's step rule on one thread a
                     read, the sequential rule K1 is bisected against
  window_shift       tools/debug_min.kern: the funnel-shifted stream words
                     of the TPU extractor's 16 phases

Each wrapper launches its kernel on a CUDA tensor (from the diagnostic
library, ``cuda_build.diag_lib``; a failed build raises) and takes its
plain PyTorch twin (``*_plain``) only for a CPU tensor; its ``LAUNCHES``
counts the launches.  The two probe diagnostics have two routes each,
which the shape picks (``slab_bins``) and ``ROUTES`` counts: the slab
route holds the table in shared memory one bin slab at a time, as the
TPU tools held their table tile in VMEM and K2's slab route does; the
rows route, where no slab fits, reads table rows from L2.  Integer
arithmetic throughout, so a kernel and its twin agree bit for bit.  The
diagnostic library is apart from the search kernels'
(``cuda_build.lib``): no search path calls this module.
"""

from __future__ import annotations

import ctypes

import torch

from ..hash.device_syncmer import _rolling, _shift_right, syncmer_kmers, \
    unpack_codes
from ..utils.u64 import umin
from . import cuda_build
from .extract import _check_reads

M32 = 0xFFFFFFFF
SLAB_WIDTHS = (128, 64, 32, 16)  # bins a slab of the slab route
PROBE_BOUNDS_MODES = ("p16", "load1", "nosmem", "lcg", "smem1")
LAYOUTS = ("p16", "p10")
STAGES = ("sf", "sr", "ys", "kf", "kr", "chi", "clo", "erm", "emit", "pre")
STAGE_RING = 4096  # s-mers in extract_stage's ring (emit, pre): kRing
# the chains of probe_experiment's ALU rounds (the TPU tool's constants)
C1, C2 = 0x9E3779B9, 0x85EBCA6B


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def _count_rows(table: torch.Tensor, p0, p1, p2, f4, mask, one_row=False,
                chains: tuple | None = None, budget: int = 1 << 26):
    """int32 [R, B] zero bytes of T[p0] ^ T[p1] ^ T[p2] ^ f4 (T[p0] ^ f4
    with one_row) over the hashes where mask holds; positions int64
    [R, n], f4 int64 [R, n] 32-bit values.  chains = (rounds, d1, d2):
    d1 and d2 int64 [R, B/4] advance per hash and table word, in hash
    order, as the kernel's ALU rounds do."""
    R, n = p0.shape
    B = table.shape[1]
    acc = torch.zeros((R, B), dtype=torch.int32, device=table.device)
    fb = torch.stack([(f4 >> (8 * j)) & 0xFF for j in range(4)],
                     dim=-1).to(torch.uint8)  # [R, n, 4]: byte j of bin 4w+j
    chunk = max(1, min(n, budget // max(1, R * 3 * B)))
    for a in range(0, n, chunk):
        sl = slice(a, a + chunk)
        x = table[p0[:, sl]]  # [R, C, B]
        if not one_row:
            x = x ^ table[p1[:, sl]] ^ table[p2[:, sl]]
        x = x ^ fb[:, sl].repeat(1, 1, B // 4)
        acc += ((x == 0) & mask[:, sl, None]).sum(dim=1, dtype=torch.int32)
        if chains is not None:
            rounds, d1, d2 = chains
            xw = _u32(x.contiguous().view(torch.int32))  # [R, C, B/4]
            for c in range(xw.shape[1]):
                xc, m = xw[:, c], mask[:, a + c, None]
                for _ in range(rounds):
                    d1 = torch.where(m, ((d1 ^ xc) + C1) & M32, d1)
                    d2 = torch.where(m, ((d2 + xc) & M32) ^ C2, d2)
            chains = (rounds, d1, d2)
    return acc, chains


def _p16_fields(words: torch.Tensor, n: int):
    """(p0, p1, p2, f4) int64 [R, n] of the p16 layout: word 2h = p0 |
    p1 << 16, word 2h+1 = p2 | f << 16, f4 = f * 0x01010101 (32-bit)."""
    w = _u32(words)
    w0, w1 = w[:, 0:2 * n:2], w[:, 1:2 * n:2]
    return (w0 & 0xFFFF, w0 >> 16, w1 & 0xFFFF,
            ((w1 >> 16) * 0x01010101) & M32)


def _hash_mask(n_hash: torch.Tensor, n: int) -> torch.Tensor:
    h = torch.arange(n, device=n_hash.device)
    return h[None, :] < n_hash.to(torch.int64)[:, None]


def probe_bounds_plain(table: torch.Tensor, words: torch.Tensor,
                       n_hash: torch.Tensor, mode: str, U: int = 8,
                       RT: int = 16) -> torch.Tensor:
    """Plain twin of probe_bounds (same contract)."""
    R, W = words.shape
    if mode in ("p16", "load1", "smem1"):  # the hashes the words hold
        n_hash = n_hash.clamp(max=W // 2)
    n = int(n_hash.max()) if R else 0
    dev = table.device
    mask = _hash_mask(n_hash, n)
    h = torch.arange(n, device=dev, dtype=torch.int64)[None, :].expand(R, n)
    ones = torch.full((R, n), 0x01010101, dtype=torch.int64, device=dev)
    if mode in ("p16", "load1"):
        p0, p1, p2, f4 = _p16_fields(words, n)
    elif mode == "nosmem":
        u = h % U
        p0, p1, p2, f4 = 1 + u, 2 + u, 3 + u, ones
    elif mode == "lcg":
        r = (torch.arange(R, device=dev, dtype=torch.int64) % RT)[:, None]
        z = (h * 40503 + r * 2057) & 0x7FF
        p0, p1, p2, f4 = z, (z + 7) & 0x7FF, (z + 13) & 0x7FF, ones
    elif mode == "smem1":
        w0 = _u32(words)[:, 0:2 * n:2]
        p0, p2, f4 = w0 & 0xFFFF, w0 >> 16, ones
        p1 = p0
    else:
        raise ValueError(f"probe_bounds: unknown mode {mode!r}")
    return _count_rows(table, p0, p1, p2, f4, mask,
                       one_row=mode == "load1")[0]


def _check_table(name: str, table, words, n_hash) -> tuple[int, int, int]:
    """Validates the (table, words, n_hash) of a probe diagnostic on one
    CUDA device; returns (R, W, B)."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dtype != torch.uint8 or table.dim() != 2 or table.shape[1] % 4:
        raise ValueError(f"{name}: table must be uint8 [S1, B], B a "
                         "multiple of 4")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"{name}: words must be int32 [R, W]")
    R, W = words.shape
    if n_hash.dtype != torch.int32 or n_hash.shape != (R,):
        raise ValueError(f"{name}: n_hash must be int32 [R]")
    if any(x.device != table.device for x in (words, n_hash)):
        raise ValueError(f"{name}: inputs must share the table's device")
    if not all(x.is_contiguous() for x in (table, words, n_hash)) \
            or table.data_ptr() % 4:
        raise ValueError(f"{name}: inputs must be contiguous, the table "
                         "4-byte aligned")
    return R, W, table.shape[1]


def slab_bins(S1: int, B: int, smem_per_block: int) -> int:
    """Slab width in bins of the probe diagnostics' slab route for a
    table [S1, B] on a card whose blocks may take ``smem_per_block``
    bytes of shared memory (the H100: 232,448): the widest of
    SLAB_WIDTHS, no wider than B needs, whose [S1, b] slab fits; 0 where
    none fits, the rows route.  The 16- to 128-bin part of K2's rule
    (csrc/probe_slab.cu, probe_slab_fit; a change to one is made to
    both), for any B that is a multiple of 4.  A function of the shape and the card alone, never
    of a launch's outcome."""
    if S1 <= 0 or B <= 0:
        return 0
    widths = [b for b in SLAB_WIDTHS if b == 16 or b // 2 < B]
    return next((b for b in widths if S1 * b <= smem_per_block), 0)


_SMEM: dict[int, int] = {}


def smem_per_block(device: torch.device) -> int:
    """The shared memory a block of CUDA ``device`` may opt in to."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMEM:
        smem = cuda_build.diag_lib().diag_smem_per_block(idx)
        if smem < 0:
            raise RuntimeError("diag_smem_per_block: CUDA error")
        _SMEM[idx] = smem
    return _SMEM[idx]


def _slab(table: torch.Tensor, rows: bool) -> int:
    """The slab width a launch on ``table`` takes: slab_bins' pick, or 0
    (the rows route) where ``rows`` forces it."""
    return 0 if rows else slab_bins(*table.shape,
                                    smem_per_block(table.device))


def probe_bounds(table: torch.Tensor, words: torch.Tensor,
                 n_hash: torch.Tensor, mode: str, U: int = 8,
                 RT: int = 16, _rows: bool = False) -> torch.Tensor:
    """int32 [R, B] counts of the probe variant ``mode`` (one of
    PROBE_BOUNDS_MODES; only p16 counts right) for table uint8 [S1, B],
    p16 position words int32 [R, W] (positions below S1) and hashes per
    read n_hash int32 [R] (at most W / 2 probed in the modes that read
    words); U and RT as the TPU tool's unroll and read tile (nosmem,
    lcg).  Kernel on CUDA, twin on CPU.  The shape picks the kernel's
    route (slab_bins); ``_rows`` forces the rows route, to hold it against
    the twin and time it beside the slab route.  probe_bounds.ROUTES
    counts the routes beside LAUNCHES."""
    if table.device.type == "cpu":
        return probe_bounds_plain(table, words, n_hash, mode, U, RT)
    R, W, B = _check_table("probe_bounds", table, words, n_hash)
    if mode not in PROBE_BOUNDS_MODES:
        raise ValueError(f"probe_bounds: unknown mode {mode!r}")
    S1 = table.shape[0]
    if (mode == "lcg" and S1 < 2048) or (mode == "nosmem"
                                         and not 0 < U < S1 - 3):
        raise ValueError(f"probe_bounds: {S1} slots are too few for {mode}")
    b = _slab(table, _rows)
    out = torch.empty((R, B), dtype=torch.int32, device=table.device)
    err = cuda_build.diag_lib().launch_probe_bounds(
        table.data_ptr(), S1, B, words.data_ptr(), R, W, n_hash.data_ptr(),
        PROBE_BOUNDS_MODES.index(mode), U, RT, b, out.data_ptr(),
        cuda_build.stream_of(table))
    cuda_build.check(err, "launch_probe_bounds")
    if R and B:
        cuda_build.count_launch(probe_bounds, "slab" if b else "rows")
    return out


probe_bounds.LAUNCHES = 0
probe_bounds.ROUTES = {}


def probe_experiment_plain(table, words, n_hash, layout: str = "p16",
                           nr: int = 1, rounds: int = 0, flood_k: int = 0,
                           block_length: int = 0):
    """Plain twin of probe_experiment (same contract; nr changes only the
    kernel's schedule)."""
    R, W = words.shape
    dev = words.device
    extra = torch.zeros(R, dtype=torch.int64, device=dev)
    counts = torch.zeros((R, table.shape[1]), dtype=torch.int32, device=dev)
    n = int(n_hash.max()) if R else 0
    if flood_k:
        idx = torch.arange(flood_k * n, device=dev) & 1023
        live = (torch.arange(flood_k * n, device=dev)[None, :]
                < flood_k * n_hash.to(torch.int64)[:, None])
        extra = (_u32(words)[:, idx] * live).sum(dim=1) & M32
        return counts, _to_i32(extra)
    n_hash = n_hash.clamp(max=4 * W // 5 if layout == "p10" else W // 2)
    n = int(n_hash.max()) if R else 0
    mask = _hash_mask(n_hash, n)
    if layout == "p16":
        p0, p1, p2, f4 = _p16_fields(words, n)
    elif layout == "p10":
        H = 4 * W // 5
        w = _u32(words)
        pw = w[:, H // 4:H // 4 + n]
        h = torch.arange(n, device=dev)
        f = (w[:, h >> 2] >> (8 * (h & 3))[None, :]) & 0xFF
        bl = int(block_length)
        p0, p1, p2 = pw & 1023, bl + ((pw >> 10) & 1023), 2 * bl + (pw >> 20)
        f4 = f * 0x01010101
    else:
        raise ValueError(f"probe_experiment: unknown layout {layout!r}")
    z = torch.zeros((R, table.shape[1] // 4), dtype=torch.int64, device=dev)
    counts, chains = _count_rows(table, p0, p1, p2, f4, mask,
                                 chains=(rounds, z, z) if rounds else None)
    if rounds:
        extra = ((chains[1] ^ chains[2]) >> 31).sum(dim=1)
    return counts, _to_i32(extra & M32)


def probe_experiment(table: torch.Tensor, words: torch.Tensor,
                     n_hash: torch.Tensor, layout: str = "p16", nr: int = 1,
                     rounds: int = 0, flood_k: int = 0,
                     block_length: int = 0, _rows: bool = False):
    """(counts int32 [R, B], extra int32 [R]) of one probe experiment:
    the real counts of table uint8 [S1, B] from position words int32
    [R, W] in ``layout`` (p16: two words a hash; p10: W = H + H/4 with
    the H/4 fingerprint words first, positions p_i = i * block_length +
    o_i; a read probes at most the hashes its row holds),
    nr reads interleaved per thread (1, 2 or 4), ``rounds`` rounds of ALU
    chains per hash whose result lands in extra; or, with flood_k > 0,
    zero counts and extra[r] the sum (mod 2**32) of words[r, (K*h + u) &
    1023] over h < n_hash[r], u < K (W >= 1024).  Kernel on CUDA, twin on
    CPU.  The probe experiments take the route the shape picks
    (slab_bins), or the rows route where ``_rows`` forces it;
    probe_experiment.ROUTES counts them, and the flood, which touches no
    table, as "flood"."""
    if table.device.type == "cpu":
        return probe_experiment_plain(table, words, n_hash, layout, nr,
                                      rounds, flood_k, block_length)
    R, W, B = _check_table("probe_experiment", table, words, n_hash)
    if layout not in LAYOUTS or nr not in (1, 2, 4) or rounds < 0 \
            or flood_k < 0:
        raise ValueError(f"probe_experiment: unsupported layout {layout!r}, "
                         f"nr {nr}, rounds {rounds}, flood_k {flood_k}")
    H = 4 * W // 5
    if flood_k and W < 1024:
        raise ValueError("probe_experiment: smemflood reads 1024 words a row")
    if layout == "p10" and not flood_k and (W % 5 or H % 4 or not (
            0 < block_length and 3 * block_length <= table.shape[0])):
        raise ValueError("probe_experiment: p10 words are [R, H + H/4] "
                         "(H a multiple of 4) over three blocks of "
                         "block_length slots")
    b = 0 if flood_k else _slab(table, _rows)
    # the probe modes write every count; the flood leaves them 0
    out = (torch.zeros if flood_k else torch.empty)(
        (R, B), dtype=torch.int32, device=table.device)
    extra = torch.zeros(R, dtype=torch.int32, device=table.device)
    err = cuda_build.diag_lib().launch_probe_experiment(
        table.data_ptr(), table.shape[0], B, words.data_ptr(), R, W, H,
        n_hash.data_ptr(), LAYOUTS.index(layout), nr, rounds, flood_k,
        int(block_length), b, out.data_ptr(), extra.data_ptr(),
        cuda_build.stream_of(table))
    cuda_build.check(err, "launch_probe_experiment")
    if R and (flood_k or B):
        cuda_build.count_launch(probe_experiment, "flood" if flood_k else
                                "slab" if b else "rows")
    return out, extra


probe_experiment.LAUNCHES = 0
probe_experiment.ROUTES = {}


def extract_stages_plain(packed: torch.Tensor, lengths: torch.Tensor,
                         k: int, s: int, t: int,
                         stages=STAGES) -> dict[str, torch.Tensor]:
    """{stage: twin output} for each of ``stages`` (the contract of
    extract_stage), sharing the intermediates between them."""
    codes = unpack_codes(packed)
    R, L = codes.shape
    out: dict[str, torch.Tensor] = {}
    if {"sf", "sr", "ys", "erm"} & set(stages):
        sf, sr = _rolling(codes, s)
        ys = torch.minimum(sf, sr)
        ys[:, :s - 1] = M32
        out.update(sf=sf, sr=sr, ys=ys)
        if "erm" in stages:  # scanning leftwards, a strict < moves it
            ends = torch.arange(L, device=codes.device).expand(R, L)
            best, erm = ys, ends
            for d in range(1, k - s + 1):
                cand = _shift_right(ys, d, fill=1 << 62)
                take = cand < best
                best = torch.where(take, cand, best)
                erm = torch.where(take, ends - d, erm)
            out["erm"] = erm
    if {"kf", "kr", "chi", "clo"} & set(stages):
        kf, kr = _rolling(codes, k)
        canon = umin(kf, kr)
        out.update(kf=kf, kr=kr, chi=(canon >> 32) & M32, clo=canon & M32)
    if {"emit", "pre"} & set(stages):
        kmer, emit = syncmer_kmers(packed, lengths, k, s, t)
        # emitted positions first, in position order (= emission order)
        order = torch.argsort((~emit).to(torch.int8), dim=1, stable=True)
        pos = torch.arange(L, device=codes.device)[None, :]
        out["emit"] = emit
        out["pre"] = torch.where(pos < emit.sum(dim=1, keepdim=True),
                                 kmer.gather(1, order),
                                 torch.full_like(kmer, -1))
    return {st: out[st] for st in stages}


def extract_stage_plain(packed, lengths, k: int, s: int, t: int,
                        stage: str) -> torch.Tensor:
    """Plain twin of extract_stage."""
    if stage not in STAGES:
        raise ValueError(f"extract_stage: unknown stage {stage!r}")
    return extract_stages_plain(packed, lengths, k, s, t, (stage,))[stage]


def stage_smem(L: int, stage: str) -> int:
    """Dynamic shared-memory bytes of an extract_stage launch at length L
    (csrc/diag/extract_stages.cu walk_smem, which the C query
    ``extract_stage_smem`` returns): for emit and pre the s-mer ring, the
    emission mask and its prefix counts (a word each 32 bases) and the
    read staged with two zero words either side; 0 for the per-position
    stages, whose tiles take static shared memory."""
    if stage not in ("emit", "pre"):
        return 0
    return 4 * (STAGE_RING + 2 * ((L + 31) // 32) + L // 16 + 4)


def extract_stage(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                  s: int, t: int, stage: str) -> torch.Tensor:
    """One stage of the syncmer extractor for packed reads uint8 [R, L/4]
    (pack_reads) and lengths int32 [R], in position order: bool [R, L]
    for ``emit``, else int64 [R, L] (csrc/diag/extract_stages.cu lists
    the stages).  The per-position stages take a block per tile of 1,024
    positions and are bound by the 8 bytes they write a position.
    ``emit`` and ``pre`` apply the reference tracker's step rule
    (csrc/tracker.cuh tracker_step) to every window of a read in order,
    on one thread, while the block's other warps compute its s-mers
    ahead: the sequential rule K1 is bisected against, bound by one
    read's chain of steps.  Kernel on CUDA, twin on CPU."""
    if stage not in STAGES:
        raise ValueError(f"extract_stage: unknown stage {stage!r}")
    if packed.device.type == "cpu":
        return extract_stage_plain(packed, lengths, k, s, t, stage)
    R, L = _check_reads("extract_stage", packed, lengths, k, s, t)
    if s > 15:  # the stage dump reads 32-bit s-mers (K1's 32-bit instance)
        raise ValueError(f"extract_stage: unsupported scheme k={k} s={s} "
                         f"t={t}: s <= 15")
    dev = packed.device
    emit = stage == "emit"
    out = torch.empty((R, L), dtype=torch.bool if emit else torch.int64,
                      device=dev)
    err = cuda_build.diag_lib().launch_extract_stage(
        packed.data_ptr(), lengths.data_ptr(), R, L, k, s, t,
        STAGES.index(stage), None if emit else out.data_ptr(),
        out.data_ptr() if emit else None, cuda_build.stream_of(packed))
    cuda_build.check(err, "launch_extract_stage")
    if R:
        cuda_build.count_launch(extract_stage)
    return out


extract_stage.LAUNCHES = 0


def _phase_shift(c: int) -> tuple[int, int]:
    """(jb, sh) of phase c: off = 2c - 22 = 32 jb + sh, 0 <= sh < 32."""
    off = 2 * c - 24 + 2
    return off >> 5, off - 32 * (off >> 5)


def window_shift_plain(x: torch.Tensor, phases) -> torch.Tensor:
    """Plain twin of window_shift."""
    out = []
    for c in phases:
        jb, sh = _phase_shift(int(c))
        w1 = torch.roll(x, -(jb + 1), dims=1)
        out.append(_to_i32((_u32(w1) << (32 - sh)) & 0xFFFFFF) if sh
                   else w1)
    return torch.cat(out, dim=1)


def shift_args(phases, Wd: int) -> list[int]:
    """[d0, sh0, d1, sh1, ...]: window_shift's kernel arguments, for each
    phase block the source offset d = (jb + 1) mod Wd (output word j
    reads word j + d, less Wd past the row) and the shift sh."""
    out = []
    for c in phases:
        jb, sh = _phase_shift(int(c))
        out += [(jb + 1) % Wd, sh]
    return out


def window_shift(x: torch.Tensor, phases=range(16)) -> torch.Tensor:
    """int32 [R, Wd * len(phases)]: for each phase c, the stream words x
    int32 [R, Wd] rolled left by jb + 1 words and, if sh, shifted left by
    32 - sh and masked to 24 bits (off = 2c - 22 = 32 jb + sh), phase
    blocks in the order given.  The kernel takes a block per eight rows
    and a phase, the phase's (d, sh) of ``shift_args`` by value, and
    writes four words a 16-byte store: bound by its bytes.  Kernel on
    CUDA, twin on CPU."""
    phases = [int(c) for c in phases]
    if x.device.type == "cpu":
        return window_shift_plain(x, phases)
    if x.device.type != "cuda" or x.dtype != torch.int32 or x.dim() != 2 \
            or not x.is_contiguous():
        raise ValueError("window_shift: x must be contiguous int32 [R, Wd] "
                         "on a CUDA device")
    R, Wd = x.shape
    out = torch.empty((R, Wd * len(phases)), dtype=torch.int32,
                      device=x.device)
    if not out.numel():
        return out
    args = shift_args(phases, Wd)
    err = cuda_build.diag_lib().launch_window_shift(
        x.data_ptr(), R, Wd, (ctypes.c_int32 * len(args))(*args),
        len(phases), out.data_ptr(), cuda_build.stream_of(x))
    cuda_build.check(err, "launch_window_shift")
    cuda_build.count_launch(window_shift)
    return out


window_shift.LAUNCHES = 0


# ----------------------------------------------------------- DSMEM rate --
DSMEM_MODES = ("local", "remote", "spread", "word", "stream")
DSMEM_THREADS = 1024  # kThreads of csrc/diag/dsmem.cu


def _xs32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ ((x << 13) & M32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & M32)


def dsmem_rows_plain(mode: str, C: int, clusters: int, rows_log2: int,
                     iters: int) -> torch.Tensor:
    """Plain twin of dsmem_rows (same contract), on the CPU."""
    rows = 1 << rows_log2
    T = DSMEM_THREADS
    w = torch.arange(4 * rows, dtype=torch.int64)
    buf = ((((torch.arange(C, dtype=torch.int64)[:, None] + 1) * 0x9E3779B1)
            ^ (w[None, :] * 0x85EBCA77)) & M32).view(C, rows, 4)
    gid = torch.arange(clusters * C * T, dtype=torch.int64)
    rank, tid = (gid // T) % C, gid % T
    s = ((gid * 0x9E3779B9) & M32) | 1
    acc = torch.zeros((gid.numel(), 4), dtype=torch.int64)
    for it in range(iters):
        s = _xs32(s)
        if mode == "word":
            word = s & (4 * rows - 1)
            acc[:, 0] ^= buf.view(C, -1)[rank, word]
            continue
        src, row = (rank + 1) % C, s & (rows - 1)
        if mode == "local":
            src = rank
        elif mode == "spread":
            g = s & (C * rows - 1)
            src, row = g >> rows_log2, g & (rows - 1)
        elif mode == "stream":
            row = (it * T + tid) & (rows - 1)
        acc ^= buf[src, row]
    return _to_i32(acc).view(clusters * C, T, 4)


def dsmem_clusters(mode: str, C: int, rows_log2: int,
                   device: torch.device) -> int:
    """The clusters of C blocks of dsmem_rows that CUDA ``device`` holds
    at once (cudaOccupancyMaxActiveClusters)."""
    n = cuda_build.diag_lib().launch_dsmem_rows(
        DSMEM_MODES.index(mode), C, 0, rows_log2, 0, None,
        cuda_build.stream_of(torch.empty(0, device=device)))
    if n > 0:
        raise RuntimeError(f"launch_dsmem_rows: CUDA error {n}")
    return -n


def dsmem_rows(mode: str, C: int, clusters: int, rows_log2: int,
               iters: int, device) -> torch.Tensor:
    """int32 [clusters * C, DSMEM_THREADS, 4]: the XOR of the ``iters``
    16-byte rows (mode "word": 4-byte words, in word 0) each thread of
    csrc/diag/dsmem.cu reads in ``mode`` (DSMEM_MODES; local, a remote
    rank, spread over the cluster, words, a coalesced stream) from
    clusters of C blocks (a power of two up to 16) of 2^rows_log2 rows
    each.  Kernel on a CUDA device, twin on "cpu"; the measurement of the
    rate of distributed shared memory against the block's own."""
    device = torch.device(device)
    if device.type == "cpu":
        return dsmem_rows_plain(mode, C, clusters, rows_log2, iters)
    if mode not in DSMEM_MODES or clusters < 1:
        raise ValueError(f"dsmem_rows: unknown mode {mode!r} or no cluster")
    out = torch.empty((clusters * C, DSMEM_THREADS, 4), dtype=torch.int32,
                      device=device)
    err = cuda_build.diag_lib().launch_dsmem_rows(
        DSMEM_MODES.index(mode), C, clusters, rows_log2, iters,
        out.data_ptr(), cuda_build.stream_of(out))
    cuda_build.check(err, "launch_dsmem_rows")
    cuda_build.count_launch(dsmem_rows)
    return out


dsmem_rows.LAUNCHES = 0
