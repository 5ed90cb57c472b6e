"""The extractor stage dumps and the window shift of
csrc/diag/extract_stages.cu on the CPU: a numpy model of what a block of
each kernel does, held equal to the plain twins (device/diag.py) and,
through them or directly, to the JAX package.

- stage_tile_kernel: a tile's 2-bit words staged with kLead zero words
  before it, the forward and reverse-complement halves of every m-mer by
  funnel shifts (pair16, pair32), erm scanned over the tile's ys and the
  kHalo ends before it;
- walk_kernel: the producers' chunks of ys in a ring of kRing slots, the
  walking thread's tracker_step over them in groups of eight, its mask
  and running count, then the block's rank-and-write of pre;
- window_shift_kernel: a phase's (d, sh) from the host, head words, then
  16-byte units of four words, then a tail.

The kernels run only on the card; these hold their schedules here.  Each
ring read checks the slot still holds the s-mer it should, so a ring too
small for the walker's reads fails (test_a_ring_of_two_chunks_is_caught).
All integer, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.hash import device_syncmer as jdsync
from taxor_tpu_torch.device import diag
from taxor_tpu_torch.hash import device_syncmer as dsync

from .test_torch_extract import (_funnel, _rev2_32, kernel_kmers,
                                 kernel_smers, staged_words, tie_reads,
                                 tracker_step)
from .test_torch_extract import reads as extract_reads

M32 = 0xFFFFFFFF
TILE, LEAD, HALO = 1024, 4, 32  # kTile, kLead, kHalo
CHUNK, SLOTS, GROUP = 1024, 4, 8  # kChunk, kRing / kChunk, kGroup
H100_SMEM = 232_448  # shared memory a block may opt in to on the H100
H100_SM = 233_472  # shared memory an SM holds for its blocks
PER_POSITION = diag.STAGES[:8]
SCHEMES = [(22, 12, 5), (32, 15, 1), (15, 2, 14), (21, 11, 11)]


# ------------------------------------------------ per-position stages --
def tile_words(words: np.ndarray, i0: int, tile: int) -> np.ndarray:
    """The staged words of the tile from position i0: word g = i0/16 -
    LEAD + x of the read, zero outside it."""
    g = i0 // 16 - LEAD + np.arange(LEAD + tile // 16 + 2)
    ok = (g >= 0) & (g < len(words))
    return np.where(ok, words[np.clip(g, 0, len(words) - 1)],
                    0).astype(np.uint64)


def pair16(sw, q, m):
    """pair16: (forward, reverse complement) of the m <= 15 bases from
    staged base q (int64 array)."""
    assert (q >= 0).all()
    j = q >> 4
    raw = _funnel(sw[j], sw[j + 1], (2 * (q & 15)).astype(np.uint64))
    return (_rev2_32(raw) >> np.uint64(32 - 2 * m),
            ~raw & np.uint64((1 << (2 * m)) - 1))


def pair32(sw, q, m):
    """pair32: the same for m <= 32 bases, from three staged words."""
    assert (q >= 0).all() and (q >> 4).max() + 2 < len(sw)
    j = q >> 4
    sh = (2 * (q & 15)).astype(np.uint64)
    lo = _funnel(sw[j], sw[j + 1], sh)
    hi = _funnel(sw[j + 1], sw[j + 2], sh)
    rc = ~(hi << np.uint64(32) | lo) & np.uint64((1 << (2 * m)) - 1)
    fwd = (_rev2_32(lo) << np.uint64(32) | _rev2_32(hi)) >> np.uint64(
        64 - 2 * m)
    return fwd, rc


def tile_stages(packed: np.ndarray, k: int, s: int,
                tile: int = TILE) -> dict:
    """{stage: int64 [R, L]} of the eight per-position stages, tile by
    tile as stage_tile_kernel computes them."""
    R, L = packed.shape[0], packed.shape[1] * 4
    out = {st: np.zeros((R, L), dtype=np.int64) for st in PER_POSITION}
    w = k - s + 1
    for r in range(R):
        words = np.ascontiguousarray(packed[r]).view("<u4").astype(np.uint64)
        for i0 in range(0, L, tile):
            sw = tile_words(words, i0, tile)
            i = i0 + np.arange(min(tile, L - i0))
            q = i - i0 + 16 * LEAD  # staged base of position i

            def ys(e):
                f, rc = pair16(sw, np.maximum(e - i0 + 16 * LEAD - s + 1,
                                              0), s)
                return np.where(e < s - 1, M32, np.minimum(f, rc))

            sf, sr = pair16(sw, q - s + 1, s)
            kf, kr = pair32(sw, q - k + 1, k)
            canon = np.minimum(kf, kr)
            ysb = ys(i0 - HALO + np.arange(HALO + len(i)))
            best, erm = ysb[HALO:].copy(), i.copy()
            for d in range(1, w):  # scanning leftwards: a strict < moves it
                live = i - d >= 0
                at = i - d - i0 + HALO
                assert (at[live] >= 0).all()  # the halo holds the window
                cand = np.where(live, ysb[np.maximum(at, 0)], M32 + 1)
                take = cand < best
                best = np.where(take, cand, best)
                erm = np.where(take, i - d, erm)
            vals = dict(sf=sf, sr=sr, ys=ys(i), kf=kf, kr=kr,
                        chi=canon >> np.uint64(32),
                        clo=canon & np.uint64(M32), erm=erm)
            for st, v in vals.items():
                out[st][r, i0:i0 + len(i)] = np.asarray(v).astype(
                    np.uint64).view(np.int64)
    return out


def twin_stages(packed, lengths, k, s, t, stages=diag.STAGES):
    got = diag.extract_stages_plain(torch.from_numpy(packed),
                                    torch.from_numpy(lengths), k, s, t,
                                    stages)
    return {st: v.numpy() for st, v in got.items()}


@pytest.mark.parametrize("tile", [TILE, 64])
@pytest.mark.parametrize("k,s", [(22, 12), (32, 15), (15, 2)])
def test_pair_helpers_on_tile_staging_equal_twins_and_jax(k, s, tile):
    """Every position, i < m-1 included (bases before 0 read as A), over
    two kernel tiles and over many tiles of 64 positions."""
    L = 2048
    seqs = extract_reads(k + s, L, n=4)
    packed, lengths = dsync.pack_reads(seqs, L)
    got = tile_stages(packed, k, s, tile)
    want = twin_stages(packed, lengths, k, s, (k - s + 1) // 2,
                       PER_POSITION)
    for st in PER_POSITION:
        np.testing.assert_array_equal(got[st], want[st], err_msg=st)
    for m, (f, r) in ((s, ("sf", "sr")), (k, ("kf", "kr"))):
        fhi, flo, rhi, rlo = (np.asarray(x).astype(np.uint64) for x in
                              jdsync._rolling_packed_words(
                                  jnp.asarray(packed), m))
        for name, hi, lo in ((f, fhi, flo), (r, rhi, rlo)):
            jax = ((hi << np.uint64(32)) | lo).view(np.int64)
            np.testing.assert_array_equal(got[name][:, m - 1:],
                                          jax[:, m - 1:], err_msg=name)


# ------------------------------------------------------ emit and pre --
class Ring:
    """The ys ring of walk_kernel: a slot holds the s-mer of one end
    position at a time, and a read checks it holds the one asked for."""

    def __init__(self, size: int):
        self.size, self.val, self.end = size, [0] * size, [-1] * size

    def write(self, e: int, v: int) -> None:
        self.val[e % self.size], self.end[e % self.size] = v, e

    def read(self, e: int) -> int:
        assert self.end[e % self.size] == e, \
            f"ring slot of {e} holds {self.end[e % self.size]}"
        return self.val[e % self.size]


class Ys:
    """The walker's ys(e): the s-mer loaded into a register for the
    window's own end i, the ring for the others."""

    def __init__(self, ring: Ring, i: int, yi: int):
        self.ring, self.i, self.yi = ring, i, yi

    def __getitem__(self, e: int) -> int:
        return self.yi if e == self.i else self.ring.read(e)


def walk(ys, n: int, k: int, s: int, t: int, chunk: int = CHUNK,
         slots: int = SLOTS):
    """walk_kernel's emit and its running count for a read of n bases
    with canonical s-mers ys: (mask words, prefix counts, count, stats).
    The producers fill chunk c+1 before the walker takes chunk c (as
    fast producers may).  stats counts the slide-out rescans and the tied
    windows that reach back over a chunk border."""
    w = k - s + 1
    ring = Ring(slots * chunk)
    nc = -(-n // chunk)

    def produce(c):
        for e in range(max(c * chunk, s - 1), min((c + 1) * chunk, n)):
            ring.write(e, ys[e])

    if nc:
        produce(0)
    mask, prefix = [0] * (-(-n // 32)), [0] * (-(-n // 32))
    qv, qp, cnt = M32, -1, 0
    stats = {"rescans_across": 0, "tied_across": 0}
    for c in range(nc):
        if c + 1 < nc:
            produce(c + 1)
        end = min((c + 1) * chunk, n)
        m = 0
        for b in range(c * chunk, end, GROUP):
            y = [ring.val[(b + j) % ring.size] for j in range(GROUP)]
            for j in range(GROUP):
                i = b + j
                if not k - 1 <= i < n:
                    continue
                assert ring.end[(b + j) % ring.size] == i  # loaded in time
                if i - w + 1 < c * chunk:  # the window reaches back
                    win = ys[i - w + 1:i + 1]
                    stats["tied_across"] += win.count(min(win)) > 1
                    stats["rescans_across"] += qp == i - k
                qv, qp, e = tracker_step(i, k, s, t, Ys(ring, i, y[j]),
                                         qv, qp)
                m |= int(e) << (i & 31)
            if (b + GROUP) % 32 == 0 or b + GROUP >= end:
                mask[b >> 5], prefix[b >> 5] = m, cnt
                cnt += bin(m).count("1")
                m = 0
    return mask, prefix, cnt, stats


def rank_write(mask, prefix, total: int, kmers, L: int,
               ring: int = diag.STAGE_RING) -> np.ndarray:
    """walk_kernel's pre: the emitted positions of ring bases at a time
    at their ranks, their k-mers in rank order, -1 past the count in
    pairs; every position written once."""
    out = np.zeros(L, dtype=np.int64)
    writes = np.zeros(L, dtype=np.int64)
    nwalk, words = len(mask), ring // 32
    for w0 in range(0, nwalk, words):
        n0, lst = prefix[w0], [None] * ring
        for wi in range(w0, min(w0 + words, nwalk)):
            m, o = mask[wi], prefix[wi] - n0
            while m:
                lst[o] = 32 * wi + (m & -m).bit_length() - 1
                o, m = o + 1, m & (m - 1)
        cnt = (prefix[w0 + words] if w0 + words < nwalk else total) - n0
        for j in range(cnt):
            out[n0 + j] = kmers[lst[j]]
            writes[n0 + j] += 1
    for p in range(0, L, 2):
        if p >= total:
            out[p:p + 2] = -1
            writes[p:p + 2] += 1
        elif p + 1 == total:
            out[p + 1] = -1
            writes[p + 1] += 1
    assert (writes == 1).all()
    return out


def walk_reads(packed, lengths, k, s, t, chunk=CHUNK, slots=SLOTS,
               ring=diag.STAGE_RING):
    """(emit bool [R, L], pre int64 [R, L], stats) of walk_kernel."""
    R, L = packed.shape[0], packed.shape[1] * 4
    emit = np.zeros((R, L), dtype=bool)
    pre = np.zeros((R, L), dtype=np.int64)
    stats = {"rescans_across": 0, "tied_across": 0}
    for r in range(R):
        n = max(0, min(int(lengths[r]), L))
        sw = staged_words(packed[r])
        ys = [int(y) for y in kernel_smers(sw, L, s)]
        mask, prefix, cnt, st = walk(ys, n, k, s, t, chunk, slots)
        for key in stats:
            stats[key] += st[key]
        bits = np.array(mask + [0] * (-(-L // 32) - len(mask)), dtype="<u4")
        emit[r] = np.unpackbits(bits.view(np.uint8),
                                bitorder="little")[:L].astype(bool)
        pre[r] = rank_write(mask, prefix, cnt,
                            kernel_kmers(sw, L, k).view(np.int64), L, ring)
    return emit, pre, stats


@pytest.mark.parametrize("chunk", [CHUNK, 64, 32])
@pytest.mark.parametrize("k,s,t", SCHEMES)
def test_walker_over_chunked_ys_equals_twin_and_jax(k, s, t, chunk):
    """Tied runs and slide-out rescans across chunk borders: small chunks
    put borders inside them on the tied reads."""
    L = 1024
    rng = np.random.default_rng(k * 100 + t)
    seqs = tie_reads(rng, L) + extract_reads(k + t, L, n=3)
    packed, lengths = dsync.pack_reads(seqs, L)
    emit, pre, stats = walk_reads(packed, lengths, k, s, t, chunk)
    want = twin_stages(packed, lengths, k, s, t, ("emit", "pre"))
    np.testing.assert_array_equal(emit, want["emit"])
    np.testing.assert_array_equal(pre, want["pre"])
    if chunk < L:
        assert stats["rescans_across"] > 0 and stats["tied_across"] > 0
    if chunk == CHUNK:
        je = jdsync.syncmer_kmers(jnp.asarray(packed), jnp.asarray(lengths),
                                  k, s, t)[2]
        np.testing.assert_array_equal(emit, np.asarray(je))


def test_a_ring_of_two_chunks_is_caught():
    """With two slots the producers' next chunk overwrites the one a
    rescan at a chunk's start still reads: the model's ring check fails
    (kRing holds four chunks)."""
    L = 256
    packed, lengths = dsync.pack_reads([b"A" * L], L)
    sw = staged_words(packed[0])
    ys = [int(y) for y in kernel_smers(sw, L, 12)]
    walk(ys, L, 22, 12, 5, chunk=32, slots=3)
    with pytest.raises(AssertionError, match="ring slot"):
        walk(ys, L, 22, 12, 5, chunk=32, slots=2)


@pytest.mark.parametrize("ring", [diag.STAGE_RING, 64])
@pytest.mark.parametrize("L", [256, 2048])
def test_pre_rank_and_write_equals_twin(L, ring):
    """Random, homopolymer, N, short and empty reads; a small ring takes
    the ranks over many rounds."""
    seqs = extract_reads(L + ring, L, n=6)
    packed, lengths = dsync.pack_reads(seqs, L)
    emit, pre, _ = walk_reads(packed, lengths, 22, 12, 5, ring=ring)
    want = twin_stages(packed, lengths, 22, 12, 5, ("emit", "pre"))
    assert emit.sum() > 0 and (lengths == 0).any()
    np.testing.assert_array_equal(emit, want["emit"])
    np.testing.assert_array_equal(pre, want["pre"])


@pytest.mark.parametrize("L", [256, 512, 1024, 2048, 4096, 8192, 16384,
                               32768])
def test_stage_smem_keeps_four_blocks_an_sm(L):
    """emit and pre take the ring, the mask, its prefix and the staged
    read: within a block's 227 KB, and small enough for four blocks an
    SM (R = 512 reads resident at once on 132 SMs) at every bucket."""
    for stage in diag.STAGES:
        smem = diag.stage_smem(L, stage)
        if stage in PER_POSITION:
            assert smem == 0
            continue
        assert smem == 4 * (diag.STAGE_RING + 2 * (L // 32) + L // 16 + 4)
        assert smem <= H100_SMEM
        assert 4 * (smem + 1024) <= H100_SM  # 1 KB reserved a block


# -------------------------------------------------------- window shift --
def shift_model(x: np.ndarray, phases, max_phases: int = 64):
    """window_shift_kernel's stores: (out uint32 [R, P Wd], 16-byte units
    whose four source words wrap around the row)."""
    R, Wd = x.shape
    P = len(phases)
    out = np.zeros(R * P * Wd, dtype=np.uint32)
    writes = np.zeros(R * P * Wd, dtype=np.int64)
    args = diag.shift_args(phases, Wd)
    wraps = 0
    for pi0 in range(0, P, max_phases):  # a launch per 64 phases
        for by in range(min(max_phases, P - pi0)):
            d, sh = args[2 * (pi0 + by)], args[2 * (pi0 + by) + 1]
            assert 0 <= d < Wd and 0 <= sh < 32

            def src(j):
                return j + d - Wd if j + d >= Wd else j + d

            for r in range(R):
                o = (r * P + pi0 + by) * Wd  # the segment's first word
                head = min(Wd, -o & 3)
                units = (Wd - head) >> 2
                tail = head + 4 * units
                assert Wd - tail < 4
                stores = [[j] for j in range(head)]
                for u in range(units):
                    j = head + 4 * u
                    assert (o + j) % 4 == 0  # a 16-byte store
                    stores.append(list(range(j, j + 4)))
                    wraps += src(j + 3) < src(j)
                stores += [[j] for j in range(tail, Wd)]
                for js in stores:
                    for j in js:
                        v = int(x[r, src(j)])
                        out[o + j] = ((v << (32 - sh)) & 0xFFFFFF if sh
                                      else v)
                        writes[o + j] += 1
    assert (writes == 1).all()
    return out.reshape(R, P * Wd), wraps


@pytest.mark.parametrize("phases", [[3, 0], [5, 5], list(range(16)),
                                    list(range(16)) * 5])
@pytest.mark.parametrize("Wd", [16, 17, 64])
def test_window_shift_units_equal_twin(Wd, phases):
    """Subsets, repeats and orders of phases; Wd not a multiple of 4
    (head and tail words); 80 phases in two launches."""
    rng = np.random.default_rng(Wd + len(phases))
    x = rng.integers(0, 1 << 32, (5, Wd), dtype=np.uint64).astype(np.uint32)
    got, wraps = shift_model(x, phases)
    want = diag.window_shift_plain(torch.from_numpy(x.view(np.int32)),
                                   phases).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        diag.window_shift(torch.from_numpy(x.view(np.int32)),
                          phases).numpy().view(np.uint32), want)
    if len(phases) >= 16:  # phases 11-15 roll by one word
        assert wraps > 0
