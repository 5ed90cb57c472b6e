"""The slab route of the probe diagnostics (csrc/diag/probe_bounds.cu,
csrc/diag/probe_experiments.cu, csrc/diag/slab.cuh) on the CPU: the route
picker at the H100's shared memory, and a numpy model of the kernels'
slab schedule held equal to the plain twins in every mode.

The model runs what a block of the slab route does, slab by slab: the
[S1, b] slab copied with stale bytes past the table's width (a ragged
last slab), 16-byte chunks of 4 words, zero_bytes into packed byte
counters with 32-bit wrap-around, a flush into the output after at most
255 hashes a lane (252 in read-lanes, which take 4 hashes at a time; the
first flush writes, a later one adds), and:
probe_bounds in K2's schedule (32 / CH hash-lanes take every
(32 / CH)-th hash of a read, their counts summed as the warp shuffles
sum them); probe_experiment in read-lanes (a lane walks every hash of its
NR reads in hash order, so the ALU chains advance as the twin's do).  A
byte counter that reached 256 would carry into its neighbour and show as
a wrong count.  All integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

from taxor_tpu_torch.device import diag
from taxor_tpu_torch.tools import probe_bounds as pb
from taxor_tpu_torch.tools import probe_experiments as pe

M32 = 0xFFFFFFFF
H100_SMEM = 232_448  # shared memory a block may opt in to on the H100
FLUSH = 255  # hashes a hash-lane counts between flushes
FLUSH4 = 252  # a read-lane's: a multiple of the 4 hashes it loads at once
S1, BL = 2419, 806  # the TPU tools' table: 3 blocks of 806 + a zero slot


def zero_bytes(x: np.ndarray) -> np.ndarray:
    """uint32: 1 in each byte of x that is zero (probe_stage.cuh)."""
    x = x.astype(np.uint32)
    return (~(((x & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | x)
            & np.uint32(0x80808080)) >> np.uint32(7)


def unpack(k: np.ndarray) -> np.ndarray:
    """[..., 4] packed byte counters -> [..., 16] counts (bin 4w + j in
    byte j of word w)."""
    sh = np.arange(4, dtype=np.uint32) * np.uint32(8)
    return ((k[..., :, None] >> sh) & np.uint32(0xFF)).astype(
        np.int64).reshape(*k.shape[:-1], 16)


def fields(kind: str, w: np.ndarray, r: int, e: int, U: int, RT: int,
           H: int):
    """(p0, p1, p2, f4) of hash e of read r; w: the read's words as
    Python ints."""
    if kind in ("p16", "load1"):
        w0, w1 = w[2 * e], w[2 * e + 1]
        return w0 & 0xFFFF, w0 >> 16, w1 & 0xFFFF, \
            ((w1 >> 16) * 0x01010101) & M32
    if kind == "nosmem":
        u = e % U
        return 1 + u, 2 + u, 3 + u, 0x01010101
    if kind == "lcg":
        z = (e * 40503 + (r % RT) * 2057) & 0x7FF
        return z, (z + 7) & 0x7FF, (z + 13) & 0x7FF, 0x01010101
    if kind == "smem1":
        w0 = w[2 * e]
        return w0 & 0xFFFF, w0 & 0xFFFF, w0 >> 16, 0x01010101
    # p10: the word of hash e after H/4 fingerprint words, f = byte e
    ww = w[H // 4 + e]
    f = (w[e >> 2] >> (8 * (e & 3))) & 0xFF
    return ww & 1023, BL + ((ww >> 10) & 1023), 2 * BL + (ww >> 20), \
        f * 0x01010101


def slab_chunks(rng, table: np.ndarray, s0: int, b: int) -> np.ndarray:
    """uint32 [S1, b/16, 4]: the slab of bins [s0, s0 + b) as a block
    holds it, its bytes past the table's width stale (random)."""
    S, B = table.shape
    slab = rng.integers(0, 256, (S, b), dtype=np.uint8)
    slab[:, :min(b, B - s0)] = table[:, s0:s0 + b]
    return slab.view(np.uint32).reshape(S, b // 16, 4)


def chunk_x(sl: np.ndarray, p, f4: int, one_row: bool) -> np.ndarray:
    x = sl[p[0]] if one_row else sl[p[0]] ^ sl[p[1]] ^ sl[p[2]]
    return x ^ np.uint32(f4)


def put(out, r: int, s0: int, cnt: np.ndarray, add: bool) -> None:
    """Writes (adds) the [CH, 16] counts of a slab's chunks into out's
    row r, bins below B only."""
    B = out.shape[1]
    for c in range(cnt.shape[0]):
        lo, hi = s0 + 16 * c, min(B, s0 + 16 * c + 16)
        if lo < hi:
            if add:
                out[r, lo:hi] += cnt[c, :hi - lo]
            else:
                out[r, lo:hi] = cnt[c, :hi - lo]


def bounds_model(table, words, n_hash, mode: str, b: int, U=8, RT=16,
                 seed=0) -> np.ndarray:
    """probe_bounds' slab route: K2's schedule, hash-lanes."""
    rng = np.random.default_rng(seed)
    R, W = words.shape
    B = table.shape[1]
    HL = 32 // (b // 16)
    w32 = words.view(np.uint32)
    out = np.full((R, B), -7, dtype=np.int64)  # every bin gets written
    for s0 in range(0, B, b):
        sl = slab_chunks(rng, table, s0, b)
        for r in range(R):
            w = [int(v) for v in w32[r]]
            n = int(n_hash[r])
            if mode in ("p16", "load1", "smem1"):
                n = min(n, W // 2)
            e0 = 0
            while True:  # the flush rounds: the warp's alike
                e1 = min(n, e0 + FLUSH * HL)
                k = np.zeros((HL, b // 16, 4), dtype=np.uint32)
                for e in range(e0, e1):
                    p0, p1, p2, f4 = fields(mode, w, r, e, U, RT, 0)
                    k[(e - e0) % HL] += zero_bytes(
                        chunk_x(sl, (p0, p1, p2), f4, mode == "load1"))
                put(out, r, s0, unpack(k).sum(axis=0), e0 > 0)
                if e1 >= n:
                    break
                e0 += FLUSH * HL
    return out


def experiment_model(table, words, n_hash, layout: str, b: int, nr: int,
                     rounds: int, per: int, seed=0):
    """probe_experiment's slab route: read-lanes of nr reads, the reads
    of a block in groups of ``per`` (the last group of a block cut at
    its end); returns (counts, extra)."""
    rng = np.random.default_rng(seed)
    R, W = words.shape
    B = table.shape[1]
    H = 4 * W // 5
    most = H if layout == "p10" else W // 2
    w32 = words.view(np.uint32)
    out = np.full((R, B), -7, dtype=np.int64)
    extra = np.zeros(R, dtype=np.int64)
    for s0 in range(0, B, b):
        sl = slab_chunks(rng, table, s0, b)
        # words of the lane's chunk below B: only they join the chains
        live = (s0 + 16 * np.arange(b // 16)[:, None]
                + 4 * np.arange(4)[None, :]) < B
        for y0 in range(0, R, per):
            r1 = min(R, y0 + per)
            for r0 in range(y0, r1, nr):
                rs = [r for r in range(r0, r0 + nr) if r < r1]
                ws = [[int(v) for v in w32[r]] for r in rs]
                ns = [min(int(n_hash[r]), most) for r in rs]
                nmax = max(ns)
                d1 = np.zeros((len(rs), b // 16, 4), dtype=np.uint32)
                d2 = np.zeros_like(d1)
                e0 = 0
                while True:
                    e1 = min(nmax, e0 + FLUSH4)
                    k = np.zeros_like(d1)
                    for e in range(e0, e1):  # the order of each read's
                        for i, r in enumerate(rs):  # hashes is what counts
                            if e >= ns[i]:
                                continue
                            p0, p1, p2, f4 = fields(layout, ws[i], r, e, 0,
                                                    0, H)
                            x = chunk_x(sl, (p0, p1, p2), f4, False)
                            k[i] += zero_bytes(x)
                            for _ in range(rounds):
                                d1[i] = (d1[i] ^ x) + np.uint32(diag.C1)
                                d2[i] = (d2[i] + x) ^ np.uint32(diag.C2)
                    for i, r in enumerate(rs):
                        if e0 == 0 or e0 < ns[i]:
                            put(out, r, s0, unpack(k[i]), e0 > 0)
                    if e1 >= nmax:
                        break
                    e0 += FLUSH4
                if rounds:
                    for i, r in enumerate(rs):
                        extra[r] += int(((d1[i] ^ d2[i]) >> 31)[live].sum())
    return out, extra


# ------------------------------------------------------------ the pick --
@pytest.mark.parametrize("shape,want", [
    ((2419, 512), 64),    # the TPU tools' table
    ((3606, 4096), 64),   # the flat cell's table
    ((1816, 512), 128),   # a 128-bin slab fits
    ((2419, 36), 64),     # one ragged slab
    ((2419, 32), 32),     # no wider than the table needs
    ((2419, 16), 16),
    ((10000, 64), 16),    # the GPU tests' 16-bin slabs
    ((10000, 36), 16),    # ... with a ragged last slab of 4 bins
    ((14528, 64), 16),    # the last height that fits
    ((14529, 64), 0),     # past the shared memory: rows
    ((20000, 64), 0),
    ((0, 64), 0)])
def test_slab_bins_picks_by_shape(shape, want):
    assert diag.slab_bins(*shape, H100_SMEM) == want


def test_slab_bins_follows_the_cards_shared_memory():
    assert diag.slab_bins(2419, 512, 2 * H100_SMEM) == 128
    assert diag.slab_bins(2419, 512, 48 * 1024) == 16
    assert diag.slab_bins(2419, 512, 16 * 2419 - 1) == 0


def test_probe_routes_count_nothing_on_the_cpu():
    table = torch.zeros((S1, 32), dtype=torch.uint8)
    words = torch.zeros((2, 8), dtype=torch.int32)
    n = torch.full((2,), 4, dtype=torch.int32)
    before = (dict(diag.probe_bounds.ROUTES),
              dict(diag.probe_experiment.ROUTES))
    diag.probe_bounds(table, words, n, "p16")
    diag.probe_experiment(table, words, n)
    assert (diag.probe_bounds.ROUTES, diag.probe_experiment.ROUTES) == before


# ------------------------------------------------------- the schedule --
@pytest.fixture(scope="module")
def ragged_inputs():
    """The tools' table cut to 36 bins (a ragged last slab at every
    width), 10 reads of up to 300 hashes: one with none, one with more
    than its row of 2 x 150 (p16) or 160 (p10) words holds."""
    rng = np.random.default_rng(91)
    table = pb.tool_table(rng, S1, 36)
    H = 160
    w16 = np.ascontiguousarray(pb.make_inputs(rng, 10, H, S1)[:, :300])
    w10 = pe.make_inputs(rng, 10, H, S1, BL)[1]
    n_hash = rng.integers(0, 300, 10).astype(np.int32)
    n_hash[0], n_hash[1] = 0, 300
    return table, w16, w10, n_hash


@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("mode", diag.PROBE_BOUNDS_MODES)
def test_bounds_slab_schedule_equals_twin(ragged_inputs, mode, b):
    table, w16, _, n_hash = ragged_inputs
    want = diag.probe_bounds(*(torch.from_numpy(x) for x in
                               (table, w16, n_hash)), mode).numpy()
    got = bounds_model(table, w16, n_hash, mode, b)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,per", [(16, 10), (64, 7)])
@pytest.mark.parametrize("nr", [1, 2, 4])
@pytest.mark.parametrize("layout,rounds", [("p16", 0), ("p10", 0),
                                           ("p16", 3), ("p10", 2)])
def test_experiment_slab_schedule_equals_twin(ragged_inputs, layout, rounds,
                                              nr, b, per):
    table, w16, w10, n_hash = ragged_inputs
    w = w10 if layout == "p10" else w16
    want = diag.probe_experiment(
        *(torch.from_numpy(x) for x in (table, w, n_hash)), layout, nr,
        rounds, block_length=BL)
    got = experiment_model(table, w, n_hash, layout, b, nr, rounds, per)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert (got[1] != 0).any() == (rounds > 0)


def zero_hit_inputs(B: int, H: int, n):
    """The tools' table and words where every hash hits every bin."""
    table, w16, w10 = pe.zero_hit_inputs(np.random.default_rng(B + H), S1,
                                         B, BL, len(n), H)
    return table, w16, w10, np.array(n, dtype=np.int32)


@pytest.mark.parametrize("b", [16, 64])
def test_counts_past_255_flush_in_time(b):
    """Counts up to 512 a bin: a read-lane writes its counts after 252
    hashes, then adds to them twice; at b = 64 a hash-lane of
    probe_bounds' schedule counts 64 hashes."""
    table, w16, w10, n = zero_hit_inputs(36, 512, [512, 300, 255, 256, 0])
    for mode in ("p16", "load1"):
        got = bounds_model(table, w16, n, mode, b)
        np.testing.assert_array_equal(got, np.repeat(n[:, None], 36, 1))
    for layout, w in (("p16", w16), ("p10", w10)):
        for nr in (1, 2, 4):
            got, extra = experiment_model(table, w, n, layout, b, nr, 0, 5)
            np.testing.assert_array_equal(got, np.repeat(n[:, None], 36, 1))
            want = diag.probe_experiment(
                *(torch.from_numpy(x) for x in (table, w, n)), layout, nr,
                block_length=BL)[0].numpy()
            np.testing.assert_array_equal(got, want)


def test_hash_lanes_flush_past_255_a_lane():
    """probe_bounds' schedule at b = 128 (4 hash-lanes): 1,100 hashes
    take two flush rounds of 1,020, the second added to the first."""
    table, w16, _, n = zero_hit_inputs(144, 1100, [1100, 1020, 1021, 3])
    got = bounds_model(table, w16, n, "p16", 128)
    np.testing.assert_array_equal(got, np.repeat(n[:, None], 144, 1))
    want = diag.probe_bounds(*(torch.from_numpy(x) for x in
                               (table, w16, n)), "p16").numpy()
    np.testing.assert_array_equal(got, want)
