"""A numpy transcription of the register-resident sort network of K3 and
K4 (taxor_tpu_torch/csrc/regsort.cuh, dedup.cu, sort_pairs.cu): the keys
move exactly as the kernels move them, so the schedule is held on the
CPU.

At every step the model knows which (thread, register) holds which key
index: register compare-exchanges inside a thread, __shfl_xor_sync
between lanes, the store to shared memory in layout A and the load in
layout B(w) and back.  Each exchange asserts that its two keys are the
indices i and i ^ d of the stride d that the bitonic network takes next,
and that the direction the kernel computes equals (i & size) == 0.  The
network runs on the card with 32 lanes a warp; the model also runs with
fewer, so that small blocks reach the cross-warp transposes.

The K4 model (striped 16-byte loads, the sort, the first W keys written
from registers) is held exactly against np.sort of the u64 view, the JAX
package's Pallas ``sort_pairs`` in interpret mode and ``sort_pairs_plain``.
The K3 model (the one-pass gather: a contiguous run of positions a
thread, warp scans and warp totals; the sort of pow2(m) keys on P/E
threads; unique flags from the previous register, lane or warp) is held
against ``dedup_fused_plain`` and the JAX ``dedup_fused`` in interpret
mode, the overflow row and rows without emissions included."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.device.pallas_sort import dedup_fused as jax_dedup_fused
from taxor_tpu.device.pallas_sort import sort_pairs as jax_sort_pairs
from taxor_tpu_torch.device import sort
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.tools import time_sort

from .test_torch_extract import reads

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
LANES = 32  # a warp on the card


def ilog2(n: int) -> int:
    return n.bit_length() - 1


def pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def reg_slot(i, E: int):
    """regsort.cuh reg_slot: one spare key every E."""
    return i + (i >> ilog2(E))


def layout_b(t, j, w: int, E: int, lanes: int):
    """The index register j of thread t holds in layout B(w) (regsort.cuh
    cross_warp; the kernel's 5 is log2 of the lanes of a warp)."""
    e, lb = ilog2(E), ilog2(lanes)
    lane, warp, lo = t & (lanes - 1), t >> lb, (1 << w) - 1
    return (((warp >> w) << (e + lb + w)) | ((j & lo) << (e + lb))
            | (lane << e) | ((j >> w) << w) | (warp & lo))


def slot_b(t, j, w: int, E: int, lanes: int):
    """The slot cross_warp reaches for register j of thread t in layout
    B(w): the thread's slot plus a constant of the register."""
    e, lb = ilog2(E), ilog2(lanes)
    lane, warp, lo = t & (lanes - 1), t >> lb, (1 << w) - 1
    base = ((warp >> w) << (e + lb + w)) | (lane << e) | (warp & lo)
    off = ((j & lo) << (e + lb)) | ((j >> w) << w)
    return reg_slot(base, E) + off + (off >> e)


class Network:
    """The schedule of regsort.cuh reg_sort over k [R, Ta, E] (uint64,
    layout A: thread t, register j holds index t*E + j), with the index
    each (thread, register) holds in ``idx`` and the strides taken in
    ``strides`` (one list a merge)."""

    def __init__(self, k: np.ndarray, E: int, lanes: int = LANES):
        self.k, self.E, self.lanes = k.copy(), E, lanes
        self.R, self.Ta, _ = k.shape
        self.P = self.Ta * E
        self.t = np.arange(self.Ta)[:, None]
        self.j = np.arange(E)[None, :]
        self.idx = self.t * E + self.j
        self.strides: list[list[int]] = []
        self.kinds = {"register": 0, "shuffle": 0, "smem round trip": 0}

    def _take(self, d: int, size: int):
        self.strides[-1].append(d)
        assert self.strides[-1] == [size >> (n + 1)
                                    for n in range(len(self.strides[-1]))]

    def _cas_registers(self, dr: int, up, d: int, size: int):
        """compare_exchange(k[j], k[j | dr], up) for every j without dr."""
        lo = [j for j in range(self.E) if not j & dr]
        hi = [j | dr for j in lo]
        assert (self.idx[:, hi] == self.idx[:, lo] ^ d).all()
        up = np.broadcast_to(up, (self.Ta, self.E))[:, lo]
        assert (up == ((self.idx[:, lo] & size) == 0)).all()
        a, b = self.k[:, :, lo], self.k[:, :, hi]
        swap = (a > b) == up
        self.k[:, :, lo] = np.where(swap, b, a)
        self.k[:, :, hi] = np.where(swap, a, b)
        self.kinds["register"] += 1

    def _transpose(self, w: int, to_b: bool):
        """One store to shared memory and one load, through the padded
        slots; the slots of a warp's lanes never share a bank."""
        E, t, j = self.E, self.t, self.j
        ia = t * E + j
        ib = layout_b(t, j, w, E, self.lanes)
        assert (slot_b(t, j, w, E, self.lanes) == reg_slot(ib, E)).all()
        assert (t * (E + 1) + j == reg_slot(ia, E)).all()
        src, dst = (ia, ib) if to_b else (ib, ia)
        slots = reg_slot(src, E)
        assert len(np.unique(slots)) == self.P  # no two keys on one slot
        assert slots.max() < self.P + self.P // E
        lanes = min(self.lanes, self.Ta)
        for jj in range(E):  # 8-byte banks: 16 lanes, 16 distinct
            per_lane = reg_slot(src[:lanes, jj], E) % 16
            assert len(np.unique(per_lane[:16])) == min(16, lanes)
        buf = np.full((self.R, self.P + self.P // E), SENT)
        bidx = np.full(self.P + self.P // E, -1)
        buf[:, slots] = self.k
        bidx[slots] = self.idx
        self.k = buf[:, reg_slot(dst, E)]
        self.idx = bidx[reg_slot(dst, E)]
        assert (self.idx == dst).all()
        self.kinds["smem round trip"] += 1

    def sort(self) -> "Network":
        E, lanes = self.E, self.lanes
        e, lb = ilog2(E), ilog2(lanes)
        t = self.t
        lane, warp = t & (lanes - 1), t >> lb
        size = 2
        while size <= self.P:
            self.strides.append([])
            d = size >> 1
            if d >= lanes * E:  # strides across warps: layout B(w)
                w = ilog2(size) - e - lb
                assert 1 <= w <= e
                self._transpose(w, True)
                up = ((warp >> w) & 1) == 0
                for c in range(e - 1, -1, -1):
                    if c < w:
                        d = 1 << (e + lb + c)
                        self._take(d, size)
                        self._cas_registers(1 << c, up, d, size)
                self._transpose(w, False)
                d = (lanes // 2) * E
            up_t = ((t * E) & size) == 0
            while d >= E:  # strides across lanes: shuffles
                self._take(d, size)
                m = d >> e
                partner = self.t[:, 0] ^ m
                assert m < lanes and (partner >> lb == warp[:, 0]).all()
                assert (self.idx[partner] == self.idx ^ d).all()
                assert (np.broadcast_to(up_t, self.idx.shape)
                        == ((self.idx & size) == 0)).all()
                p = self.k[:, partner, :]
                keep_min = ((lane & m) == 0) == up_t
                self.k = np.where((p < self.k) == keep_min, p, self.k)
                self.kinds["shuffle"] += 1
                d >>= 1
            for c in range(e - 1, -1, -1):  # strides inside a thread
                dr = 1 << c
                if dr < size:
                    self._take(dr, size)
                    self._cas_registers(dr, ((t * E + self.j) & size) == 0,
                                        dr, size)
            assert self.strides[-1][-1] == 1
            size <<= 1
        assert (self.idx == self.t * E + self.j).all()  # back in layout A
        return self


# ------------------------------------------------------------------ K4 --
def k4_shape(Wp: int):
    """sort_pairs.cu launch_sort_pairs: E, and the threads Ta of a row."""
    E = 16 if Wp <= 8192 else 32
    return E, max(1, Wp // E)


def sort_pairs_model(hi, lo, E=None, lanes=LANES, T=None):
    """K4 on uint32 [R, W] rows: register V*c + q of thread t takes pair
    (c*Ta + t)*V + q (V = 4 on the card, whose E is a multiple of 4:
    16-byte loads); the first W keys of layout A go back through their
    shared-memory slots, read by the same striped map."""
    R, W = hi.shape
    Wp = pow2(W)
    if E is None:
        E, Ta = k4_shape(Wp)
    else:
        Ta = max(1, Wp // E)
    assert T is None or Ta <= T
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    k = np.full((R, Ta, E), SENT)
    t = np.arange(Ta)[:, None]
    V = min(4, E)
    c, q = np.arange(E)[None, :] // V, np.arange(E)[None, :] % V
    g = (c * Ta + t) * V + q
    assert sorted(g.ravel().tolist()) == list(range(Ta * E))  # each once
    inside = g < W
    k[:, inside] = keys[:, g[inside]]
    net = Network(k, E, lanes).sort()
    buf = np.full((R, Ta * E + Ta), SENT)
    buf[:, reg_slot(net.idx, E)] = net.k  # thread t, register j: t*E + j
    out = np.empty((R, Ta * E), dtype=np.uint64)
    out[:, g] = buf[:, reg_slot(g, E)]  # read and stored striped
    out = out[:, :W]
    return ((out >> np.uint64(32)).astype(np.uint32),
            (out & np.uint64(0xFFFFFFFF)).astype(np.uint32), net)


def sort_rows(seed: int, R: int, W: int):
    return time_sort.pair_rows(np.random.default_rng(seed), R, W)


@functools.lru_cache(maxsize=None)
def jax_sorted(seed: int, R: int, W: int):
    hi, lo = sort_rows(seed, R, W)
    whi, wlo = jax_sort_pairs(jnp.asarray(hi), jnp.asarray(lo),
                              interpret=True)
    return np.asarray(whi), np.asarray(wlo)


def np_sorted(hi, lo):
    keys = np.sort((hi.astype(np.uint64) << np.uint64(32))
                   | lo.astype(np.uint64), axis=1)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def twin_sorted(hi, lo):
    ghi, glo = sort.sort_pairs_plain(torch.from_numpy(hi.view(np.int32)),
                                     torch.from_numpy(lo.view(np.int32)))
    return ghi.numpy().view(np.uint32), glo.numpy().view(np.uint32)


def small_lanes(T: int, E: int) -> int:
    """Lanes a warp for the model, so that T threads make T/lanes <= E
    warps and more than one: every kind of step runs."""
    return max(2, T // E)


@pytest.mark.parametrize("lanes", ["card", "small"])
@pytest.mark.parametrize("T", [4, 8, 32])
@pytest.mark.parametrize("E", [2, 4, 8])
def test_network_sorts_like_np_sort_jax_and_the_twin(T, E, lanes):
    """Every width up to T*E that is and is not a power of two."""
    ln = LANES if lanes == "card" else small_lanes(T, E)
    assert T // ln <= E
    for W in sorted({1, 2, 3, E, E + 1, T * E // 2 + 1, T * E - 1, T * E}):
        hi, lo = sort_rows(W * 7 + E, 6, W)
        ghi, glo, net = sort_pairs_model(hi, lo, E, ln, T)
        for want in (np_sorted(hi, lo), twin_sorted(hi, lo)):
            np.testing.assert_array_equal(ghi, want[0])
            np.testing.assert_array_equal(glo, want[1])
        if W in (T * E - 1, T * E):
            whi, wlo = jax_sorted(W * 7 + E, 6, W)
            np.testing.assert_array_equal(ghi, whi)
            np.testing.assert_array_equal(glo, wlo)
        if lanes == "small" and W == T * E and T // ln > 1:
            assert net.kinds["smem round trip"] > 0
        assert net.kinds["shuffle"] > 0 or pow2(W) <= E


@pytest.mark.parametrize("W", [1, 2, 31, 100, 128, 1024, 8192, 16384])
def test_k4_model_at_the_kernel_shapes(W):
    """K4's own E and threads (E = 16, 32 at W = 16,384; 32 lanes): the
    widths the card checks; the JAX Pallas sort up to 1,024."""
    hi, lo = sort_rows(W, 3, W)
    ghi, glo, net = sort_pairs_model(hi, lo)
    for want in (np_sorted(hi, lo), twin_sorted(hi, lo)):
        np.testing.assert_array_equal(ghi, want[0])
        np.testing.assert_array_equal(glo, want[1])
    if W <= 1024:
        whi, wlo = jax_sorted(W, 3, W)
        np.testing.assert_array_equal(ghi, whi)
        np.testing.assert_array_equal(glo, wlo)
    Wp = pow2(W)
    n = ilog2(max(Wp, k4_shape(Wp)[0]))
    assert sum(map(len, net.strides)) == n * (n + 1) // 2
    if W == 8192:  # the counts csrc/sort_pairs.cu's note gives
        assert net.kinds == {"register": 56, "shuffle": 35,
                             "smem round trip": 8}


# ------------------------------------------------------------------ K3 --
def k3_shape(Wb: int):
    """dedup.cu launch_dedup: (T, E) of the register route."""
    for limit, T, E in ((2048, 256, 8), (4096, 256, 16), (8192, 256, 32),
                        (16384, 512, 32)):
        if Wb <= limit:
            return T, E
    raise AssertionError("the scratch route")


def dedup_model(kmer: np.ndarray, emit: np.ndarray, hcap: int, min_gap: int,
                T=None, E=None, lanes=LANES):
    """K3 on uint64 kmer [R, L] and bool emit [R, L], row by row, as
    dedup_kernel does it; returns the four outputs of dedup_fused."""
    R, L = kmer.shape
    Wb = sort.dedup_width(L, min_gap)
    if T is None:
        T, E = k3_shape(Wb)
    assert T // lanes <= E and Wb <= T * E
    seg = T * 32 * 4  # kRunWords 32-bit words of positions a thread
    out = np.full((R, hcap), SENT)
    valid = np.zeros((R, hcap), dtype=bool)
    n_unique = np.zeros(R, dtype=np.int32)
    n_emit = np.zeros(R, dtype=np.int32)
    for r in range(R):
        buf = np.full(Wb + Wb // E, SENT)
        written = np.zeros(Wb + Wb // E, dtype=bool)
        n = 0
        for s0 in range(0, L, seg):  # 1. the gather, one pass a segment
            end = min(L, s0 + seg)
            run = ((end - s0 + T - 1) // T + 15) & ~15
            assert run <= 128
            pos = np.flatnonzero(emit[r, s0:end]) + s0
            thread = (pos - s0) // run
            cnt = np.bincount(thread, minlength=T)[:T]
            per_warp = cnt.reshape(-1, min(lanes, T))
            incl = np.cumsum(per_warp, axis=1)  # warp scans
            warp_tot = incl[:, -1]
            before = np.cumsum(warp_tot) - warp_tot
            start = (n + incl - per_warp + before[:, None]).ravel()
            rank = np.arange(pos.size) - np.searchsorted(thread, thread)
            off = start[thread] + rank
            assert (off == n + np.arange(pos.size)).all()  # position order
            keep = off < Wb
            buf[reg_slot(off[keep], E)] = kmer[r, pos[keep]]
            written[reg_slot(off[keep], E)] = True
            n += int(warp_tot.sum())
        m = min(n, Wb)  # 2. the sort of pow2(m) keys on P/E threads
        Ta = max(1, pow2(m) // E)
        assert Ta <= T
        i = np.arange(Ta)[:, None] * E + np.arange(E)[None, :]
        assert written[reg_slot(i[i < m], E)].all()
        k = np.where(i < m, buf[reg_slot(np.minimum(i, Wb - 1), E)], SENT)
        k = Network(k[None], E, lanes).sort().k[0]
        # 3. predecessors: previous register, lane - 1, previous warp
        last = k[:, E - 1]
        up_lane = np.roll(last, 1)  # __shfl_up_sync: lane 0 keeps its own
        warp_last = last.reshape(-1, lanes)[:, -1] if Ta >= lanes else None
        t = np.arange(Ta)
        lane, warp = t & (lanes - 1), t // lanes
        before_k = np.where(lane > 0, up_lane, SENT)
        if warp_last is not None:
            before_k = np.where((lane == 0) & (warp > 0),
                                warp_last[np.maximum(warp - 1, 0)], before_k)
        prev = np.concatenate([before_k[:, None], k[:, :-1]], axis=1)
        ok = (i < m) & ((i == 0) | (k != prev)) & (k != SENT)
        n_unique[r] = ok.sum()
        flat, okf = k.ravel(), ok.ravel()  # 4. hcap slots from registers
        w = min(hcap, Ta * E)
        out[r, :w], valid[r, :w] = flat[:w], okf[:w]
        n_emit[r] = sort.OVERFLOW if n > Wb else n
    return out, valid, n_unique, n_emit


def dedup_rows(seed: int, L: int, counts, min_gap: int):
    return time_sort.emission_rows(np.random.default_rng(seed), L, counts,
                                   min_gap)


def twin_dedup(kmer, emit, hcap, min_gap):
    got = sort.dedup_fused_plain(torch.from_numpy(kmer.view(np.int64)),
                                 torch.from_numpy(emit), hcap, min_gap)
    return (got[0].numpy().view(np.uint64), got[1].numpy(), got[2].numpy(),
            got[3].numpy())


def jax_dedup(kmer, emit, hcap, min_gap):
    """The JAX Pallas dedup in interpret mode on each row's first Wb
    emissions (the TPU kernel sorts every emission: it has no min_gap
    buffer), with the port's n_emit."""
    Wb = sort.dedup_width(kmer.shape[1], min_gap)
    kept = emit & (np.cumsum(emit, axis=1) <= Wb)
    hi = (kmer >> np.uint64(32)).astype(np.uint32)
    lo = (kmer & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    whi, wlo, wv, wnu, wne = (np.asarray(x) for x in jax_dedup_fused(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(kept), hcap,
        interpret=True))
    n = emit.sum(axis=1)
    wne = np.where(n > Wb, sort.OVERFLOW, wne)
    return ((whi.astype(np.uint64) << np.uint64(32)) | wlo, wv, wnu, wne)


def assert_dedup_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L,min_gap", [(2048, 1), (8192, 5), (1024, 5)])
def test_k3_model_emission_counts(L, min_gap):
    """The emission counts of time_sort.emission_counts (m = 0, 1, 31-33,
    32E +- 1, Wb and, where min_gap leaves room, Wb + 1, an overflow) at
    the kernel's T and E, hcap below and above the emissions; against
    the JAX Pallas dedup at L = 1,024."""
    Wb = sort.dedup_width(L, min_gap)
    counts = time_sort.emission_counts(L, min_gap)
    kmer, emit = dedup_rows(L + min_gap, L, counts, min_gap)
    n = emit.sum(axis=1)
    assert (n[:len(counts)] == counts).all() and n.max() <= L
    for hcap in (2048, 100):
        got = dedup_model(kmer, emit, hcap, min_gap)
        want = twin_dedup(kmer, emit, hcap, min_gap)
        assert_dedup_equal(got, want)
        if L <= 1024:
            assert_dedup_equal(got, jax_dedup(kmer, emit, hcap, min_gap))
        assert (got[3][:len(counts)] == np.where(
            n[:len(counts)] > Wb, sort.OVERFLOW, n[:len(counts)])).all()
        assert (got[3] == sort.OVERFLOW).sum() == (Wb < L)
        assert got[2][0] == 0 and not got[1][0].any()
        assert got[2][-2] == 1 and got[2][-1] > 0
        assert not got[1][-1][got[0][-1] == SENT].any()


@pytest.mark.parametrize("T,E", [(4, 2), (8, 4), (32, 8), (32, 2)])
def test_k3_model_small_blocks_reach_every_step(T, E):
    """Small blocks with few lanes a warp: the gather's passes and the
    cross-warp transposes at widths a few keys wide, against the twin
    and the JAX Pallas dedup."""
    lanes = small_lanes(T, E)
    min_gap = 512 // E if T <= 8 else 16  # four gather passes at T <= 8
    L = T * E * min_gap
    Wb = sort.dedup_width(L, min_gap)
    assert Wb == T * E
    kmer, emit = dedup_rows(T * E, L, [0, 1, Wb // 2 + 1, Wb, Wb + 1],
                            min_gap)
    for hcap in (Wb, Wb // 2 + 3):
        want = twin_dedup(kmer, emit, hcap, min_gap)
        got = dedup_model(kmer, emit, hcap, min_gap, T, E, lanes)
        assert_dedup_equal(got, want)
        if L <= 2048:
            assert_dedup_equal(got, jax_dedup(kmer, emit, hcap, min_gap))
        assert got[3][4] == sort.OVERFLOW


def test_k3_model_on_syncmer_reads():
    """The model of K3 on syncmer_track's twin over the tracker's hard
    reads equals the twin and the JAX Pallas dedup."""
    k, s, t, L = 22, 12, 5, 1024
    packed, lengths = dsync.pack_reads(reads(43, L), L)
    kmer, emit = dsync.syncmer_kmers(torch.from_numpy(packed),
                                     torch.from_numpy(lengths), k, s, t)
    gap = dsync.emission_min_gap(k, s, t)
    km, em = kmer.numpy().view(np.uint64), emit.numpy()
    hcap = dsync.hash_cap(L, k, s, t)
    got = dedup_model(km, em, hcap, gap)
    assert_dedup_equal(got, twin_dedup(km, em, hcap, gap))
    assert_dedup_equal(got, jax_dedup(km, em, hcap, gap))
    assert (got[3] > 0).any()
