"""The plain twin of kernel K2 (taxor_tpu_torch.device.probe) against the
JAX package's XLA gather (count_xla), its Pallas probe kernels in
interpret mode and the host IXF oracle.  Invalid slots carry fingerprint
0 and per-bin counts go above 256, the two hazards the TPU kernels
guarded with a poison byte and a sentinel row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.device.pallas_probe import (prepare_fingerprints,
                                           probe_counts_pallas)
from taxor_tpu.device.probe import count_xla
from taxor_tpu.ixf.xor_filter import build_ixf, compute_probes
from taxor_tpu.utils.u64np import fingerprint8, mix_split
from taxor_tpu_torch.device import probe
from taxor_tpu_torch.utils.u64 import split32


def hashes_case(seed, bl, bins, R=4, H=600):
    """A random table with zero columns, keys (read 0: all fingerprint 0,
    so its count in a zero column is its valid-slot count > 256) and a
    mask whose invalid slots include fingerprint-0 keys."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (3 * bl, bins), dtype=np.uint8)
    table[:, ::5] = 0
    ixf_seed = int(rng.integers(0, 2**63))
    pool = rng.integers(0, 2**64, 400_000, dtype=np.uint64)
    zero = pool[fingerprint8(mix_split(pool, ixf_seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = zero[:H]
    mask = rng.random((R, H)) < 0.8
    mask[R - 1] = False
    return table, keys, mask, ixf_seed


def torch_keys(keys):
    hi, lo = split32(torch.from_numpy(keys.view(np.int64)))
    return hi.contiguous(), lo.contiguous()


@pytest.mark.parametrize("bl,bins", [(700, 40), (2500, 130)])
def test_twin_matches_count_xla(bl, bins):
    table, keys, mask, seed = hashes_case(bl, bl, bins)
    R, H = keys.shape
    pos, fpr, _ = compute_probes(keys.reshape(-1), seed, bl)
    fp_pad = probe.pad_fingerprints(table)
    want = np.asarray(count_xla(
        jnp.asarray(fp_pad), jnp.asarray(pos.reshape(R, H, 3)
                                         .astype(np.int32)),
        jnp.asarray(fpr.reshape(R, H)), jnp.asarray(mask)))
    hi, lo = torch_keys(keys)
    got = probe.probe_counts(hi, lo, torch.from_numpy(mask),
                             torch.from_numpy(fp_pad), seed, bl).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].max() > 256 and (got[R - 1] == 0).all()
    # count_plain is the same gather on given positions
    plain = probe.count_plain(
        torch.from_numpy(fp_pad), torch.from_numpy(pos.reshape(R, H, 3)),
        torch.from_numpy(fpr.reshape(R, H)), torch.from_numpy(mask),
        budget=1 << 16).numpy()
    np.testing.assert_array_equal(plain, want)


@pytest.mark.parametrize("bl,bins", [(900, 100), (1500, 600)])
def test_twin_matches_pallas_interpret(bl, bins):
    """bins=100 is the replicated-row geometry (B/4 <= 128) of the
    disabled _kernel_repl; bins=600 the p16 one."""
    table, keys, mask, seed = hashes_case(bins, bl, bins, R=3, H=320)
    R, H = keys.shape
    pos, fpr, _ = compute_probes(keys.reshape(-1), seed, bl)
    want = np.asarray(probe_counts_pallas(
        jnp.asarray(prepare_fingerprints(table)),
        pos.reshape(R, H, 3), fpr.reshape(R, H), mask, interpret=True))
    hi, lo = torch_keys(keys)
    got = probe.probe_counts(hi, lo, torch.from_numpy(mask),
                             torch.from_numpy(probe.pad_fingerprints(table)),
                             seed, bl).numpy()
    np.testing.assert_array_equal(got[:, :bins], want[:, :bins])
    assert got[0].max() > 256


def test_twin_matches_host_ixf_oracle():
    rng = np.random.default_rng(3)
    bins = [rng.integers(0, 2**64, 300, dtype=np.uint64) for _ in range(9)]
    ixf = build_ixf(bins, max_elements_per_bin=300)
    reads = [np.unique(np.concatenate([bins[r][:50 * (r + 1)],
                                       rng.integers(0, 2**64, 40,
                                                    dtype=np.uint64)]))
             for r in range(5)]
    Hpad = 512
    hi, lo, valid = probe.pack_hash_lists(reads, Hpad)
    got = probe.probe_counts(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid),
        torch.from_numpy(probe.pad_fingerprints(ixf.fingerprints)),
        ixf.seed, ixf.block_length).numpy()
    for r, keys in enumerate(reads):
        np.testing.assert_array_equal(got[r, :ixf.bin_count],
                                      ixf.bulk_count(keys))
        assert got[r, r] >= 50 * (r + 1)


def test_pack_hash_lists_layout():
    h = [np.array([0x0123456789ABCDEF, 2**64 - 1], dtype=np.uint64),
         np.zeros(0, dtype=np.uint64)]
    hi, lo, valid = probe.pack_hash_lists(h, 4)
    assert hi.dtype == lo.dtype == np.int32 and hi.shape == (2, 4)
    assert hi.view(np.uint32)[0, 0] == 0x01234567
    assert lo.view(np.uint32)[0, 0] == 0x89ABCDEF
    assert hi[0, 1] == -1 and lo[0, 1] == -1
    np.testing.assert_array_equal(valid, [[1, 1, 0, 0], [0, 0, 0, 0]])


def test_pad_fingerprints():
    fp = np.arange(12, dtype=np.uint8).reshape(3, 4)
    out = probe.pad_fingerprints(fp)
    assert out.shape == (3, probe.LANE)
    np.testing.assert_array_equal(out[:, :4], fp)
    assert (out[:, 4:] == 0).all()
    wide = np.ones((2, 4 * probe.LANE), dtype=np.uint8)
    assert probe.pad_fingerprints(wide).shape == wide.shape


def test_wrapper_refuses_other_devices():
    z = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    table = torch.zeros((30, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probe.probe_counts(z, z, z.bool(), table, 1, 10)


# ------------------------------------------- K2's slab route, modelled --
SMEM_OPTIN = 232_448  # the H100's shared memory a block (opt-in)
FLUSH = 255  # kFlush of csrc/probe_slab.cu


def model_slab_bins(S, Bpad, smem=SMEM_OPTIN):
    """probe_slab_bins of csrc/probe_slab.cu: the widest of 128, 64, 32,
    16 bins (no wider than Bpad needs) whose [S, b] slab fits; 0 = rows."""
    if not 0 < S < 65536 or Bpad % 16:
        return 0
    b = 128
    while b > 16 and b // 2 >= Bpad:
        b //= 2
    while b >= 16:
        if S * b <= smem:
            return b
        b //= 2
    return 0


def zero_bytes(x):
    """zero_bytes of csrc/probe_slab.cu: 1 in each zero byte of x."""
    low7, sign = np.uint32(0x7F7F7F7F), np.uint32(0x80808080)
    return (~(((x & low7) + low7) | x) & sign) >> np.uint32(7)


def slab_model(keys, valid, tables, active, seed, bl, b, reads_per_block):
    """numpy transcription of csrc/probe_slab.cu with slabs of b bins:
    records with u16 positions (probe_records_kernel), then per (slab,
    read group, g) block a warp a read, lane = hash-lane x CH + chunk,
    zero bytes of the XOR added into packed byte counters flushed every
    FLUSH records of a lane, and the hash-lanes summed by an xor
    butterfly.  Returns the counts and the
    most records any lane counted between two flushes' starts."""
    G, S, Bp = tables.shape
    R, H = keys.shape
    CH, HL = b // 16, 32 // (b // 16)
    pos, fpr, _ = compute_probes(keys.reshape(-1), seed, bl)
    pos, fpr = pos.reshape(R, H, 3), fpr.reshape(R, H)
    rec = np.zeros((R, H), dtype=np.uint64)
    nrec = valid.sum(axis=1)
    for r in range(R):
        p, f = pos[r][valid[r]].astype(np.uint64), fpr[r][valid[r]]
        assert p.max(initial=0) < 2**16
        rec[r, :nrec[r]] = (p[:, 0] | p[:, 1] << np.uint64(16)
                            | p[:, 2] << np.uint64(32)
                            | f.astype(np.uint64) << np.uint64(48))
    out = np.full((G, R, Bp), -1, dtype=np.int64)
    most = 0
    for g in range(G):
        for s0 in range(0, Bp, b):
            nch = min(CH, (Bp - s0) // 16)
            slab = np.zeros((S, b), dtype=np.uint8)  # ragged: unused chunks
            slab[:, :16 * nch] = tables[g, :, s0:s0 + 16 * nch]
            words = slab.view(np.uint32).reshape(S, CH, 4)
            for r0 in range(0, R, reads_per_block):  # the read groups
                for r in range(r0, min(R, r0 + reads_per_block)):
                    if active is not None and not active[g, r]:
                        out[g, r, s0:s0 + 16 * nch] = 0
                        continue
                    q = rec[r, :nrec[r]]
                    p = [((q >> np.uint64(16 * i)) & np.uint64(0xFFFF))
                         .astype(np.int64) for i in range(3)]
                    f4 = ((q >> np.uint64(48)).astype(np.uint32)
                          * np.uint32(0x01010101))
                    x = words[p[0]] ^ words[p[1]] ^ words[p[2]]
                    hits = zero_bytes(x ^ f4[:, None, None])  # [n, CH, 4]
                    cnt = np.zeros((HL, CH, 16), dtype=np.int64)
                    for hl in range(HL):
                        mine = hits[hl::HL]
                        for e0 in range(0, mine.shape[0], FLUSH):
                            k = mine[e0:e0 + FLUSH].sum(axis=0,
                                                        dtype=np.uint32)
                            most = max(most, min(FLUSH, mine.shape[0] - e0))
                            cnt[hl] += k.view(np.uint8).reshape(
                                CH, 16).astype(np.int64)
                    m = 1
                    while m < HL:  # __shfl_xor_sync over the hash-lanes
                        cnt = cnt + cnt[np.arange(HL) ^ m]
                        m *= 2
                    out[g, r, s0:s0 + 16 * nch] = cnt[0, :nch].reshape(-1)
    assert (out >= 0).all()
    return out.astype(np.int32), most


def xla_counts(table, keys, mask, seed, bl):
    R, H = keys.shape
    pos, fpr, _ = compute_probes(keys.reshape(-1), seed, bl)
    return np.asarray(count_xla(
        jnp.asarray(table), jnp.asarray(pos.reshape(R, H, 3)
                                        .astype(np.int32)),
        jnp.asarray(fpr.reshape(R, H)), jnp.asarray(mask)))


@pytest.mark.parametrize("S,Bpad,b", [
    (3609, 4096, 64), (3000, 1008, 64), (15000, 2000, 0), (6000, 5008, 32),
    (9000, 4096, 16), (10554, 512, 16), (402, 16384, 128), (2418, 512, 64),
    (900, 112, 128), (900, 48, 64), (100, 16, 16), (66000, 4096, 0)])
def test_slab_width_rule(S, Bpad, b):
    """The slab widths of chip_smoke's and bench_probe's geometries."""
    assert model_slab_bins(S, Bpad) == b


@pytest.mark.parametrize("bl,bins,b,H,G,rpb", [
    (300, 1000, 128, 1100, 1, 3),  # ragged last slab, flush, read groups
    (700, 100, 32, 600, 1, 4),     # ragged last slab of 16 bins
    (500, 200, 16, 500, 2, 2),     # G = 2 with an activity mask
    (400, 300, 64, 2100, 2, 4)])   # the flush at b = 64
def test_slab_model_matches_count_xla(bl, bins, b, H, G, rpb):
    table, keys, mask, seed = hashes_case(bl + b, bl, bins, R=4, H=300)
    rng = np.random.default_rng(bins)
    keys = rng.integers(0, 2**64, (4, H), dtype=np.uint64)
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    keys[0] = pool[fingerprint8(mix_split(pool, seed)) == 0][:H]
    mask = rng.random((4, H)) < 0.8
    mask[0], mask[3] = True, False  # read 0: H fingerprint-0 hashes
    Bp = probe.pad_bins(bins)
    tables = np.stack([probe.pad_fingerprints(table)] + [
        probe.pad_fingerprints(np.where(rng.random(table.shape) < 0.5,
                                        table, 0).astype(np.uint8))
        for _ in range(G - 1)])
    active = None
    if G > 1:
        active = np.array([[True, True, False, True],
                           [True, False, False, True]])
    got, most = slab_model(keys, mask, tables, active, seed, bl, b, rpb)
    want = np.stack([xla_counts(t, keys, mask, seed, bl) for t in tables])
    if active is not None:
        want = want * active[:, :, None]
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].max() > 256 and (got[:, 3] == 0).all()
    assert (Bp % b != 0) == (b > 16)  # a ragged last slab but at b = 16
    if H // (32 // (b // 16)) > FLUSH:
        assert most == FLUSH  # a lane flushed mid-read
    # the twin of the port computes the same
    hi, lo = torch_keys(keys)
    twin = probe.probe_counts_grouped_plain(
        hi, lo, torch.from_numpy(mask), torch.from_numpy(tables),
        None if active is None else torch.from_numpy(active), seed, bl)
    np.testing.assert_array_equal(twin.numpy(), got)


def test_slab_model_matches_pallas_interpret():
    """The p16 geometry of test_twin_matches_pallas_interpret through
    slabs of 64 bins (9.5 slabs: a ragged last one)."""
    bl, bins = 900, 600
    table, keys, mask, seed = hashes_case(bins, bl, bins, R=3, H=320)
    mask[0] = True  # 320 fingerprint-0 hashes: counts above 256
    R, H = keys.shape
    pos, fpr, _ = compute_probes(keys.reshape(-1), seed, bl)
    want = np.asarray(probe_counts_pallas(
        jnp.asarray(prepare_fingerprints(table)),
        pos.reshape(R, H, 3), fpr.reshape(R, H), mask, interpret=True))
    tables = probe.pad_fingerprints(table)[None]
    got, _ = slab_model(keys, mask, tables, None, seed, bl, 64, 2)
    np.testing.assert_array_equal(got[0, :, :bins], want[:, :bins])
    assert got[0, 0].max() > 256 and (got[0, 2] == 0).all()


# -------------------------------------------------- K2n's schedule, modelled --
# kThreads, kWarps, kTile and the control words of csrc/probe_narrow.cu
THREADS, WARPS, TILE, CTRL = 256, 8, 1024, 4 * (8 + 256)


def align16(x):
    return -(-x // 16) * 16


def model_narrow_mode(S, Bpad, smem=SMEM_OPTIN):
    """probe_narrow_mode of csrc/probe_narrow.cu: "smem" where the whole
    table, the control words and every warp's scratch (32 staged probes
    of 16 bytes and a prefix of Bpad + 1 ints) fit one block."""
    if S <= 0 or not 0 < Bpad <= 512 or Bpad % 16:
        return "rows"
    need = (align16(S * Bpad) + CTRL
            + WARPS * (32 * 16 + align16(4 * (Bpad + 1))))
    return "smem" if need <= smem else "rows"


def log2_ceil(x):
    return (x - 1).bit_length()


def smem_read_model(words, pos, fpr, valid_r):
    """The block's read in smem mode: warp w takes the rounds w, w +
    WARPS, ... of 32 slots, each compacted by ballot; in a warp, lane =
    hash-lane x CHp + chunk, zero bytes into packed byte counters flushed
    when the warp's next round could pass 255, the hash-lanes summed by
    an xor butterfly; the warps' counts summed in shared memory.  Returns
    (counts [Bpad], the most hashes a lane counted between flushes)."""
    CH = words.shape[1]
    HL = 32 >> log2_ceil(CH)
    H = valid_r.shape[0]
    total = np.zeros(CH * 16, dtype=np.int64)
    most = 0
    for warp in range(WARPS):
        cnt = np.zeros((HL, CH, 16), dtype=np.int64)
        k = np.zeros((HL, CH, 4), dtype=np.uint32)
        took = np.zeros(HL, dtype=np.int64)  # hashes a lane counted
        m = 0

        def flush():
            nonlocal most
            most = max(most, int(took.max()))
            assert took.max() <= FLUSH  # no byte counter wrapped
            cnt[...] += k.view(np.uint8).reshape(HL, CH, 16)
            k[...] = 0
            took[...] = 0

        for h0 in range(32 * warp, H, 32 * WARPS):
            idx = h0 + np.flatnonzero(valid_r[h0:h0 + 32])  # slot order
            n = idx.shape[0]
            p = pos[idx]
            f4 = fpr[idx].astype(np.uint32) * np.uint32(0x01010101)
            x = words[p[:, 0]] ^ words[p[:, 1]] ^ words[p[:, 2]]
            z = zero_bytes(x ^ f4[:, None, None])  # [n, CH, 4]
            for hl in range(HL):
                k[hl] += z[hl::HL].sum(axis=0, dtype=np.uint32)
                took[hl] += z[hl::HL].shape[0]
            m += -(-n // HL)
            if m > FLUSH - 32:
                flush()
                m = 0
        flush()
        b = 1
        while b < HL:  # __shfl_xor_sync over the hash-lanes
            cnt = cnt + cnt[np.arange(HL) ^ b]
            b *= 2
        total += cnt[0].reshape(-1)
    return total, most


def rows_read_model(words, pos, fpr, valid_r):
    """The block's read in rows mode: stage_probes' tiles of at most
    TILE valid hashes, HL hash-lanes x WL word-lanes of 4 bins, int32
    counts summed over the hash-lanes."""
    S, B4 = words.shape
    HL = THREADS >> log2_ceil(B4)
    H = valid_r.shape[0]
    c = np.zeros((HL, B4, 4), dtype=np.int64)
    h = 0
    while h < H:
        staged = []
        while h < H and len(staged) + THREADS <= TILE:
            staged += list(h + np.flatnonzero(valid_r[h:h + THREADS]))
            h += THREADS
        staged = np.array(staged, dtype=np.int64)
        for lane in range(HL):
            e = staged[lane::HL]
            f4 = fpr[e].astype(np.uint32) * np.uint32(0x01010101)
            x = (words[pos[e, 0]] ^ words[pos[e, 1]] ^ words[pos[e, 2]]
                 ^ f4[:, None])
            c[lane] += (x.view(np.uint8).reshape(-1, B4, 4) == 0).sum(0)
    return c.sum(axis=0).reshape(-1), 0


def narrow_model(keys, valid, tables, active, seed, bl, runs, mode,
                 reads_per_block):
    """numpy transcription of csrc/probe_narrow.cu: blocks over (subgroup,
    chunk of reads_per_block reads), rounds of THREADS reads whose active
    reads the warp ballots compact into a list in read order, zeros for
    the inactive reads, each active read probed (smem or rows mode), its
    exclusive prefix over the bins and the run sums P[e] - P[s] of the
    subgroup's runs [run_off[g], run_off[g + 1]).  runs None: one-bin
    runs, the dense [G, R, Bpad] counts.  Returns (out, the most hashes a
    lane counted between flushes)."""
    G, S, Bp = tables.shape
    R, H = keys.shape
    pos, fpr, _ = compute_probes(keys.reshape(-1), seed, bl)
    pos = pos.reshape(R, H, 3).astype(np.int64)
    fpr = fpr.reshape(R, H)
    if runs is None:
        run_off = np.arange(G + 1) * Bp
        run_s = np.tile(np.arange(Bp), G)
        run_e = run_s + 1
    else:
        run_off, run_s, run_e = runs
    read = smem_read_model if mode == "smem" else rows_read_model
    out = np.full((run_off[-1], R), -1, dtype=np.int64)
    most = 0
    for g in range(G):
        j0, j1 = run_off[g], run_off[g + 1]
        s, e = run_s[j0:j1], run_e[j0:j1]
        words = tables[g].view(np.uint32).reshape(
            (S, Bp // 16, 4) if mode == "smem" else (S, Bp // 4))
        for r0 in range(0, R, reads_per_block):
            r1 = min(R, r0 + reads_per_block)
            for base in range(r0, r1, THREADS):
                n = min(THREADS, r1 - base)
                a = np.ones(n, dtype=bool) if active is None \
                    else active[g, base:base + n]
                ballots = [sum(1 << lane for lane in range(32)
                               if w * 32 + lane < n and a[w * 32 + lane])
                           for w in range(WARPS)]
                listed = [base + 32 * w + lane for w in range(WARPS)
                          for lane in range(32) if ballots[w] >> lane & 1]
                assert listed == list(base + np.flatnonzero(a))
                assert (out[j0:j1, base:base + n][:, ~a] == -1).all()
                out[j0:j1, base + np.flatnonzero(~a)] = 0
                for r in listed:
                    counts, m = read(words, pos[r], fpr[r], valid[r])
                    most = max(most, m)
                    P = np.concatenate([[0], np.cumsum(counts)])
                    assert (out[j0:j1, r] == -1).all()
                    out[j0:j1, r] = P[e] - P[s]
    assert (out >= 0).all()  # every (run, read) written once
    out = out.astype(np.int32)
    if runs is None:
        out = out.reshape(G, Bp, R).transpose(0, 2, 1)
    return out, most


def onehot_runs(Bp, run_s, run_e):
    """The JAX package's one-hot run matrix float32 [Bpad, n_runs]
    (taxor_tpu/device/hixf_search.py: onehot[s:e, r] = 1)."""
    oh = np.zeros((Bp, run_s.shape[0]), dtype=np.float32)
    for r, (s, e) in enumerate(zip(run_s, run_e)):
        oh[s:e, r] = 1.0
    return oh


def jax_run_sums(tables, keys, valid, active, runs, seed, bl):
    """The JAX composite for a stacked group: per subgroup count_xla under
    its activity mask, times its one-hot run matrix (float64, exact)."""
    run_off, run_s, run_e = runs
    out = []
    for g in range(tables.shape[0]):
        j = slice(run_off[g], run_off[g + 1])
        counts = xla_counts(tables[g], keys, valid & active[g][:, None],
                            seed, bl)
        oh = onehot_runs(tables.shape[2], run_s[j], run_e[j])
        out.append((counts.astype(np.float64) @ oh).T)
    return np.concatenate(out).astype(np.int32)


def random_runs(rng, G, Bp, bins):
    """A CSR of runs over G subgroups of `bins` real columns: one-bin
    runs, runs over many bins with gaps between them, subgroup 1 one run
    over all of its bins, subgroup 2 (where there is one) none."""
    offs, starts, ends = [0], [], []
    for g in range(G):
        if g == 1:
            starts.append(0)
            ends.append(bins)
        elif g != 2:
            col = 0
            while col < bins:
                w = int(rng.choice([1, 1, 2, 3, 7, 40]))
                e = min(bins, col + w)
                starts.append(col)
                ends.append(e)
                col = e + int(rng.integers(0, 3))  # gaps: unused columns
        offs.append(len(starts))
    return (np.array(offs, dtype=np.int64), np.array(starts, dtype=np.int64),
            np.array(ends, dtype=np.int64))


def narrow_case(bins, G=4, R=40, H=320, bl=70, seed=0):
    """Subgroup tables with zero columns; read 0 all fingerprint 0 (run
    sums above 256), read R-1 all invalid; subgroup 0 all active,
    subgroup 1 active on read 0 only, subgroup 2 never, the rest ~50%."""
    rng = np.random.default_rng(bins + seed)
    Bp = probe.pad_bins(bins)
    tables = np.zeros((G, 3 * bl, Bp), dtype=np.uint8)
    tables[:, :, :bins] = rng.integers(0, 256, (G, 3 * bl, bins))
    tables[:, :, ::5] = 0
    ixf_seed = int(rng.integers(0, 2**63))
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    zero = pool[fingerprint8(mix_split(pool, ixf_seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = zero[:H]
    valid = rng.random((R, H)) < 0.8
    valid[0], valid[R - 1] = True, False
    active = rng.random((G, R)) < 0.5
    active[0] = True
    active[1:3] = False
    active[1:2, 0] = True
    return tables, keys, valid, active, ixf_seed, bl, rng


@pytest.mark.parametrize("S,Bpad,mode", [
    (216, 512, "smem"), (411, 512, "smem"), (412, 512, "rows"),
    (10548, 512, "rows"), (497625, 64, "rows"), (2418, 256, "rows"),
    (3000, 64, "smem"), (14000, 16, "smem"), (14400, 16, "rows"),
    (600, 112, "smem"), (216, 100, "rows"), (216, 1024, "rows")])
def test_narrow_mode_rule(S, Bpad, mode):
    """The widest descent group's tables (216 x 512) fit a block with
    the scratch; the [8, 10548, 512] level, the 64-bin root and
    viral_flat_256's [2418, 256] table do not."""
    assert model_narrow_mode(S, Bpad) == mode


@pytest.mark.parametrize("mode", ["smem", "rows"])
@pytest.mark.parametrize("bins,rpb,H", [(16, 40, 320), (100, 16, 320),
                                        (512, 24, 2304)])
def test_narrow_model_matches_count_xla_run_matrix(bins, rpb, H, mode):
    """The schedule, run sums and dense counts, against count_xla per
    subgroup times the one-hot run matrix, and the port's twins.  At 512
    bins read 0's 2,304 valid slots give each warp 288 hashes, so its
    byte counters flush mid-read."""
    tables, keys, valid, active, seed, bl, rng = narrow_case(bins, H=H)
    G, _, Bp = tables.shape
    runs = random_runs(rng, G, Bp, bins)
    got, most = narrow_model(keys, valid, tables, active, seed, bl, runs,
                             mode, rpb)
    want = jax_run_sums(tables, keys, valid, active, runs, seed, bl)
    np.testing.assert_array_equal(got, want)
    j = slice(runs[0][1], runs[0][2])  # subgroup 1: one run of every bin
    assert got[j, 0].max() > 256 and (got[:, -1] == 0).all()
    assert (got[runs[0][1]:runs[0][2], 1:] == 0).all()
    assert runs[0][3] == runs[0][2]  # subgroup 2 has no run
    if mode == "smem" and bins == 512:
        assert most > FLUSH - 32  # a lane flushed mid-read
    # the dense counts: the same schedule's one-bin runs
    dense, _ = narrow_model(keys, valid, tables, active, seed, bl, None,
                            mode, rpb)
    want = np.stack([xla_counts(t, keys, valid & a[:, None], seed, bl)
                     for t, a in zip(tables, active)])
    np.testing.assert_array_equal(dense, want)
    # the twins of the port compute the same
    hi, lo = torch_keys(keys)
    args = (hi, lo, torch.from_numpy(valid), torch.from_numpy(tables),
            torch.from_numpy(active))
    tr = [torch.from_numpy(x) for x in runs]
    np.testing.assert_array_equal(
        probe.probe_run_sums_grouped(*args, *tr, seed, bl).numpy(), got)
    np.testing.assert_array_equal(
        probe.probe_counts_grouped(*args, seed, bl).numpy(), dense)


def test_narrow_model_matches_kernel_repl():
    """The schedule's dense counts at bins=100 (B4 = 25, no power of two)
    against the TPU's replicated-row kernel in interpret mode, switched on
    for the test."""
    from taxor_tpu.device import pallas_probe as pp

    tables, keys, valid, active, seed, bl, _ = narrow_case(100, G=1, R=16)
    R, H = keys.shape
    m = valid & active[0][:, None]
    fp_packed = pp.prepare_fingerprints(tables[0][:, :100], lane=4)
    S1, B4 = fp_packed.shape
    assert pp._repl_eligible(S1, B4)
    pos, fpr, _ = compute_probes(keys.reshape(-1), seed, bl)
    pos = np.where(m[..., None], pos.reshape(R, H, 3), S1 - 1)
    f4 = np.where(m, fpr.reshape(R, H).astype(np.uint32), 1) * np.uint32(
        0x01010101)
    saved = pp.USE_REPL_PROBE
    pp.USE_REPL_PROBE = True
    try:
        want = np.asarray(pp._probe_call_chunked(
            jnp.asarray(fp_packed), jnp.asarray(pos.astype(np.int32)),
            jnp.asarray(f4.astype(np.uint32).view(np.int32)),
            jnp.asarray(m), B4, True))
    finally:
        pp.USE_REPL_PROBE = saved
    for mode in ("smem", "rows"):
        got, _ = narrow_model(keys, valid, tables, active, seed, bl, None,
                              mode, 16)
        np.testing.assert_array_equal(got[0, :, :100], want[:, :100])
    assert got[0, 0].max() > 256


def test_run_sums_twin_is_the_dense_composition():
    """probe_run_sums_grouped_plain == segment_sums of the dense twin,
    int32 [n_runs, R]; an empty CSR gives [0, R]."""
    tables, keys, valid, active, seed, bl, rng = narrow_case(64, R=6, H=200)
    runs = [torch.from_numpy(x)
            for x in random_runs(rng, tables.shape[0], 64, 64)]
    hi, lo = torch_keys(keys)
    args = (hi, lo, torch.from_numpy(valid), torch.from_numpy(tables),
            torch.from_numpy(active))
    got = probe.probe_run_sums_grouped(*args, *runs, seed, bl)
    dense = probe.probe_counts_grouped(*args, seed, bl)
    want = probe.segment_sums(dense, probe.run_groups(runs[0]), runs[1],
                              runs[2])
    assert got.dtype == torch.int32 and got.shape == (runs[1].shape[0], 6)
    assert torch.equal(got, want)
    empty = torch.zeros(tables.shape[0] + 1, dtype=torch.int64)
    none = torch.zeros(0, dtype=torch.int64)
    assert probe.probe_run_sums_grouped(*args, empty, none, none, seed,
                                        bl).shape == (0, 6)


@pytest.mark.parametrize("mode", ["smem", "rows"])
def test_narrow_model_rounds(mode):
    """A chunk of 300 reads walks two rounds of THREADS reads (256, then
    44), each with its own ballots, list and zeros."""
    tables, keys, valid, active, seed, bl, rng = narrow_case(48, G=3, R=300,
                                                             H=64)
    runs = random_runs(rng, 3, 48, 48)
    got, _ = narrow_model(keys, valid, tables, active, seed, bl, runs, mode,
                          300)
    np.testing.assert_array_equal(
        got, jax_run_sums(tables, keys, valid, active, runs, seed, bl))
    assert (got[:, 256:] != 0).any() and (got[:, ~active.any(0)] == 0).all()
