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
