"""The split-extraction engine's kernels on the CPU: the plain twins of K3
(device/sort.dedup_fused) and K4 (device/sort.sort_pairs) against the
JAX package's Pallas ``dedup_fused`` and ``sort_pairs`` in interpret
mode, the plain ``dedup_kmers``, ``dedup_pairs`` and ``dedup_fused``
against each other, and the split engine's extraction against K1's twin.  Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.device.pallas_sort import sort_pairs as jax_sort_pairs
from taxor_tpu.hash import device_syncmer as jdsync
from taxor_tpu_torch.device import e2e, extract, sort
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.utils.u64 import join32

from .test_torch_extract import reads

SENT32 = np.uint32(0xFFFFFFFF)


def kmer_rows(seed, R, L, min_gap, dup_vals=False):
    """Random k-mer rows with repeats and an emission mask whose
    emissions are at least min_gap apart: (khi, klo uint32, emit)."""
    rng = np.random.default_rng(seed)
    khi = rng.integers(0, 1 << 12, (R, L), dtype=np.uint32)
    klo = rng.integers(0, 8 if dup_vals else 1 << 32, (R, L),
                       dtype=np.uint32)
    khi[:, L // 4:L // 2] = khi[:, :L // 4]  # repeats within a read
    klo[:, L // 4:L // 2] = klo[:, :L // 4]
    if min_gap == 1:
        emit = rng.random((R, L)) < 0.2
    else:
        emit = np.zeros((R, L), dtype=bool)
        cols = np.arange(0, L, min_gap)
        emit[:, cols] = rng.random((R, cols.size)) < 0.9
    emit[0] = False  # a row with no emission
    return khi, klo, emit


def as_int64(khi, klo):
    return join32(torch.from_numpy(khi.view(np.int32)),
                  torch.from_numpy(klo.view(np.int32)))


def to_pairs(kmer):
    k = kmer.numpy().view(np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("R,L,hcap,min_gap,dups", [
    (16, 256, 128, 1, True), (16, 256, 32, 1, True), (8, 512, 512, 1, True),
    (12, 384, 512, 1, False), (16, 512, 128, 6, False),
    (8, 512, 64, 5, True)])
def test_dedup_twin_matches_pallas_dedup_fused(R, L, hcap, min_gap, dups):
    """hcap below and above the emission count, a width that is not a
    power of two, a row with no emission, many duplicates."""
    khi, klo, emit = kmer_rows(R * L + hcap, R, L, min_gap, dups)
    want = jdsync.dedup_kmers(jnp.asarray(khi), jnp.asarray(klo),
                              jnp.asarray(emit), hcap, min_gap,
                              sort_impl="fused_interpret")
    want = [np.asarray(x) for x in want]
    srt, valid, nu, ne = sort.dedup_fused(as_int64(khi, klo),
                                          torch.from_numpy(emit), hcap,
                                          min_gap)
    hi, lo = to_pairs(srt)
    np.testing.assert_array_equal(hi, want[0])
    np.testing.assert_array_equal(lo, want[1])
    np.testing.assert_array_equal(valid.numpy(), want[2])
    np.testing.assert_array_equal(nu.numpy(), want[3])
    np.testing.assert_array_equal(ne.numpy(), want[4])
    assert ne[0] == 0 and nu[0] == 0 and not valid[0].any()


def _sort_case(case):
    rng = np.random.default_rng(len(case))
    if case == "dups_and_sentinels":
        vals = rng.integers(0, 8, (8, 256), dtype=np.uint32)
        hi = np.where(vals < 6, vals, SENT32)
        lo = np.where(vals < 6, vals * 3, SENT32)
        return hi, lo
    if case == "hi_dominates":
        return (np.array([[2, 1, 1, 0]], dtype=np.uint32),
                np.array([[0, 5, 1, 9]], dtype=np.uint32))
    R, W = {"8x128": (8, 128), "16x256": (16, 256), "8x512": (8, 512),
            "8x384": (8, 384), "9x128": (9, 128)}[case]
    return (rng.integers(0, 1 << 12, (R, W), dtype=np.uint32),
            rng.integers(0, 1 << 32, (R, W), dtype=np.uint32))


@pytest.mark.parametrize("case", ["8x128", "16x256", "8x512", "8x384",
                                  "9x128", "dups_and_sentinels",
                                  "hi_dominates"])
def test_sort_pairs_twin_matches_pallas_sort_pairs(case):
    hi, lo = _sort_case(case)
    whi, wlo = jax_sort_pairs(jnp.asarray(hi), jnp.asarray(lo),
                              interpret=True)
    ghi, glo = sort.sort_pairs(torch.from_numpy(hi.view(np.int32)),
                               torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(ghi.numpy().view(np.uint32),
                                  np.asarray(whi))
    np.testing.assert_array_equal(glo.numpy().view(np.uint32),
                                  np.asarray(wlo))


@pytest.mark.parametrize("hcap,min_gap", [(128, 1), (600, 1), (128, 6)])
def test_dedup_kmers_routes_agree(hcap, min_gap):
    """The plain ``dedup_kmers``, ``dedup_pairs`` (K4's twin) and
    ``dedup_fused`` (K3's twin) give the same four outputs, and equal the
    JAX package's XLA route."""
    khi, klo, emit = kmer_rows(hcap + min_gap, 12, 512, min_gap, True)
    kmer, em = as_int64(khi, klo), torch.from_numpy(emit)
    outs = [dsync.dedup_kmers(kmer, em, hcap),
            sort.dedup_pairs(kmer, em, hcap),
            sort.dedup_fused(kmer, em, hcap, min_gap)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    want = [np.asarray(x) for x in jdsync.dedup_kmers(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(emit), hcap,
        min_gap, sort_impl="xla")]
    hi, lo = to_pairs(outs[0][0])
    np.testing.assert_array_equal(hi, want[0])
    np.testing.assert_array_equal(lo, want[1])
    for a, b in zip(outs[0][1:], want[2:]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_dedup_min_gap_overflow_reports_sentinel_count():
    """A row with more emissions than the min_gap bound allows reports
    n_emit == 2**30 (the host-oracle fallback), the others their
    count."""
    R, L, gap = 4, 256, 5
    rng = np.random.default_rng(9)
    kmer = torch.from_numpy(rng.integers(0, 2**62, (R, L)))
    emit = torch.zeros((R, L), dtype=torch.bool)
    emit[:, ::gap] = True
    emit[1, 1::gap] = True  # breaks the gap: twice the bound
    Wb = sort.dedup_width(L, gap)
    _, valid, nu, ne = sort.dedup_fused(kmer, emit, 64, gap)
    assert ne.tolist() == [52, sort.OVERFLOW, 52, 52]
    assert Wb == 64 and int(nu[1]) == Wb  # the first Wb emissions
    assert valid[1].all() and valid.sum(dim=1).tolist() == [52, 64, 52, 52]


def test_split_extraction_equals_k1(monkeypatch):
    """syncmer_track -> dedup_fused -> wyhash (the split engine) gives
    K1's five outputs on the tracker's hard reads."""
    k, s, t, L = 22, 12, 5, 512
    packed, lengths = dsync.pack_reads(reads(41, L), L)
    pk, ln = torch.from_numpy(packed), torch.from_numpy(lengths)
    hcap = dsync.hash_cap(L)
    want = extract.syncmer_hashes(pk, ln, k, s, t, hcap)
    monkeypatch.setattr(e2e, "USE_FUSED_EXTRACT", False)
    got = e2e._syncmer_hashes(pk, ln, k, s, t, hcap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    kmer, emit = extract.syncmer_track(pk, ln, k, s, t)
    assert kmer.dtype == torch.int64 and emit.shape == (len(packed), L)
    assert not emit[:, int(lengths.max()):].any()


def test_wrappers_refuse_other_devices():
    z = torch.zeros((2, 64), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sort.dedup_fused(z, z.bool(), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        sort.sort_pairs(z.int(), z.int())
    with pytest.raises(ValueError, match="unsupported device"):
        extract.syncmer_track(z.to(torch.uint8), z[:, 0].int(), 22, 12, 5)
