"""The CUDA kernels K1, K2, K2n, syncmer_track, K3 and K4 and the steps
on the card, held bit-exact to their plain twins.  Needs a CUDA GPU and
nvcc; skips elsewhere.  This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from taxor_tpu_torch.device import e2e, extract, probe, sort
from taxor_tpu_torch.device.e2e import fused_e2e_step
from taxor_tpu_torch.hash import device_syncmer as dsync

pytestmark = pytest.mark.gpu

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def reads(rng, L, n=12):
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(L // 2, L + 1)))]
            .tobytes() for _ in range(n)]
    arr = ACGT[rng.integers(0, 4, L)].copy()
    arr[10:60] = ord("A")
    arr[rng.integers(0, L, L // 40)] = ord("N")
    return seqs + [arr.tobytes(), (b"ACGTTG" * L)[:L], b"", b"ACGT" * 5]


@pytest.mark.parametrize("L,k,s,t", [(256, 22, 12, 5), (4096, 22, 12, 5),
                                     (32768, 22, 12, 5), (2048, 16, 8, 4),
                                     (32768, 14, 12, 1)])
def test_k1_matches_twin(cuda, L, k, s, t):
    rng = np.random.default_rng(L + k)
    packed, lengths = dsync.pack_reads(reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    hcap = dsync.hash_cap(L)
    before = extract.syncmer_hashes.LAUNCHES
    got = extract.syncmer_hashes(pk, ln, k, s, t, hcap)
    want = extract.syncmer_hashes_plain(pk, ln, k, s, t, hcap)
    torch.cuda.synchronize()
    assert extract.syncmer_hashes.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.parametrize("L,k,s,t", [(256, 22, 12, 5), (4096, 22, 12, 5),
                                     (32768, 22, 12, 5), (32768, 14, 12, 1)])
def test_track_and_dedup_match_twins(cuda, L, k, s, t):
    """syncmer_track, then K3 with hcap above and below the emission
    count (the gap-1 scheme at L=32768 sorts in global scratch)."""
    rng = np.random.default_rng(L + t)
    packed, lengths = dsync.pack_reads(reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    before = extract.syncmer_track.LAUNCHES, sort.dedup_fused.LAUNCHES
    kmer, emit = extract.syncmer_track(pk, ln, k, s, t)
    want = dsync.syncmer_kmers(pk, ln, k, s, t)
    torch.cuda.synchronize()
    assert torch.equal(kmer, want[0]) and torch.equal(emit, want[1])
    gap = dsync.emission_min_gap(k, s, t)
    for hcap in (dsync.hash_cap(L), 64):
        got = sort.dedup_fused(kmer, emit, hcap, gap)
        ref = sort.dedup_fused_plain(kmer, emit, hcap, gap)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert a.device.type == "cuda" and torch.equal(a, b)
    assert (extract.syncmer_track.LAUNCHES, sort.dedup_fused.LAUNCHES) == (
        before[0] + 1, before[1] + 2)


def test_dedup_reports_min_gap_overflow(cuda):
    kmer = torch.arange(4 * 256, dtype=torch.int64, device=cuda).view(4, 256)
    emit = torch.zeros((4, 256), dtype=torch.bool, device=cuda)
    emit[:, ::5] = True
    emit[1, 1::5] = True  # breaks min_gap 5
    got = sort.dedup_fused(kmer, emit, 64, 5)
    want = sort.dedup_fused_plain(kmer.cpu(), emit.cpu(), 64, 5)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert got[3].tolist() == [52, sort.OVERFLOW, 52, 52]


@pytest.mark.parametrize("W", [100, 128, 8192, 32768])
def test_sort_pairs_matches_twin(cuda, W):
    """Duplicated keys and keys equal to the all-ones sentinel; W = 32768
    sorts in global scratch."""
    rng = np.random.default_rng(W)
    hi = rng.integers(-4, 4, (6, W), dtype=np.int32)
    lo = rng.integers(-2**31, 2**31, (6, W), dtype=np.int32)
    hi[:, 1::2] = hi[:, ::2][:, :W // 2]  # every key twice
    lo[:, 1::2] = lo[:, ::2][:, :W // 2]
    hi[:, ::7] = -1
    lo[:, ::7] = -1
    args = [torch.from_numpy(x).to(cuda) for x in (hi, lo)]
    before = sort.sort_pairs.LAUNCHES
    got = sort.sort_pairs(*args)
    want = sort.sort_pairs_plain(*args)
    torch.cuda.synchronize()
    assert sort.sort_pairs.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dedup_pairs_equals_dedup_fused(cuda):
    """The pair-sort route (K4) dedups as K3 does on emissions that
    respect min_gap."""
    rng = np.random.default_rng(8)
    L, gap = 2048, 5
    kmer = torch.from_numpy(rng.integers(0, 2**20, (6, L))).to(cuda)
    emit = torch.zeros((6, L), dtype=torch.bool, device=cuda)
    emit[:, ::gap] = True
    emit[2] = False  # a row with no emission
    before = sort.sort_pairs.LAUNCHES
    got = sort.dedup_pairs(kmer, emit, 128)
    want = sort.dedup_fused(kmer, emit, 128, gap)
    torch.cuda.synchronize()
    assert sort.sort_pairs.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_split_step_equals_k1_step(cuda, monkeypatch):
    """The flat step with the split engine (syncmer_track, K3) equals the
    K1 step on the card."""
    rng = np.random.default_rng(6)
    L = 2048
    packed, lengths = dsync.pack_reads(reads(rng, L, n=40), L)
    table = rng.integers(0, 256, (4500, probe.pad_bins(300)),
                         dtype=np.uint8)
    args = [torch.from_numpy(x).to(cuda) for x in (
        table, packed, lengths, np.array([0, 3, 4, 10, 100, 250, 300]),
        np.array([0, -1, 1, 2, 3, 4], dtype=np.int32))]
    kw = dict(k=22, s=12, t=5, hcap=dsync.hash_cap(L), topk=16)
    want = fused_e2e_step(*args, 77, 1500, **kw)
    monkeypatch.setattr(e2e, "USE_FUSED_EXTRACT", False)
    before = extract.syncmer_hashes.LAUNCHES, sort.dedup_fused.LAUNCHES
    got = fused_e2e_step(*args, 77, 1500, **kw)
    assert torch.equal(got, want)
    assert extract.syncmer_hashes.LAUNCHES == before[0]
    assert sort.dedup_fused.LAUNCHES == before[1] + 1


@pytest.mark.parametrize("bl,bins", [(1000, 1000), (5000, 2000),
                                     (2000, 5000), (30000, 64)])
def test_k2_matches_twin(cuda, bl, bins):
    rng = np.random.default_rng(bl)
    Bp = probe.pad_bins(bins)
    table = rng.integers(0, 256, (3 * bl, Bp), dtype=np.uint8)
    table[:, ::3] = 0
    hi = rng.integers(-2**31, 2**31, (6, 1500), dtype=np.int32)
    lo = rng.integers(-2**31, 2**31, (6, 1500), dtype=np.int32)
    valid = rng.random((6, 1500)) < 0.6
    args = [torch.from_numpy(x).to(cuda) for x in (hi, lo, valid)]
    tbl = torch.from_numpy(table).to(cuda)
    seed = int(rng.integers(0, 2**63))
    got = probe.probe_counts(*args, tbl, seed, bl)
    want = probe.probe_counts_plain(*args, tbl, seed, bl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("bins", [16, 64, 100, 512, 4096])
def test_grouped_probe_matches_twin(cuda, bins, G):
    """K2n (bins <= 512) and K2 over G stacked tables with a mixed
    activity mask, fingerprint-0 columns, and an all-inactive read."""
    rng = np.random.default_rng(bins * G)
    bl, R, H = 700, 9, 1300
    Bp = probe.pad_bins(bins)
    tables = rng.integers(0, 256, (G, 3 * bl, Bp), dtype=np.uint8)
    tables[:, :, ::3] = 0
    hi = rng.integers(-2**31, 2**31, (R, H), dtype=np.int32)
    lo = rng.integers(-2**31, 2**31, (R, H), dtype=np.int32)
    valid = rng.random((R, H)) < 0.7
    active = rng.random((G, R)) < 0.5
    active[:, 0] = True
    active[:, R - 1] = False
    args = [torch.from_numpy(x).to(cuda) for x in (hi, lo, valid, tables,
                                                   active)]
    seed = int(rng.integers(0, 2**63))
    kernel = probe.k2n_counts if Bp <= probe.NARROW_MAX_BINS \
        else probe.k2_counts
    before = kernel.LAUNCHES
    got = probe.probe_counts_grouped(*args, seed, bl)
    want = probe.probe_counts_grouped_plain(*args, seed, bl)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    assert torch.equal(got, want)
    assert int(got[:, R - 1].abs().sum()) == 0
    if Bp <= probe.NARROW_MAX_BINS:  # K2 computes the same counts
        assert torch.equal(probe.k2_counts(*args, seed, bl), want)


def test_fused_step_matches_cpu_twins(cuda):
    rng = np.random.default_rng(5)
    L, k, s, t, topk = 2048, 22, 12, 5, 16
    packed, lengths = dsync.pack_reads(reads(rng, L, n=40), L)
    bins, bl = 300, 1500
    table = rng.integers(0, 256, (3 * bl, probe.pad_bins(bins)),
                         dtype=np.uint8)
    table[:, 7] = 0  # a bin every read hits often
    offsets = np.array([0, 3, 4, 10, 100, 250, 300])
    users = np.array([0, -1, 1, 2, 3, 4], dtype=np.int32)
    args = [torch.from_numpy(x) for x in (table, packed, lengths, offsets,
                                          users)]
    kw = dict(k=k, s=s, t=t, hcap=dsync.hash_cap(L), topk=topk)
    want = fused_e2e_step(*args, 77, bl, **kw)
    got = fused_e2e_step(*[a.to(cuda) for a in args], 77, bl, **kw)
    assert torch.equal(got.cpu(), want)


def test_hier_grouped_step_matches_cpu_twins(cuda, tmp_path):
    """The hierarchical grouped step on the card (K1, K2n over stacked
    subgroups) and the per-IXF traversal of host hashes equal the same
    on the CPU twins."""
    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash.schemes import search_hashes
    from taxor_tpu_torch.search.thresholds import Thresholder

    from .util import make_ref_set

    rng = np.random.default_rng(21)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=100,
                                      genome_len=3000)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=22, syncmer_size=12, use_syncmer=True, layout_mode="auto",
        tmax=64, layout_file=str(tmp_path / "b.out")))
    seqs = [g[o:o + 900] for g in genomes.values() for o in (0, 1500)]
    packed, lengths = dsync.pack_reads(seqs, 1024)
    th = Thresholder.make(22, 22, 0.04, -1.0, True)
    dhs = [DeviceHIXF.from_hixf(index.hixf, dev) for dev in ("cpu", cuda)]
    out = [dh.e2e_async(packed, lengths, index.scheme, th)() for dh in dhs]
    assert len(index.hixf.ixfs) > 1
    for a, b in zip(out[0][:4], out[1][:4]):
        np.testing.assert_array_equal(a, b)
    assert (out[1][0][:, 0] > 0).all()
    hl = search_hashes(seqs[:40], index.scheme)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    hi, lo, valid = probe.pack_hash_lists(hl, 256)
    before = probe.k2n_counts.ROUTES.get("host_hashes", 0)
    dense = [dh.counts(hi, lo, valid, thr) for dh in dhs]
    assert probe.k2n_counts.ROUTES["host_hashes"] > before + 1  # descended
    for a, b in zip(*dense):
        np.testing.assert_array_equal(a, b)
    assert dense[1][1].any(axis=1).all()


def test_wrappers_check_inputs(cuda):
    pk = torch.zeros((2, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="lengths"):
        extract.syncmer_hashes(pk, torch.zeros(2, dtype=torch.int64,
                                               device=cuda), 22, 12, 5, 128)
    z = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    table = torch.zeros((30, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        probe.probe_counts(z, z, z.bool(), table, 1, 11)
    wide = torch.zeros((1, 30, 1024), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        probe.k2n_counts(z, z, z.bool(), wide, None, 1, 10)
    with pytest.raises(ValueError, match="int64"):
        sort.dedup_fused(z, z.bool(), 16)
    with pytest.raises(ValueError, match="int32"):
        sort.sort_pairs(z.long(), z)
