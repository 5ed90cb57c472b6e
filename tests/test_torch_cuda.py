"""The CUDA kernels K1, K2, K2n, syncmer_track, K3 and K4, the steps on
the card and the tools' four diagnostic kernels, held bit-exact to their
plain twins.  Needs a CUDA GPU and
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
    """Random reads plus the tracker's tied cases: a homopolymer run,
    a tandem repeat, two-letter alphabets, a first window tied at every
    offset, a homopolymer over the whole bucket."""
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(L // 2, L + 1)))]
            .tobytes() for _ in range(n)]
    arr = ACGT[rng.integers(0, 4, L)].copy()
    arr[10:60] = ord("A")
    arr[rng.integers(0, L, L // 40)] = ord("N")
    two = [np.frombuffer(p, np.uint8)[rng.integers(0, 2, L - 9)].tobytes()
           for p in (b"AC", b"AT", b"CG")]
    return seqs + two + [
        arr.tobytes(), (b"ACGTTG" * L)[:L], b"", b"ACGT" * 5,
        b"A" * 24 + ACGT[rng.integers(0, 4, L - 24)].tobytes(), b"G" * L]


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


@pytest.mark.parametrize("variant", ["slab", "rows"])
@pytest.mark.parametrize("bl,bins,G", [(1203, 4096, 1), (1000, 1000, 8),
                                       (300, 1000, 8), (3000, 4096, 8),
                                       (2000, 5000, 1), (134, 16384, 1)])
def test_k2_routes_match_twin(cuda, variant, bl, bins, G):
    """Both K2 routes over G stacked tables: a read of 2,048 valid
    fingerprint-0 hashes (counts above 256 in the zero columns, several
    flushes of the slab route's byte counters), invalid fingerprint-0
    slots, a mixed activity mask and a read inactive everywhere."""
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    rng = np.random.default_rng(bins + G)
    R, H = 40, 2048
    Bp = probe.pad_bins(bins)
    tables = rng.integers(0, 256, (G, 3 * bl, Bp), dtype=np.uint8)
    tables[:, :, ::7] = 0
    seed = int(rng.integers(0, 2**63))
    pool = rng.integers(0, 2**64, 1 << 21, dtype=np.uint64)
    zero = pool[fingerprint8(mix_split(pool, seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0], keys[1] = zero[:H], zero[H:2 * H]
    valid = rng.random((R, H)) < 0.3
    valid[0], valid[1] = True, False  # read 1: fingerprint 0, all invalid
    active = rng.random((G, R)) < 0.6
    active[:, :2], active[:, R - 1] = True, False
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in (hi, lo, valid, tables, active)]
    b = probe.slab_bins(3 * bl, Bp, cuda)
    assert b == {1203: 64, 1000: 64, 300: 128, 3000: 16, 2000: 32,
                 134: 128}[bl]
    before = dict(probe.k2_counts.VARIANTS)
    got = probe.k2_counts(*args, seed, bl, variant=variant)
    want = probe.probe_counts_grouped_plain(*args, seed, bl)
    torch.cuda.synchronize()
    assert probe.k2_counts.VARIANTS[variant] == before.get(variant, 0) + 1
    assert torch.equal(got, want)
    assert int(got[:, 0].max()) > 256 and int(got[:, 1:].max()) < 256
    assert int(got[:, R - 1].abs().sum()) == 0


def run_csr(rng, G, bins):
    """int64 CSR (run_off, run_s, run_e): one-bin runs, runs over many
    bins with unused columns between them, subgroup 0 one run over all
    of its bins, subgroup 1 none."""
    offs, starts, ends = [0], [], []
    for g in range(G):
        if g == 0:
            starts.append(0)
            ends.append(bins)
        elif g != 1:
            col = 0
            while col < bins:
                e = min(bins, col + int(rng.choice([1, 1, 3, 16, 60])))
                starts.append(col)
                ends.append(e)
                col = e + int(rng.integers(0, 3))
        offs.append(len(starts))
    return [np.array(x, dtype=np.int64) for x in (offs, starts, ends)]


def narrow_inputs(rng, G, bins, R=48, H=2304, bl=72):
    """Hashes (read 0 all fingerprint 0: sums above 256; read 1 all
    invalid) and G tables of 3 bl slots with zero columns."""
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    Bp = probe.pad_bins(bins)
    tables = np.zeros((G, 3 * bl, Bp), dtype=np.uint8)
    tables[:, :, :bins] = rng.integers(0, 256, (G, 3 * bl, bins))
    tables[:, :, ::7] = 0
    seed = int(rng.integers(0, 2**63))
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = pool[fingerprint8(mix_split(pool, seed)) == 0][:H]
    valid = rng.random((R, H)) < 0.7
    valid[0], valid[1] = True, False
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return [np.ascontiguousarray(x) for x in (hi, lo, valid)], tables, seed


@pytest.mark.parametrize("mode", ["smem", "rows"])
@pytest.mark.parametrize("share", [0.0, 0.005, 0.6, 1.0])
@pytest.mark.parametrize("G,bins", [(1, 16), (8, 100), (72, 512)])
def test_k2n_run_sums_match_twin(cuda, G, bins, share, mode):
    """K2n's run sums in both modes: tables of 216 slots (the widest
    descent group's; 100 bins: B4 = 25), activity 0 to 100%, one launch
    a call."""
    rng = np.random.default_rng(G + bins)
    keys, tables, seed = narrow_inputs(rng, G, bins)
    active = rng.random((G, keys[0].shape[0])) < share
    if share:
        active[0, 0] = True
    runs = run_csr(rng, G, bins)
    args = [torch.from_numpy(x).to(cuda)
            for x in (*keys, tables, active, *runs)]
    assert probe.narrow_mode(216, tables.shape[2], cuda) == "smem"
    before = probe.k2n_counts.LAUNCHES, probe.k2n_counts.MODES.get(mode, 0)
    got = probe.k2n_run_sums(*args, seed, 72, mode=mode)
    want = probe.probe_run_sums_grouped_plain(*args, seed, 72)
    torch.cuda.synchronize()
    assert probe.k2n_counts.LAUNCHES == before[0] + 1
    assert probe.k2n_counts.MODES[mode] == before[1] + 1
    assert got.shape == (runs[1].shape[0], 48) and torch.equal(got, want)
    assert int(got[:, 1].abs().sum()) == 0
    assert (int(got[0, 0]) > 256) if share else int(got.abs().sum()) == 0


@pytest.mark.parametrize("bins", [16, 100, 512])
def test_k2n_dense_counts_in_both_modes(cuda, bins):
    """K2n's dense counts (one-bin runs) in both modes equal the twin."""
    rng = np.random.default_rng(bins)
    keys, tables, seed = narrow_inputs(rng, 5, bins)
    active = rng.random((5, 48)) < 0.5
    active[:, 0] = True
    args = [torch.from_numpy(x).to(cuda) for x in (*keys, tables, active)]
    want = probe.probe_counts_grouped_plain(*args, seed, 72)
    for mode in ("smem", "rows"):
        got = probe.k2n_counts(*args, seed, 72, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert int(want[:, 0].max()) > 256


def test_k2n_run_sums_check_inputs(cuda):
    z = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    tall = torch.zeros((1, 3000, 512), dtype=torch.uint8, device=cuda)
    off = torch.tensor([0, 1], dtype=torch.int64, device=cuda)
    s, e = off[:1], off[1:]
    assert probe.narrow_mode(3000, 512, cuda) == "rows"
    with pytest.raises(ValueError, match="do not fit"):
        probe.k2n_run_sums(z, z, z.bool(), tall, None, off, s, e, 1, 1000,
                           mode="smem")
    with pytest.raises(ValueError, match="run_off"):
        probe.k2n_run_sums(z, z, z.bool(), tall, None, off[:1], s, e, 1,
                           1000)
    out = probe.probe_run_sums_grouped(z, z, z.bool(), tall, None, off, s, e,
                                       1, 1000)
    assert out.shape == (1, 2) and int(out.abs().sum()) == 0


def test_k2_takes_the_rows_route_where_no_slab_fits(cuda):
    z = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    table = torch.zeros((1, 15000, 2000), dtype=torch.uint8, device=cuda)
    assert probe.slab_bins(15000, 2000, cuda) == 0
    before = probe.k2_counts.VARIANTS.get("rows", 0)
    out = probe.probe_counts_grouped(z, z, z.bool(), table, None, 1, 5000)
    assert probe.k2_counts.VARIANTS["rows"] == before + 1
    assert int(out.abs().sum()) == 0
    with pytest.raises(ValueError, match="no slab"):
        probe.k2_counts(z, z, z.bool(), table, None, 1, 5000, variant="slab")


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
    assert probe.k2n_counts.MODES.get("smem", 0) > 0
    for a, b in zip(*dense):
        np.testing.assert_array_equal(a, b)
    assert dense[1][1].any(axis=1).all()


def test_wide_root_descent_matches_cpu_twins(cuda, tmp_path):
    """A hierarchical index whose root is wider than 512 bins: on the card
    its descent group takes K2's dense counts and their segment sums (K2n
    on the 32-bin group below), in the grouped step and in the per-IXF
    traversal, and both equal the CPU twins."""
    import os

    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash.schemes import search_hashes
    from taxor_tpu_torch.search.thresholds import Thresholder
    from taxor_tpu_torch.tools.synth import write_wide_root_layout

    from .util import make_ref_set, simulate_read

    rng = np.random.default_rng(29)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=540,
                                      genome_len=600)
    files = [os.path.join(gdir, f"{acc}_genomic.fna") for acc in genomes]
    layout = str(tmp_path / "wide.out")
    assert write_wide_root_layout(files, layout) == 529
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=22, syncmer_size=12, use_syncmer=True, layout_file=layout,
        resume=True))
    seqs = list(genomes.values())
    reads = [simulate_read(rng, seqs[i], 400, 0.02)
             for i in [0, 1, *range(520, 540), *rng.integers(1, 520, 40)]]
    packed, lengths = dsync.pack_reads(reads, 512)
    th = Thresholder.make(22, 22, 0.04, -1.0, True)
    dhs = [DeviceHIXF.from_hixf(index.hixf, dev) for dev in ("cpu", cuda)]
    assert dhs[1].groups[0]["tables"].shape[2] > probe.NARROW_MAX_BINS
    before = dict(probe.k2_counts.ROUTES), probe.k2n_counts.LAUNCHES
    out = [dh.e2e_async(packed, lengths, index.scheme, th)() for dh in dhs]
    for a, b in zip(out[0][:4], out[1][:4]):
        np.testing.assert_array_equal(a, b)
    assert (out[1][0][:, 0] > 0).all()
    hl = search_hashes(reads, index.scheme)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    hi, lo, valid = probe.pack_hash_lists(hl, max(h.shape[0] for h in hl))
    dense = [dh.counts(hi, lo, valid, thr) for dh in dhs]
    for a, b in zip(*dense):
        np.testing.assert_array_equal(a, b)
    routes = probe.k2_counts.ROUTES
    for route in ("fused", "host_hashes"):
        assert routes.get(route, 0) == before[0].get(route, 0) + 1
    assert probe.k2n_counts.LAUNCHES > before[1]  # the group below


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


# ------------------------------------------- the tools' diagnostic kernels --
@pytest.fixture
def diag_inputs(cuda):
    from taxor_tpu_torch.tools import probe_bounds as pb
    from taxor_tpu_torch.tools import probe_experiments as pe

    rng = np.random.default_rng(40)
    table = pb.tool_table(rng)
    n_hash = rng.integers(0, 513, 48).astype(np.int32)
    n_hash[0] = 0
    w16r = pb.make_inputs(rng, 48, 512, table.shape[0])
    w16, w10 = pe.make_inputs(rng, 48, 512, table.shape[0], pe.BL_TOOL)
    return [torch.from_numpy(x).to(cuda)
            for x in (table, n_hash, w16r, w16, w10)]


def test_diag_probe_kernels_match_twins(diag_inputs):
    from taxor_tpu_torch.device import diag

    table, n_hash, w16r, w16, w10 = diag_inputs
    before = diag.probe_bounds.LAUNCHES
    for mode in diag.PROBE_BOUNDS_MODES:
        got = diag.probe_bounds(table, w16r, n_hash, mode)
        assert torch.equal(got, diag.probe_bounds_plain(table, w16r, n_hash,
                                                        mode)), mode
    assert diag.probe_bounds.LAUNCHES == before + 5
    for kw in (dict(layout="p16", nr=4), dict(layout="p10", nr=2),
               dict(layout="p16", rounds=8), dict(flood_k=4)):
        w = w10 if kw.get("layout") == "p10" else w16
        got = diag.probe_experiment(table, w, n_hash, block_length=806, **kw)
        want = diag.probe_experiment_plain(table, w, n_hash,
                                           block_length=806, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kw


@pytest.mark.parametrize("L", [256, 8192, 32768])
def test_diag_stage_and_shift_kernels_match_twins(cuda, L):
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.tools.debug_min import stream_words

    rng = np.random.default_rng(L + 41)
    packed, lengths = dsync.pack_reads(reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    want = diag.extract_stages_plain(pk, ln, 22, 12, 5)
    for stage in diag.STAGES:
        got = diag.extract_stage(pk, ln, 22, 12, 5, stage)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and torch.equal(got, want[stage])
    x = torch.from_numpy(stream_words(packed)).to(cuda)
    assert torch.equal(diag.window_shift(x),
                       diag.window_shift_plain(x, range(16)))
