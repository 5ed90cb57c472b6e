"""The CUDA kernels K1, K2, K2n, syncmer_track, K3, K4, K5 and K6 (K1 and
syncmer_track in both s-mer instances), the steps on the card (syncmer,
minimiser, plain k-mer and scaled schemes; syncmer reads past L_CAP in
pieces; s >= 16 and narrow syncmer schemes at their own hash capacity)
and the tools' four diagnostic kernels, held bit-exact to their plain
twins.
Needs a CUDA GPU and nvcc; skips elsewhere.  This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from taxor_tpu_torch.device import e2e, extract, probe, sort
from taxor_tpu_torch.device.e2e import fused_e2e_step
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.tools import probe_experiments as pe
from taxor_tpu_torch.tools import synth, time_sort

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
    hcap = dsync.hash_cap(L, k, s, t)
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
    for hcap in (dsync.hash_cap(L, k, s, t), 64):
        got = sort.dedup_fused(kmer, emit, hcap, gap)
        ref = sort.dedup_fused_plain(kmer, emit, hcap, gap)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert a.device.type == "cuda" and torch.equal(a, b)
    assert (extract.syncmer_track.LAUNCHES, sort.dedup_fused.LAUNCHES) == (
        before[0] + 1, before[1] + 2)


# the schemes of K1's and syncmer_track's 64-bit s-mer instances (16 <= s
# <= 31) and a narrow one of the 32-bit instance (k - s + 1 = 3), each at
# its own hash capacity
WIDE_SCHEMES = [(22, 16), (28, 18), (18, 16), (30, 29), (16, 14)]


def instance_launches(bits: int) -> tuple[int, int]:
    return (extract.syncmer_hashes.SMER_BITS.get(bits, 0),
            extract.syncmer_track.SMER_BITS.get(bits, 0))


@pytest.mark.parametrize("L", [256, 4096, 16384, 32768])
@pytest.mark.parametrize("k,s", WIDE_SCHEMES)
def test_k1_and_track_wide_schemes_match_twins(cuda, k, s, L):
    """K1 and syncmer_track through the instance s picks (at L = 32768
    the 64-bit one takes two tiles and replays tied runs from the staged
    words) at the scheme's hash capacity: bit-exact to their twins, and
    no random read emits past the capacity."""
    t = (k - s + 1) // 2
    rng = np.random.default_rng(L + 100 * k + s)
    packed, lengths = dsync.pack_reads(reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    hcap = dsync.hash_cap(L, k, s, t)
    bits = extract.smer_bits(s)
    before = instance_launches(bits)
    got = extract.syncmer_hashes(pk, ln, k, s, t, hcap)
    track = extract.syncmer_track(pk, ln, k, s, t)
    want = extract.syncmer_hashes_plain(pk, ln, k, s, t, hcap)
    twin = dsync.syncmer_kmers(pk, ln, k, s, t)
    torch.cuda.synchronize()
    for a, b in zip((*got, *track), (*want, *twin)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert instance_launches(bits) == (before[0] + 1, before[1] + 1)
    assert int(got[4][:12].max()) <= hcap  # reads() starts with 12 random


@pytest.mark.parametrize("P", [2, 32])
@pytest.mark.parametrize("k,s", WIDE_SCHEMES)
def test_k1_and_track_wide_scheme_pieces_match_twins(cuda, k, s, P):
    """K1's and syncmer_track's piece rows of reads in the bucket of P
    pieces (tied stretches and Ns across every cut, tied stretches past a
    piece), then their union (K4, K6): bit-exact to the twins, and the
    union equals the host scanner's set on every read that fits the
    capacity, which every random one does."""
    from taxor_tpu_torch.hash.schemes import HashScheme, search_hashes
    from taxor_tpu_torch.utils.u64 import join32

    t = (k - s + 1) // 2
    rng = np.random.default_rng(P + 100 * k + s)
    L = dsync.pieces_len(P)
    seqs = [q[:L] for q in synth.reads_across_cuts(rng, k, lengths=(L - 5,))]
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    hp = dsync.hash_cap(dsync.L_CAP, k, s, t)
    bits = extract.smer_bits(s)
    before = instance_launches(bits)
    got = extract.syncmer_hashes(pk, ln, k, s, t, hp, pieces=P)
    track = extract.syncmer_track(pk, ln, k, s, t, pieces=P)
    want = extract.syncmer_hashes_plain(pk.cpu(), ln.cpu(), k, s, t, hp,
                                        pieces=P)
    twin = dsync.syncmer_kmers_pieces(pk.cpu(), ln.cpu(), k, s, t, P)
    torch.cuda.synchronize()
    for a, b in zip((*got, *track), (*want, *twin)):
        assert a.shape[0] == len(seqs) * P and torch.equal(a.cpu(), b)
    assert instance_launches(bits) == (before[0] + 1, before[1] + 1)
    hcap = dsync.hash_cap(L, k, s, t)
    assert hcap == P * hp
    hi, lo, valid, n_unique, n_emit = (
        x.cpu() for x in e2e._syncmer_hashes(pk, ln, k, s, t, hcap))
    host = search_hashes(seqs, HashScheme(kmer_size=k, window_size=k,
                                          syncmer_size=s, t_syncmer=t))
    for r, h in enumerate(host):
        if int(n_emit[r]) == sort.OVERFLOW:
            continue
        keys = join32(hi[r], lo[r])[valid[r]].numpy().astype(np.uint64)
        assert np.array_equal(np.sort(keys), h) and n_unique[r] == len(h)
    # the three reads of random bases (cut kinds) fit
    assert (n_emit[:3] != sort.OVERFLOW).all()


@pytest.mark.parametrize("k,s", [(28, 18), (16, 14)])
def test_wide_and_narrow_scheme_steps_match_cpu_twins(cuda, tmp_path, k, s):
    """The flat and the grouped step of a 64-bit s-mer scheme and of a
    narrow one on the card equal the CPU twins, at the scheme's hash
    capacity, with no read past it (reads of 1-3 kb and of 40 kb)."""
    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.search.thresholds import Thresholder

    from .util import make_ref_set

    rng = np.random.default_rng(k + s)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=72,
                                      genome_len=4000)
    gs = list(genomes.values())
    batches = [(4096, [g[o:o + n] for g, o, n in zip(
        gs, range(0, 1000, 40), (1000, 2000, 3000) * 8)]),
        (dsync.bucket_len(40000), [b"".join(gs[j:j + 10])[:40000]
                                   for j in range(0, 40, 10)])]
    th = Thresholder.make(k, k, 0.04, -1.0, True)
    for layout in ("flat", "auto"):
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=k, syncmer_size=s, use_syncmer=True,
            layout_mode=layout, tmax=64 if layout == "auto" else 0,
            layout_file=str(tmp_path / f"{layout}.out")))
        assert (len(index.hixf.ixfs) > 1) == (layout == "auto")
        dhs = [DeviceHIXF.from_hixf(index.hixf, dev) for dev in ("cpu", cuda)]
        for L, seqs in batches:
            packed, lengths = dsync.pack_reads(seqs, L)
            out = [dh.e2e_async(packed, lengths, index.scheme, th)()
                   for dh in dhs]
            for a, b in zip(out[0][:5], out[1][:5]):
                np.testing.assert_array_equal(a, b)
            hcap = dsync.hash_cap(L, k, s, index.scheme.t_syncmer)
            assert out[1][4] == hcap and (out[1][3] <= hcap).all()


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


@pytest.mark.parametrize("W", time_sort.PAIR_WIDTHS)
def test_sort_pairs_matches_twin(cuda, W):
    """Duplicated keys, keys equal to the all-ones sentinel, a row of
    equal keys, a row of sentinels, a row of three distinct keys and one
    of long equal runs (merge cuts inside runs); below a warp, odd widths, E = 16
    and 32 of the register network, and past 16,384 keys the merge route
    (chunks sorted on the network, then merge-path passes: one at 16,385
    and 32,768, five at 524,288, six at 1,048,576, the union of 32 pieces
    of a narrow syncmer scheme; 100,000 is no power of two)."""
    hi, lo = time_sort.pair_rows(np.random.default_rng(W), 6, W)
    args = [torch.from_numpy(x.view(np.int32)).to(cuda) for x in (hi, lo)]
    before = sort.sort_pairs.LAUNCHES
    got = sort.sort_pairs(*args)
    want = sort.sort_pairs_plain(*args)
    torch.cuda.synchronize()
    assert sort.sort_pairs.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,min_gap", [(1000, 5), (2048, 1), (8192, 5),
                                       (16384, 5), (32768, 5), (32768, 2),
                                       (32768, 1)])
def test_dedup_emission_counts_match_twin(cuda, L, min_gap):
    """K3 on rows of 0, 1, 31-33, 32E +- 1, Wb and Wb + 1 (overflow)
    emissions, all-equal k-mers and k-mers equal to the sentinel, at
    every buffer of the register route (Wb 256 to 16,384; L = 1,000 rows
    are no multiple of 16 bytes: byte loads) and the global-scratch route
    (gap 1 at L = 32,768)."""
    rng = np.random.default_rng(L + min_gap)
    counts = time_sort.emission_counts(L, min_gap)
    kmer, emit = time_sort.emission_rows(rng, L, counts, min_gap)
    kmer = torch.from_numpy(kmer.view(np.int64)).to(cuda)
    emit = torch.from_numpy(emit).to(cuda)
    for hcap in (2048, 100):
        got = sort.dedup_fused(kmer, emit, hcap, min_gap)
        want = sort.dedup_fused_plain(kmer, emit, hcap, min_gap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    Wb = sort.dedup_width(L, min_gap)
    assert (got[3] == sort.OVERFLOW).sum() == (Wb < L)
    assert int(got[2][-2]) == 1 and int(got[2][-1]) > 0


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


def long_reads(rng, k: int) -> list[bytes]:
    """tools/synth.reads_across_cuts (tied runs and Ns across every cut,
    tied stretches past a piece) and random reads past L_CAP."""
    return synth.reads_across_cuts(rng, k) + [
        ACGT[rng.integers(0, 4, n)].tobytes() for n in (33000, 90000)]


@pytest.mark.parametrize("k,s,t", [(22, 12, 5), (16, 8, 4), (14, 12, 1)])
def test_k1_pieces_match_twin(cuda, k, s, t):
    """K1 on the pieces of reads past L_CAP (4 pieces a read; the gap-1
    scheme sorts in global scratch and overflows its pieces' hcap, here
    the k = 22, s = 12 scheme's L/4 for every scheme), then their union
    (K4, K6): bit-exact to the twins, and the union equals the host
    scanner's set where no piece overflows."""
    from taxor_tpu_torch.hash.schemes import HashScheme, search_hashes
    from taxor_tpu_torch.utils.u64 import join32

    seqs = long_reads(np.random.default_rng(k + s), k)
    L = dsync.bucket_len(max(len(q) for q in seqs))
    P = dsync.bucket_pieces(L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    hp = dsync.hash_cap(dsync.L_CAP, 22, 12, 5)
    before = extract.syncmer_hashes.LAUNCHES
    got = extract.syncmer_hashes(pk, ln, k, s, t, hp, pieces=P)
    want = extract.syncmer_hashes_plain(pk.cpu(), ln.cpu(), k, s, t, hp,
                                        pieces=P)
    torch.cuda.synchronize()
    assert extract.syncmer_hashes.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert a.shape[0] == len(seqs) * P and torch.equal(a.cpu(), b)
    before = sort.sort_pairs.LAUNCHES, sort.unique_pairs.LAUNCHES
    hashes = e2e._syncmer_hashes(pk, ln, k, s, t, P * hp)
    assert (sort.sort_pairs.LAUNCHES, sort.unique_pairs.LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    plain = e2e._syncmer_hashes(pk.cpu(), ln.cpu(), k, s, t, P * hp)
    for a, b in zip(hashes, plain):
        assert torch.equal(a.cpu(), b)
    hi, lo, valid, n_unique, n_emit = (x.cpu() for x in hashes)
    host = search_hashes(seqs, HashScheme(kmer_size=k, window_size=k,
                                          syncmer_size=s, t_syncmer=t))
    for r, h in enumerate(host):
        if int(n_emit[r]) == sort.OVERFLOW:
            continue
        keys = join32(hi[r], lo[r])[valid[r]].numpy().astype(np.uint64)
        assert np.array_equal(np.sort(keys), h) and n_unique[r] == len(h)
    assert (n_emit == sort.OVERFLOW).any() == (t == 1)


def test_track_pieces_match_twin(cuda, monkeypatch):
    """syncmer_track on the pieces, then K3 on each piece and the union:
    the split engine's long reads, equal to K1's."""
    k, s, t = 22, 12, 5
    seqs = long_reads(np.random.default_rng(4), k)
    L = dsync.bucket_len(max(len(q) for q in seqs))
    P = dsync.bucket_pieces(L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    kmer, emit = extract.syncmer_track(pk, ln, k, s, t, pieces=P)
    want = dsync.syncmer_kmers_pieces(pk.cpu(), ln.cpu(), k, s, t, P)
    torch.cuda.synchronize()
    assert torch.equal(kmer.cpu(), want[0]) and torch.equal(emit.cpu(),
                                                            want[1])
    hcap = dsync.hash_cap(L, k, s, t)
    k1 = e2e._syncmer_hashes(pk, ln, k, s, t, hcap)
    monkeypatch.setattr(e2e, "USE_FUSED_EXTRACT", False)
    split = e2e._syncmer_hashes(pk, ln, k, s, t, hcap)
    for a, b in zip(k1, split):
        assert torch.equal(a, b)


@pytest.mark.parametrize("W", [1, 7, 1024, 16384, 262144])
def test_unique_pairs_matches_twin(cuda, W):
    """K6 on sorted rows with duplicates, all-ones keys among the real
    ones, n_valid of 0, 1, W and in between."""
    hi, lo = time_sort.pair_rows(np.random.default_rng(W), 6, W)
    args = [torch.from_numpy(x.view(np.int32)).to(cuda) for x in (hi, lo)]
    args = list(sort.sort_pairs_plain(*args))
    n_valid = torch.tensor([0, 1, W, W // 2, max(0, W - 1), W],
                           dtype=torch.int32, device=cuda)
    before = sort.unique_pairs.LAUNCHES
    got = sort.unique_pairs(*args, n_valid)
    want = sort.unique_pairs_plain(*args, n_valid)
    torch.cuda.synchronize()
    assert sort.unique_pairs.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [2, 32, 64])
def test_union_pieces_matches_twin(cuda, P):
    """union_pieces at 2, 32 and 64 pieces of 8,192 slots: K4 on its
    register route (16,384 keys) and its merge route (262,144 and 524,288),
    then K6, bit-exact to the twins; hashes repeat across pieces."""
    rng = np.random.default_rng(P)
    R, hp = 3, 8192
    keys = rng.integers(0, 2**40, (R * P, hp)).astype(np.int64)
    keys[:, ::7] = keys[:, :1]  # repeats within and across pieces
    keys[0, 5] = -1  # a real all-ones hash
    valid = rng.random((R * P, hp)) < 0.7
    hi, lo = (torch.from_numpy(x).to(cuda) for x in (
        (keys >> 32).astype(np.int32), (keys & 0xFFFFFFFF).astype(np.int32)))
    valid = torch.from_numpy(valid).to(cuda)
    n_emit = valid.sum(dim=1, dtype=torch.int32)
    got = sort.union_pieces(hi, lo, valid, n_emit, P)
    want = sort.union_pieces(hi.cpu(), lo.cpu(), valid.cpu(), n_emit.cpu(),
                             P)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_long_read_steps_match_cpu_twins(cuda, tmp_path):
    """The flat and the grouped step on a bucket of pieces (K1, K4, K6,
    then K2 or K2n at the bucket's hash slots) equal the CPU twins."""
    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.search.thresholds import Thresholder

    from .util import make_ref_set

    rng = np.random.default_rng(12)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=80,
                                      genome_len=36000)
    seqs = [(g * 2)[o:o + n] for g, o, n in zip(
        genomes.values(), range(0, 36000, 2000), (33000, 40000, 70000) * 6)]
    L = dsync.bucket_len(max(len(q) for q in seqs))
    packed, lengths = dsync.pack_reads(seqs, L)
    th = Thresholder.make(22, 22, 0.04, -1.0, True)
    for layout in ("flat", "auto"):
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=22, syncmer_size=12, use_syncmer=True,
            layout_mode=layout, tmax=64 if layout == "auto" else 0,
            layout_file=str(tmp_path / f"{layout}.out")))
        dhs = [DeviceHIXF.from_hixf(index.hixf, dev) for dev in ("cpu", cuda)]
        out = [dh.e2e_async(packed, lengths, index.scheme, th)()
               for dh in dhs]
        for a, b in zip(out[0][:5], out[1][:5]):
            np.testing.assert_array_equal(a, b)
        assert (out[1][4] == dsync.hash_cap(L, 22, 12, 5)
                and (out[1][0][:, 0] > 0).all())


@pytest.mark.parametrize("name", ["plain_kmer", "scaled_minimizer"])
def test_long_minimizer_steps_match_cpu_twins(cuda, tmp_path, name):
    """Minimiser and plain k-mer reads past L_CAP on the card: K5 on the
    whole bucket (H = L hash slots, past 32,768), then K2 on a flat index
    and the grouped descent (K2n) on a hierarchy, equal the CPU twins."""
    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.search.thresholds import Thresholder

    from .util import make_ref_set

    _, k, _, _, window, scaling = STEP_SCHEMES[name]
    rng = np.random.default_rng(13)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=80,
                                      genome_len=36000)
    seqs = [(g * 2)[o:o + n] for g, o, n in zip(
        genomes.values(), range(0, 36000, 2000), (33000, 40000, 70000) * 6)]
    L = dsync.bucket_len(max(len(q) for q in seqs))
    packed, lengths = dsync.pack_reads(seqs, L)
    th = Thresholder.make(k, window, 0.04, -1.0, False)
    for layout in ("flat", "auto"):
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=k, window_size=window, scaling=scaling,
            layout_mode=layout, tmax=64 if layout == "auto" else 0,
            layout_file=str(tmp_path / f"{layout}.out")))
        dhs = [DeviceHIXF.from_hixf(index.hixf, dev) for dev in ("cpu", cuda)]
        out = [dh.e2e_async(packed, lengths, index.scheme, th)()
               for dh in dhs]
        for a, b in zip(out[0][:5], out[1][:5]):
            np.testing.assert_array_equal(a, b)
        assert out[1][4] == L and (out[1][0][:, 0] > 0).all()


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
    kw = dict(k=22, s=12, t=5, hcap=dsync.hash_cap(L, 22, 12, 5), topk=16)
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


@pytest.mark.parametrize("variant", ["slab", "thin", "split", "rows"])
@pytest.mark.parametrize("bl,bins,G", [(1203, 4096, 1), (1000, 1000, 8),
                                       (300, 1000, 8), (3000, 4096, 8),
                                       (2000, 5000, 1), (134, 16384, 1)])
def test_k2_routes_match_twin(cuda, variant, bl, bins, G):
    """Every K2 route over G stacked tables (a thin slab of 4 bins and the
    split variant forced where a wider slab would take the shape; 1,000
    and 5,000 bins leave a ragged last slab): a read of 2,048 valid
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
    b = probe.slab_bins(3 * bl, Bp, H, cuda)
    assert b == {1203: 64, 1000: 64, 300: 128, 3000: 16, 2000: 32,
                 134: 128}[bl]
    before = dict(probe.k2_counts.VARIANTS)
    if variant == "thin":
        got = probe._launch(*args, seed, bl, 4)
    else:
        got = probe.k2_counts(*args, seed, bl, variant=variant)
    want = probe.probe_counts_grouped_plain(*args, seed, bl)
    torch.cuda.synchronize()
    if variant != "thin":
        assert probe.k2_counts.VARIANTS[variant] == before.get(variant,
                                                               0) + 1
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


@pytest.mark.parametrize("G,S,Bpad", [(1, 3 * 2**24, 64),
                                       (2, 3 * 2**20, 512)])
def test_rows_kernels_past_2_31_bytes(cuda, G, S, Bpad):
    """K2n's rows mode (run sums and counts) and K2's rows route on
    stacks of more than 2^31 bytes (the at-scale root is 2.4 GB): every
    hash's third row lies past byte 2^31 of the [3 x 2^24, 64] table, and
    the second [3 x 2^20, 512] table starts 1.6 GB in; half of the valid
    hashes are planted in every bin."""
    p = synth.big_table_problem(cuda, G, S, Bpad, seed=G)
    assert p["tables"].numel() > 2**31
    assert probe.narrow_mode(S, Bpad, cuda) == "rows"
    args = (p["hi"], p["lo"], p["valid"], p["tables"], p["active"])
    sb = (p["seed"], p["block_length"])
    want = probe.probe_counts_grouped_plain(*args, *sb)
    want_sums = probe.probe_run_sums_grouped_plain(*args, *p["runs"], *sb)
    got = [probe.k2n_counts(*args, *sb, mode="rows"),
           probe.k2_counts(*args, *sb, variant="rows"),
           probe.k2n_run_sums(*args, *p["runs"], *sb, mode="rows")]
    torch.cuda.synchronize()
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    assert torch.equal(got[2], want_sums)
    assert int(want[:, 0].min()) > 0 and int(want[:, 1].abs().sum()) == 0


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
    """Past a 16-bin slab a table takes a thin slab for reads of 8,192
    hash slots and the rows route for shorter ones, and past the thin
    slabs' rule (2-byte slabs) or the slab route's reach (196,608 slots:
    u16 positions within a segment) the rows route."""
    z = torch.zeros((2, 8192), dtype=torch.int32, device=cuda)
    table = torch.zeros((1, 15000, 2000), dtype=torch.uint8, device=cuda)
    assert probe.slab_bins(15000, 2000, 8192, cuda) == 8
    assert probe.slab_bins(15000, 2000, 8191, cuda) == 0
    before = dict(probe.k2_counts.VARIANTS)
    out = probe.probe_counts_grouped(z, z, z.bool(), table, None, 1, 5000)
    assert probe.k2_counts.VARIANTS["slab"] == before.get("slab", 0) + 1
    assert int(out.abs().sum()) == 0
    short = z[:, :2048].contiguous()
    probe.probe_counts_grouped(short, short, short.bool(), table, None, 1,
                               5000)
    rows = before.get("rows", 0)
    assert probe.k2_counts.VARIANTS["rows"] == rows + 1
    # past the rule (2-byte slabs, which the card measured slower than
    # the rows route) and past the slab route's reach
    wide = torch.zeros((1, 80_000, 528), dtype=torch.uint8, device=cuda)
    assert probe.slab_bins(80_000, 528, 8192, cuda) == 0
    assert probe.slab_bins(80_000, 528, 8192, cuda, fit=True) == 2
    probe.probe_counts_grouped(z, z, z.bool(), wide, None, 1, 26000)
    assert probe.k2_counts.VARIANTS["rows"] == rows + 2
    tall = torch.zeros((1, 196_608, 528), dtype=torch.uint8, device=cuda)
    assert probe.slab_bins(196_608, 528, 8192, cuda, fit=True) == 0
    out = probe.probe_counts_grouped(z, z, z.bool(), tall, None, 1, 65536)
    assert probe.k2_counts.VARIANTS["rows"] == rows + 3
    assert int(out.abs().sum()) == 0
    with pytest.raises(ValueError, match="do not fit the slab route"):
        probe.k2_counts(z, z, z.bool(), tall, None, 1, 65536, variant="slab")


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
    kw = dict(k=k, s=s, t=t, hcap=dsync.hash_cap(L, k, s, t), topk=topk)
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


# ------------------------------------------- K5 and the non-syncmer steps --
K5_SCHEMES = [(20, 20), (20, 26), (18, 26), (32, 40)]  # (k, window)


@pytest.mark.parametrize("k,window", K5_SCHEMES)
@pytest.mark.parametrize("L", [256, 512, 1024, 2048, 4096, 8192, 16384,
                               32768])
def test_k5_matches_twin(cuda, L, k, window):
    """K5 against minimizer_kmers_plain, bit for bit (0 where nothing is
    emitted), at every length bucket; window == k is the plain k-mer path
    (w' = 1), k = 32 sets the seed's top bit."""
    rng = np.random.default_rng(L + 7 * k + window)
    seqs = reads(rng, L) + [b"ACG" * (window // 3), ACGT[
        rng.integers(0, 4, window - 1)].tobytes()]  # windows that never fill
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    before = extract.minimizer_kmers.LAUNCHES
    got = extract.minimizer_kmers(pk, ln, k, window)
    want = dsync.minimizer_kmers_plain(pk, ln, k, window)
    torch.cuda.synchronize()
    assert extract.minimizer_kmers.LAUNCHES == before + 1
    # (hi, lo, valid, n_emit, n_unique): with no keep valid is the
    # emission mask and n_unique the emission count
    for a, b in zip(got, (*want, want[3])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert int(got[3].max()) > 0


KEEP_THRESHOLDS = {  # name -> scale_thresh: FracMinHash scalings, keep-all
    "scaling2": 2, "scaling3": 3, "scaling1000": 1000, "all": None}


@pytest.mark.parametrize("name", list(KEEP_THRESHOLDS))
@pytest.mark.parametrize("L", [256, 512, 1024, 2048, 4096, 8192, 16384,
                               32768])
def test_k5_keep_matches_twin(cuda, L, name):
    """K5 with the FracMinHash keep against its twin
    (minimizer_kmers_plain followed by scaling_keep), bit for bit, at
    every length bucket for every scheme of K5_SCHEMES; a threshold of
    2^64 - 1 keeps every emission."""
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64

    s = KEEP_THRESHOLDS[name]
    thresh = (1 << 64) - 1 if s is None else scaling_threshold_u64(s)
    rng = np.random.default_rng(L + len(name))
    packed, lengths = dsync.pack_reads(reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    for k, window in K5_SCHEMES:
        got = extract.minimizer_kmers(pk, ln, k, window, thresh)
        want = extract.minimizer_hashes_plain(pk, ln, k, window, thresh)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b)
        n_emit, n_unique = int(got[3].sum()), int(got[4].sum())
        if s is None:
            assert n_unique == n_emit > 0
        elif s < 1000:
            assert 0 < n_unique < n_emit


@pytest.mark.parametrize("k,window", [(2, 5), (20, 21), (20, 22),
                                      (20, 23), (16, 60), (20, 1200)])
@pytest.mark.parametrize("L", [1024, 8192, 32768])
def test_k5_window_widths(cuda, L, k, window):
    """K5 with and without the keep against its twin at the window widths
    its window pass treats apart: w' - 1 = 1 and 2 (direct), 3 (the split
    with no halo before the last position), 4 and wide windows whose
    values come from the cluster's earlier blocks, one of them past a
    whole tile (w' = 1,181 against tiles of 1,024 and 4,096)."""
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64

    rng = np.random.default_rng(L + k + window)
    seqs = reads(rng, L) + [ACGT[rng.integers(0, 4, L)].tobytes()
                            for _ in range(4)]
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    for thresh in (0, scaling_threshold_u64(3)):
        got = extract.minimizer_kmers(pk, ln, k, window, thresh)
        want = extract.minimizer_hashes_plain(pk, ln, k, window, thresh)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert (int(got[4].max()) > 0) == (window < L)


def test_k5_launches_no_other_kernel(cuda):
    """One call of K5, the keep included, counts one launch, runs no
    PyTorch operation but allocations (torch.empty) and puts one kernel on
    the card, K5's: no fill of its counts, no keep pass, no memset.  The
    host's operations are the profiler's CPU events; the card's are
    CUPTI's device events, with the card idle before the call and
    synchronized inside the profile after it, and with an empty profile
    just before that takes in whatever an earlier profile left behind.  A
    failure lists every event of both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64

    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rng = np.random.default_rng(3)
    packed, lengths = dsync.pack_reads(reads(rng, 8192), 8192)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    for window in (20, 26):
        args = (pk, ln, 20, window, scaling_threshold_u64(3))
        extract.minimizer_kmers(*args)  # built and loaded
        torch.cuda.synchronize()
        with profile(activities=both):
            torch.cuda.synchronize()
        before = extract.minimizer_kmers.LAUNCHES
        with profile(activities=both) as prof:
            extract.minimizer_kmers(*args)
            torch.cuda.synchronize()
        events = [(e.name, str(e.device_type)) for e in prof.events()]
        ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
        card = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        assert ops and ops <= {"aten::empty", "aten::empty_like",
                               "aten::empty_strided"}, events
        assert len(card) == 1 and "minimizer_kernel" in card[0], events
        assert extract.minimizer_kmers.LAUNCHES == before + 1


def test_k5_checks_inputs(cuda):
    pk = torch.zeros((2, 64), dtype=torch.uint8, device=cuda)
    ln = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported scheme"):
        extract.minimizer_kmers(pk, ln, 20, 19)
    with pytest.raises(ValueError, match="lengths"):
        extract.minimizer_kmers(pk, ln.long(), 20, 26)
    with pytest.raises(ValueError, match="uint64"):
        extract.minimizer_kmers(pk, ln, 20, 26, 1 << 64)
    with pytest.raises(ValueError, match="multiple of 16"):
        extract.minimizer_kmers(pk[:, :63].contiguous(), ln, 20, 26)
    long = torch.zeros((1, 65536 // 4), dtype=torch.uint8, device=cuda)
    got = extract.minimizer_kmers(long, ln[:1], 20, 26)  # past one span
    assert got[0].shape == (1, 65536) and got[3].tolist() == [0]
    empty = extract.minimizer_kmers(pk[:0], ln[:0], 20, 26)
    assert empty[0].shape == (0, 256) and empty[3].shape == (0,)
    assert empty[4].shape == (0,)


def long_minimizer_reads(rng, L: int) -> list[bytes]:
    """Reads of a bucket past K5's span of 32,768 positions: random reads
    of L/2 to L bases, and reads with N runs and homopolymers across every
    32,768-position boundary and a tandem repeat (the windows tied there),
    one that ends just past a boundary, one of k - 1 bases."""
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(L // 2, L + 1)))]
            .tobytes() for _ in range(3)]
    for fill in (b"N", b"A", b"T"):
        arr = ACGT[rng.integers(0, 4, L)].copy()
        for b in range(32768, L, 32768):
            arr[b - 40:b + 40] = ord(fill)
            arr[b + 100:b + 103] = ord("N")
        seqs.append(arr.tobytes())
    seqs.append((b"ACGTTG" * L)[:L])
    seqs.append(ACGT[rng.integers(0, 4, 32768 + 5)].tobytes())
    return seqs + [b"ACG" * 6, b""]


@pytest.mark.parametrize("k,window", [(20, 20), (20, 26), (32, 40)])
@pytest.mark.parametrize("L", [65504, 1047584])
def test_k5_long_rows_match_twin(cuda, L, k, window):
    """K5 at rows past its span of 32,768 positions (the first bucket past
    L_CAP, 65,504, and the 32-piece bucket of ~1 Mb): a cluster a span,
    the counts summed over the spans, bit-exact to its twin with no keep
    and with the keep of scaling 3; w' = 1, w' = 7 and k = 32."""
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64

    rng = np.random.default_rng(L + k + window)
    packed, lengths = dsync.pack_reads(long_minimizer_reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    for thresh in (0, scaling_threshold_u64(3)):
        before = extract.minimizer_kmers.LAUNCHES
        got = extract.minimizer_kmers(pk, ln, k, window, thresh)
        want = extract.minimizer_hashes_plain(pk, ln, k, window, thresh)
        torch.cuda.synchronize()
        assert extract.minimizer_kmers.LAUNCHES == before + 1
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b)
        assert int(got[3].max()) > 32768 // (window - k + 2)


STEP_SCHEMES = {  # name -> (scheme_kind, k, s, t, window, scaling)
    "minimizer": ("minimizer", 20, 10, 6, 26, 1),
    "plain_kmer": ("minimizer", 20, 10, 6, 20, 1),
    "scaled_syncmer": ("syncmer", 22, 12, 5, 22, 3),
    "scaled_minimizer": ("minimizer", 20, 10, 6, 26, 3),
}


@pytest.mark.parametrize("name", list(STEP_SCHEMES))
def test_nonsyncmer_fused_step_matches_cpu_twins(cuda, name):
    """The flat step on the card (K5 or K1, the FracMinHash keep, K2)
    equals the CPU twins for a minimiser, a plain k-mer and a scaled
    syncmer scheme."""
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64

    kind, k, s, t, window, scaling = STEP_SCHEMES[name]
    rng = np.random.default_rng(len(name))
    L, topk = 2048, 16
    packed, lengths = dsync.pack_reads(reads(rng, L, n=40), L)
    bins, bl = 300, 1500
    table = rng.integers(0, 256, (3 * bl, probe.pad_bins(bins)),
                         dtype=np.uint8)
    table[:, 7] = 0  # a bin every read hits often
    offsets = np.array([0, 3, 4, 10, 100, 250, 300])
    users = np.array([0, -1, 1, 2, 3, 4], dtype=np.int32)
    args = [torch.from_numpy(x) for x in (table, packed, lengths, offsets,
                                          users)]
    kw = dict(k=k, s=s, t=t, topk=topk, scheme_kind=kind, window=window,
              hcap=dsync.hash_cap(L, k, s, t) if kind == "syncmer" else L,
              scale_thresh=scaling_threshold_u64(scaling) if scaling > 1
              else 0)
    before = extract.minimizer_kmers.LAUNCHES
    want = fused_e2e_step(*args, 77, bl, **kw)
    got = fused_e2e_step(*[a.to(cuda) for a in args], 77, bl, **kw)
    assert torch.equal(got.cpu(), want)
    assert (extract.minimizer_kmers.LAUNCHES > before) == (kind != "syncmer")


@pytest.mark.parametrize("name", ["minimizer_scaled", "plain_kmer"])
def test_nonsyncmer_hier_step_matches_cpu_twins(cuda, tmp_path, name):
    """The hierarchical step on the card equals the CPU twins: a scaled
    minimiser hierarchy descends with per-read thresholds computed on the
    host (the count-table packing, fewer than every pair active) and, asked
    for, in the descend-all mode (every pair active, [R, 3*topk + 2]); a
    plain k-mer one with the count table."""
    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device import hixf_search
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.search.thresholds import Thresholder

    from .util import make_ref_set

    scheme = (dict(kmer_size=20, window_size=26, scaling=3)
              if name == "minimizer_scaled"
              else dict(kmer_size=20, window_size=20))
    rng = np.random.default_rng(23)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=100,
                                      genome_len=3000)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        use_syncmer=False, layout_mode="auto", tmax=64,
        layout_file=str(tmp_path / "b.out"), **scheme))
    seqs = [g[o:o + 900] for g in genomes.values() for o in (0, 1500)]
    packed, lengths = dsync.pack_reads(seqs, 1024)
    sch = index.scheme
    th = Thresholder.make(sch.kmer_size, sch.window_size, 0.04, -1.0, False)
    dhs = [DeviceHIXF.from_hixf(index.hixf, dev) for dev in ("cpu", cuda)]
    for da in ((False, True) if name == "minimizer_scaled" else (False,)):
        hixf_search.ACTIVITY.reset()
        out = [dh.e2e_async(packed, lengths, sch, th, descend_all=da)()
               for dh in dhs]
        assert (out[1][5] is None) == (not da)  # descend-all: leaf sums
        for a, b in zip(out[0][:4] + out[0][5:6 if da else 5],
                        out[1][:4] + out[1][5:6 if da else 5]):
            np.testing.assert_array_equal(a, b)
        assert out[1][4] == 1024  # hcap = L
        if name == "minimizer_scaled":
            share = hixf_search.ACTIVITY.share()
            assert share == 1.0 if da else 0 < share < 1.0


def test_per_read_thresholds_from_the_card(cuda):
    """The per-read mode's round trip: n_unique copied from the card to
    pinned host memory (e2e.host_copy, one event), the host thresholds
    uploaded to the card as int32; a length list of the wrong size
    raises."""
    from taxor_tpu_torch.device import e2e

    n_unique = torch.arange(512, dtype=torch.int32, device=cuda) * 3
    got = e2e.host_copy(n_unique)
    np.testing.assert_array_equal(got, np.arange(512) * 3)
    lens = np.arange(512) + 100
    thr = e2e.read_thresholds(lambda c, n: (c + n).astype(np.int32),
                              n_unique, lens)
    assert thr.device.type == "cuda" and thr.dtype == torch.int32
    np.testing.assert_array_equal(thr.cpu().numpy(), np.arange(512) * 4 + 100)
    with pytest.raises(ValueError, match="host lengths"):
        e2e.read_thresholds(lambda c, n: c, n_unique, lens[:10])


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


def diag_probe_inputs(rng, S1, B, bl, R=48, H=512):
    """A random table [S1, B] with a zero last slot, and R reads of random
    p16 words, block-structured p16 and p10 words; n_hash with a read of
    no hash and one past its row of words."""
    from taxor_tpu_torch.tools import probe_bounds as pb

    table = pb.tool_table(rng, S1, B)
    n_hash = rng.integers(0, H + 1, R).astype(np.int32)
    n_hash[:3] = 0, H, H + 100
    w16, w10 = pe.make_inputs(rng, R, H, S1, bl)
    return table, pb.make_inputs(rng, R, H, S1), w16, w10, n_hash


def zero_hit_inputs(S1, B, bl, n, H):
    """Every hash hits every bin (probe_experiments.zero_hit_inputs)."""
    table, w16, w10 = pe.zero_hit_inputs(np.random.default_rng(S1), S1, B,
                                         bl, len(n), H)
    return table, w16, w16, w10, np.array(n, dtype=np.int32)


def check_probe_routes(cuda, inputs, bl, rows, slab, modes, runs):
    """Both probe diagnostics through the shape's pick, which must be the
    slab of ``slab`` bins (0 for rows), or the rows route where ``rows``
    forces it, against their twins, bit-exact, each launch's route
    counted in ROUTES."""
    from taxor_tpu_torch.device import diag

    table, w16r, w16, w10, n_hash = (
        x if torch.is_tensor(x) else torch.from_numpy(x).to(cuda)
        for x in inputs)
    assert diag.slab_bins(*table.shape, diag.smem_per_block(cuda)) == slab
    took = "rows" if rows or not slab else "slab"
    for mode in modes:
        before = diag.probe_bounds.ROUTES.get(took, 0)
        got = diag.probe_bounds(table, w16r, n_hash, mode, _rows=rows)
        want = diag.probe_bounds_plain(table, w16r, n_hash, mode)
        torch.cuda.synchronize()
        assert diag.probe_bounds.ROUTES[took] == before + 1
        assert torch.equal(got, want), mode
    for kw in runs:
        w = w10 if kw.get("layout") == "p10" else w16
        got = diag.probe_experiment(table, w, n_hash, block_length=bl,
                                    _rows=rows, **kw)
        want = diag.probe_experiment_plain(table, w, n_hash, block_length=bl,
                                           **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kw
    return want[0]


# (S1, B, bl, the slab the shape picks on the H100)
DIAG_SHAPES = [(2419, 512, 806, 64),    # the tools' geometry
               (2419, 100, 806, 64),    # a ragged last slab of 36 bins
               (2419, 36, 806, 64),     # one slab, ragged
               (2419, 4096, 806, 64),   # 64 slabs
               (1500, 256, 499, 128),   # slabs of 128 bins
               (2419, 32, 806, 32),
               (10000, 64, 3333, 16),   # slabs of 16 bins
               (10000, 36, 3333, 16),   # 16 bins, a ragged last slab of 4
               (20000, 64, 6666, 0)]    # past the shared memory: rows


# the route the shape picks, and the rows route forced where that is a slab
@pytest.mark.parametrize("rows,S1,B,bl,slab", [
    (rows, *shape) for shape in DIAG_SHAPES
    for rows in ((False, True) if shape[-1] else (False,))])
def test_diag_probe_routes_match_twins(cuda, rows, S1, B, bl, slab):
    from taxor_tpu_torch.device import diag

    inputs = diag_probe_inputs(np.random.default_rng(S1 + B), S1, B, bl)
    modes = [m for m in diag.PROBE_BOUNDS_MODES if m != "lcg" or S1 >= 2048]
    check_probe_routes(cuda, inputs, bl, rows, slab, modes,
                       pe.CHECK_RUNS)


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("S1,B,bl,slab,n,H", [
    (2419, 100, 806, 64, [512, 300, 256, 255, 0], 512),
    (1500, 256, 499, 128, [2048, 1021, 1020, 7], 2048)])
def test_diag_probe_counts_past_255(cuda, rows, S1, B, bl, slab, n, H):
    """Every hash hits every bin: counts up to 512 (a read-lane of
    probe_experiment's slab route writes its counts after 252 hashes,
    then adds to them twice) and 2,048 (probe_bounds' 4 hash-lanes at
    128 bins take three flush rounds of up to 1,020)."""
    inputs = zero_hit_inputs(S1, B, bl, n, H)
    counts = check_probe_routes(cuda, inputs, bl, rows, slab,
                                ("p16", "load1"), pe.CHECK_RUNS[:7])
    assert torch.equal(counts.cpu(), torch.tensor(n)[:, None].expand(-1, B))


def test_diag_probe_experiment_unaligned_words(cuda):
    """Rows of words that 16-byte loads cannot take (H = 516: 129
    fingerprint words; p16 rows of 2H + 2 words; a buffer 4 bytes past
    16-byte alignment): probe_experiment's slab route loads a word at a
    time there, and still equals its twin."""
    rng = np.random.default_rng(44)
    table, _, w16, w10, n_hash = diag_probe_inputs(rng, 2419, 512, 806,
                                                   H=516)
    R = w16.shape[0]
    buf = torch.zeros(R * (w16.shape[1] + 2) + 1, dtype=torch.int32,
                      device=cuda)
    w16o = buf[1:].view(R, -1)  # contiguous, 4 bytes past alignment
    w16o[:, :w16.shape[1]] = torch.from_numpy(w16).to(cuda)
    assert w16o.is_contiguous() and w16o.data_ptr() % 16 == 4
    inputs = (table, w16, w16o, w10, n_hash)
    check_probe_routes(cuda, inputs, 806, False, 64, (), pe.CHECK_RUNS)


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


# every stage and scheme of the stage dump: the per-position tiles and the
# walking thread (emit, pre) over chunks of s-mers, tied reads included
STAGE_SCHEMES = [(22, 12, 5), (32, 15, 1), (15, 2, 14), (21, 11, 11)]


@pytest.mark.parametrize("k,s,t", STAGE_SCHEMES)
@pytest.mark.parametrize("L", [256, 1024, 8192, 32768])
def test_diag_stages_match_twins_every_scheme(cuda, L, k, s, t):
    from taxor_tpu_torch.device import diag

    rng = np.random.default_rng(L + 100 * k + t)
    packed, lengths = dsync.pack_reads(reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    want = diag.extract_stages_plain(pk, ln, k, s, t)
    before = diag.extract_stage.LAUNCHES
    for stage in diag.STAGES:
        got = diag.extract_stage(pk, ln, k, s, t, stage)
        torch.cuda.synchronize()
        assert torch.equal(got, want[stage]), stage
    assert diag.extract_stage.LAUNCHES == before + len(diag.STAGES)
    assert want["emit"].sum() > 0


def test_diag_stages_refuse_64_bit_smers(cuda):
    """The stage dump reads 32-bit s-mers: s >= 16, which K1 takes through
    its 64-bit instance, raises instead of dumping wrong stages."""
    from taxor_tpu_torch.device import diag

    pk = torch.zeros((2, 64), dtype=torch.uint8, device=cuda)
    ln = torch.full((2,), 256, dtype=torch.int32, device=cuda)
    before = diag.extract_stage.LAUNCHES
    with pytest.raises(ValueError, match="s <= 15"):
        diag.extract_stage(pk, ln, 28, 18, 5, "emit")
    assert diag.extract_stage.LAUNCHES == before


def test_diag_stage_smem_equals_the_kernels(cuda):
    from taxor_tpu_torch.device import cuda_build, diag

    lib = cuda_build.diag_lib()
    for L in (16, 48, 256, 1024, 8192, 32768):
        for i, stage in enumerate(diag.STAGES):
            assert lib.extract_stage_smem(L, i) == diag.stage_smem(L, stage)


@pytest.mark.parametrize("Wd,phases", [(17, [15, 3, 11, 0]), (1, range(16)),
                                       (33, list(range(16)) * 5),
                                       (16, [5, 5]), (64, [12, 0, 13])])
def test_diag_window_shift_widths_and_phase_lists(cuda, Wd, phases):
    """Widths that are no multiple of 4 (head and tail words), a reordered
    and a repeated phase list, 80 phases (two launches)."""
    from taxor_tpu_torch.device import diag

    rng = np.random.default_rng(Wd)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (37, Wd)).astype(
        np.int32)).to(cuda)
    before = diag.window_shift.LAUNCHES
    got = diag.window_shift(x, phases)
    torch.cuda.synchronize()
    assert torch.equal(got, diag.window_shift_plain(x, phases))
    assert diag.window_shift.LAUNCHES == before + 1


# ------------------------------------------------------ the bins shards --
def shard(nb, b):
    from taxor_tpu_torch.device.distributed import Mesh

    return Mesh(1, nb, 0, b, torch.device("cuda"))


@pytest.mark.parametrize("mode", ["smem", "rows"])
@pytest.mark.parametrize("nb", [2, 3])
def test_k2n_run_sums_on_shard_clipped_runs(cuda, nb, mode):
    """K2n's run sums on each bins shard of a [72, 216, 512] stack, its
    runs clipped to the shard (sharding.shard_runs): empty runs, runs
    that start at the shard's column 0 and runs cut at its last, each
    against the twin; over the shards they add up to the whole stack's
    run sums."""
    from taxor_tpu_torch.device import sharding

    rng = np.random.default_rng(nb)
    G, bins = 72, 512
    keys, tables, seed = narrow_inputs(rng, G, bins)
    active = rng.random((G, keys[0].shape[0])) < 0.6
    active[0, 0] = True
    run_off, run_s, run_e = run_csr(rng, G, bins)
    dev = [torch.from_numpy(x).to(cuda) for x in (*keys, active, run_off)]
    whole = probe.probe_run_sums_grouped_plain(
        *dev[:3], torch.from_numpy(tables).to(cuda), dev[3], dev[4],
        torch.from_numpy(run_s).to(cuda), torch.from_numpy(run_e).to(cuda),
        seed, 72)
    total = torch.zeros_like(whole)
    kinds = {"empty": 0, "at 0": 0}
    for b in range(nb):
        mesh = shard(nb, b)
        tbl = sharding.shard_ixf(mesh, tables)
        s_np, e_np = sharding.shard_runs(mesh, tbl.shape[2], run_s, run_e)
        empty = torch.from_numpy(e_np <= s_np).to(cuda)
        kinds["empty"] += int(empty.sum())
        kinds["at 0"] += int(((s_np == 0) & (e_np > 0) & (run_s > 0)).sum())
        s, e = (torch.from_numpy(x).to(cuda) for x in (s_np, e_np))
        before = probe.k2n_counts.LAUNCHES
        got = probe.k2n_run_sums(*dev[:3], tbl, dev[3], dev[4], s, e, seed,
                                 72, mode=mode)
        want = probe.probe_run_sums_grouped_plain(*dev[:3], tbl, dev[3],
                                                  dev[4], s, e, seed, 72)
        torch.cuda.synchronize()
        assert probe.k2n_counts.LAUNCHES == before + 1
        assert torch.equal(got, want)
        assert int(got[empty].abs().sum()) == 0
        total += got
    assert kinds["empty"] > 0 and kinds["at 0"] > 0, kinds
    assert torch.equal(total, whole) and int(whole[0].max()) > 256


@pytest.mark.parametrize("variant", ["slab", "rows"])
def test_k2_on_half_a_flat_table(cuda, variant):
    """K2 on each half (Bpad / 2 = 2,048 columns) of a flat [3,606,
    4,096] table, chip_smoke phase 4's shape cut by a 2-shard mesh: the
    slab route picks its slab for the narrower table, both routes equal
    the twin, and the halves' run sums add up to the whole table's."""
    from taxor_tpu_torch.device import sharding
    from taxor_tpu_torch.device.e2e import run_sums

    rng = np.random.default_rng(2048)
    bl, bins, R, H = 1202, 4096, 24, 1500
    table = rng.integers(0, 256, (3 * bl, bins), dtype=np.uint8)
    table[:, ::5] = 0
    hi, lo = (rng.integers(-2**31, 2**31, (R, H), dtype=np.int32)
              for _ in range(2))
    valid = rng.random((R, H)) < 0.7
    args = [torch.from_numpy(x).to(cuda) for x in (hi, lo, valid)]
    seed = int(rng.integers(0, 2**63))
    offsets = np.concatenate([[0], np.cumsum(rng.integers(1, 9, 900))])
    offsets = np.append(offsets[offsets < bins], bins)
    whole = run_sums(probe.probe_counts_plain(
        *args, torch.from_numpy(table).to(cuda), seed, bl),
        torch.from_numpy(offsets).to(cuda))
    total = torch.zeros_like(whole)
    for b in range(2):
        mesh = shard(2, b)
        tbl = sharding.shard_ixf(mesh, table)
        assert tbl.shape == (3 * bl, 2048)
        assert probe.slab_bins(3 * bl, 2048, H, cuda) > 0
        got = probe.k2_counts(*args, tbl[None], None, seed, bl,
                              variant=variant)[0]
        want = probe.probe_counts_plain(*args, tbl, seed, bl)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        local = sharding.shard_runs(mesh, 2048, offsets)[0]
        total += run_sums(got, torch.from_numpy(local).to(cuda))
    assert torch.equal(total, whole)


def test_dryrun_multichip_on_the_card(cuda):
    """The sharded count and fused steps over two ranks, each equal to
    the single-device step: on gloo where the ranks share a card, on
    NCCL where each has its own."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "taxor_tpu_torch.tools.dryrun_multichip",
         "--ranks", "2", "--device", "cuda"], cwd=repo, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["count_step"] and out["fused_step"]
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert out["mesh"].endswith(f"collectives on {backend}")


def test_wide_root_changes_route_when_sharded(cuda):
    """A 529-bin root (phase 7b's width) takes K2's dense counts and
    their segment sums whole, and K2n on each of its two 272-bin shards;
    the shards' run sums add up to the whole root's."""
    from taxor_tpu_torch.device import sharding

    rng = np.random.default_rng(529)
    bins, bl, R, H = 529, 400, 20, 900
    Bp = probe.pad_bins(bins)
    tables = np.zeros((1, 3 * bl, Bp), dtype=np.uint8)
    tables[0, :, :bins] = rng.integers(0, 256, (3 * bl, bins))
    tables[0, :, ::6] = 0
    hi, lo = (rng.integers(-2**31, 2**31, (R, H), dtype=np.int32)
              for _ in range(2))
    valid = rng.random((R, H)) < 0.8
    active = rng.random((1, R)) < 0.7
    ends = np.append(np.cumsum(rng.integers(1, 40, 40)), bins)
    ends = np.unique(np.minimum(ends, bins))
    starts = np.concatenate([[0], ends[:-1]])
    args = [torch.from_numpy(x).to(cuda) for x in (hi, lo, valid)]
    act = torch.from_numpy(active).to(cuda)
    off = torch.tensor([0, starts.shape[0]], device=cuda)
    before = probe.k2_counts.LAUNCHES, probe.k2n_counts.LAUNCHES
    whole = probe.probe_run_sums_grouped(
        *args, torch.from_numpy(tables).to(cuda), act, off,
        torch.from_numpy(starts).to(cuda), torch.from_numpy(ends).to(cuda),
        77, bl)
    assert probe.k2_counts.LAUNCHES == before[0] + 1
    total = torch.zeros_like(whole)
    for b in range(2):
        mesh = shard(2, b)
        tbl = sharding.shard_ixf(mesh, tables)
        assert tbl.shape[2] == 272
        s, e = (torch.from_numpy(x).to(cuda) for x in sharding.shard_runs(
            mesh, 272, starts, ends))
        total += probe.probe_run_sums_grouped(*args, tbl, act, off, s, e, 77,
                                              bl)
    torch.cuda.synchronize()
    assert probe.k2n_counts.LAUNCHES == before[1] + 2
    assert torch.equal(total, whole) and int(whole.max()) > 0


def test_host_routing_rules_equal_the_card(cuda):
    """The layout cost model's host copies of probe_slab_bins (at 2,048,
    8,191 and 8,192 hash slots a read), probe_slab_fit and
    probe_narrow_mode (hixf/device_cost.py) on chip_smoke phase 16a's
    grid."""
    from taxor_tpu_torch.hixf import device_cost

    bad = [(s, b) for s, b in device_cost.routing_grid()
           if probe.narrow_mode(s, b, cuda) != device_cost.narrow_mode(s, b)
           or any(probe.slab_bins(s, b, h, cuda)
                  != device_cost.slab_bins(s, b, h)
                  for h in (2048, 8191, 8192))
           or probe.slab_bins(s, b, 0, cuda, fit=True)
           != device_cost.slab_fit(s, b)]
    assert not bad, bad[:10]


# bench_gather_scale's routes at reduced shapes: (route, G, S, bins,
# active, runs)
GATHER_ROUTES = [("k2_rows", 1, 1 << 18, 64, "all", False),
                 ("k2_slab", 1, 3606, 1024, "all", False),
                 ("k2_thin", 1, 39621, 1024, "all", False),
                 ("k2n_rows", 4, 10524, 512, "one", True),
                 ("k2n_rows", 1, 1 << 18, 256, "all", False),
                 ("k2n_smem", 32, 216, 512, 40, True),
                 ("k2n_smem", 8, 800, 256, "all", True),
                 ("call", 8, 216, 512, "none", True),
                 ("descent", 8, 216, 512, "none", True)]


@pytest.mark.parametrize("rt,G,S,bins,active,runs", GATHER_ROUTES)
def test_bench_gather_scale_routes_match_twins(cuda, rt, G, S, bins,
                                               active, runs):
    from taxor_tpu_torch.tools import bench_gather_scale as bgs

    sh = bgs.Shape((rt,), G, S, bins, R=128, H=256, nvalid=200,
                   active=active, runs=runs)
    x = bgs.inputs(np.random.default_rng(G + S), sh, cuda)
    got = bgs.route_fn(rt, x, sh, True)(x["hi"])
    want = bgs.plain_of(rt, x, sh)(x["hi"])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    call, dev = bgs.model_ms(rt, x, sh)
    assert call >= dev > 0
