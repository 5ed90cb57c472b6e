"""The plain twin of kernel K1 (taxor_tpu_torch.device.extract) against
the JAX package: the fused Pallas extractor in interpret mode on the reads
it does not flag, and the exact XLA tracker (syncmer_kmers -> dedup_kmers
-> wyhash64) on every read, tie-flagged ones included.  Then a numpy
transcription of the kernels' position-parallel tracker (csrc/tracker.cuh)
against both."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from taxor_tpu.device.pallas_extract import (_TIE_SENTINEL,
                                             syncmer_hashes_fused)
from taxor_tpu.hash import device_syncmer as jdsync
from taxor_tpu.utils.u64jnp import wyhash64 as jwyhash64
from taxor_tpu_torch.device import extract
from taxor_tpu_torch.hash import device_syncmer as dsync

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def reads(seed, L, n=24):
    """Random reads plus homopolymer, tandem-repeat, N and short ones."""
    rng = np.random.default_rng(seed)
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(20, L + 1)))].tobytes()
            for _ in range(n)]
    arr = ACGT[rng.integers(0, 4, L)].copy()
    arr[40:75] = ord("A")
    arr[200:230] = ord("T")
    seqs += [arr.tobytes(), (b"ACGTTG" * L)[:L], (b"AC" * L)[:L - 3],
             b"A" * 60 + ACGT[rng.integers(0, 4, L // 2)].tobytes(),
             b"NNAG" * (L // 8), b"", b"ACGT" * 5]
    return seqs


def twin(seqs, L, k, s, t, hcap):
    packed, lengths = dsync.pack_reads(seqs, L)
    out = extract.syncmer_hashes(torch.from_numpy(packed),
                                 torch.from_numpy(lengths), k, s, t, hcap)
    return packed, lengths, [x.numpy() for x in out]


def hash_set(hi, lo, valid):
    return set(zip(hi[valid].view(np.uint32).tolist(),
                   lo[valid].view(np.uint32).tolist()))


@pytest.mark.parametrize("k,s,L", [(22, 12, 512), (16, 8, 256),
                                   (32, 15, 256)])
def test_twin_equals_exact_tracker(k, s, L):
    t = (k - s + 1) // 2
    hcap = dsync.hash_cap(L, k, s, t)
    seqs = reads(k * 100 + s, L)
    packed, lengths, (hi, lo, valid, nu, ne) = twin(seqs, L, k, s, t, hcap)
    khi, klo, emit = jdsync.syncmer_kmers(jnp.asarray(packed),
                                          jnp.asarray(lengths), k, s, t)
    chi, clo, jvalid, jnu, jne = jdsync.dedup_kmers(
        khi, klo, emit, hcap, jdsync.emission_min_gap(k, s, t),
        sort_impl="xla")
    jhi, jlo = jwyhash64(chi, clo)
    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(ne, np.asarray(jne))
    np.testing.assert_array_equal(nu, np.asarray(jnu))
    # same slots: both keep the emitted k-mers in ascending order
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(hi[valid],
                                  np.asarray(jhi).view(np.int32)[valid])
    np.testing.assert_array_equal(lo[valid],
                                  np.asarray(jlo).view(np.int32)[valid])
    assert (hi[~valid] == 0).all() and (lo[~valid] == 0).all()
    assert ne.max() <= dsync.max_emissions(L, k, s, t)


def test_twin_hcap_overflow_keeps_smallest_kmers():
    """Gap-1 scheme (t = 1): emissions exceed hcap; the first hcap sorted
    slots and the full n_unique/n_emit still equal the exact tracker."""
    k, s, t, L = 14, 12, 1, 1024
    hcap = 128
    seqs = reads(5, L, n=8)
    packed, lengths, (hi, lo, valid, nu, ne) = twin(seqs, L, k, s, t, hcap)
    assert (ne > hcap).any()
    khi, klo, emit = jdsync.syncmer_kmers(jnp.asarray(packed),
                                          jnp.asarray(lengths), k, s, t)
    chi, clo, jvalid, jnu, jne = jdsync.dedup_kmers(khi, klo, emit, hcap,
                                                    1, sort_impl="xla")
    jhi, _ = jwyhash64(chi, clo)
    np.testing.assert_array_equal(ne, np.asarray(jne))
    np.testing.assert_array_equal(nu, np.asarray(jnu))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    np.testing.assert_array_equal(hi[valid],
                                  np.asarray(jhi).view(np.int32)[valid])


def test_twin_equals_fused_pallas_on_unflagged_reads():
    k, s, t, L = 22, 12, 5, 512
    hcap = dsync.hash_cap(L, k, s, t)
    seqs = reads(k + s, L, n=16)
    packed, lengths, (hi, lo, valid, nu, ne) = twin(seqs, L, k, s, t, hcap)
    fhi, flo, fv, fnu, fne = map(np.asarray, syncmer_hashes_fused(
        jnp.asarray(packed), jnp.asarray(lengths), k, s, t, hcap,
        interpret=True))
    flagged = fne == int(_TIE_SENTINEL)
    assert flagged.any()  # the tie cases are in the set ...
    assert (~flagged).sum() >= len(seqs) // 2  # ... and the minority
    for r in np.nonzero(~flagged)[0]:
        assert hash_set(hi[r], lo[r], valid[r]) == hash_set(
            fhi[r].view(np.int32), flo[r].view(np.int32), fv[r]), r
        assert (nu[r], ne[r]) == (fnu[r], fne[r]), r


with open(os.path.join(GOLDEN, "syncmer.json")) as _fh:
    _CASES = [c for c in json.load(_fh)
              if set(c["seq"]) <= set("ACGT") and len(c["seq"]) <= 4096]


@pytest.mark.parametrize("case", _CASES, ids=[c["name"] for c in _CASES])
def test_twin_matches_reference_scanner(case):
    """Hash sets of the reference's own scanner (tests/golden, ACGT-only
    sequences: dna4 and dna5 agree there)."""
    seq = case["seq"].encode()
    L = dsync.pad_len_bucket(max(1, len(seq)))
    _, _, (hi, lo, valid, nu, _) = twin([seq], L, case["k"], case["s"],
                                        case["t"], dsync.hash_cap(
                                            L, case["k"], case["s"],
                                            case["t"]))
    got = np.sort((hi[0][valid[0]].view(np.uint32).astype(np.uint64)
                   << np.uint64(32))
                  | lo[0][valid[0]].view(np.uint32).astype(np.uint64))
    np.testing.assert_array_equal(got, np.array(sorted(case["hashes"]),
                                                dtype=np.uint64))
    assert nu[0] == len(case["hashes"])


def test_wrapper_refuses_other_devices():
    packed = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        extract.syncmer_hashes(packed, lengths, 22, 12, 5, 128)


def test_sort_width_covers_every_emission():
    for (k, s, t) in [(22, 12, 5), (14, 12, 1), (16, 8, 4)]:
        for L in (256, 4096, 32768):
            W = extract.sort_width(L, k, s, t)
            assert W & (W - 1) == 0
            assert W >= dsync.max_emissions(L, k, s, t)


# --------------------------------------- the kernel's tracker, in numpy --
# A transcription of csrc/tracker.cuh as K1 and syncmer_track run it:
# staged words with two zero words either side, s-mers and k-mers by
# funnel shifts, window outcomes (step 3), and the tied runs resolved by
# the sequential rule from the unique window before them (step 4), with
# the kernel's own bit-mask run finding.  The kernel runs only on the
# card; this holds its algorithm here.
M32 = 0xFFFFFFFF


def _brev32(x):
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & M32


def _rev2_32(x):  # __brev, then swap the bits of each pair
    b = _brev32(x)
    return ((b >> 1) & 0x55555555) | ((b & 0x55555555) << 1)


def _funnel(lo, hi, sh):  # __funnelshift_r
    return ((hi << 32 | lo) >> (sh & 31)) & M32


def staged_words(packed_row):
    words = np.ascontiguousarray(packed_row).view("<u4").astype(np.uint64)
    z = np.zeros(2, dtype=np.uint64)
    return np.concatenate([z, words, z])


def kernel_smers(sw, L, s):
    q = np.arange(L, dtype=np.uint64) - np.uint64(s - 1) + np.uint64(32)
    j = (q >> np.uint64(4)).astype(np.int64)
    raw = _funnel(sw[j], sw[j + 1], np.uint64(2) * (q & np.uint64(15)))
    fwd = _rev2_32(raw) >> np.uint64(32 - 2 * s)
    rc = ~raw & np.uint64((1 << (2 * s)) - 1)
    return np.minimum(fwd, rc)


def kernel_kmers(sw, L, k):
    q = np.arange(L, dtype=np.uint64) - np.uint64(k - 1) + np.uint64(32)
    j = (q >> np.uint64(4)).astype(np.int64)
    sh = np.uint64(2) * (q & np.uint64(15))
    lo = _funnel(sw[j], sw[j + 1], sh)
    hi = _funnel(sw[j + 1], sw[j + 2], sh)
    kmask = np.uint64((1 << (2 * k)) - 1)
    rc = ~(hi << np.uint64(32) | lo) & kmask
    fwd = (_rev2_32(lo) << np.uint64(32) | _rev2_32(hi)) >> np.uint64(
        64 - 2 * k)
    return np.minimum(fwd, rc)


def tracker_step(i, k, s, t, ys, qv, qp):
    """tracker.cuh tracker_step: (qv, qp, emitted)."""
    w = k - s + 1
    if i == k - 1:
        qv = M32
        for j in range(w):
            if ys[s - 1 + j] < qv:
                qv, qp = ys[s - 1 + j], j
    elif qp == i - k:
        qv = M32
        for j in range(w - 1, -1, -1):
            if ys[i - w + 1 + j] < qv:
                qv, qp = ys[i - w + 1 + j], i - k + 1 + j
    elif ys[i] < qv:
        qv, qp = ys[i], i - s + 1
    return qv, qp, qp == i - k + t


def _words(mask):
    """bool [n] -> bit i%32 of word i//32, as Python ints."""
    pad = np.zeros(-len(mask) % 32, dtype=bool)
    bits = np.packbits(np.concatenate([mask, pad]), bitorder="little")
    return [int(x) for x in bits.view("<u4")]


def window_outcomes(ys, n, k, s, t, L):
    """Step 3: (emit, tied, uncertain) bool [L], zero outside [k-1, n)."""
    w = k - s + 1
    out = [np.zeros(L, dtype=bool) for _ in range(3)]
    if n < k:
        return out
    ends = np.arange(k - 1, n)
    win = np.lib.stride_tricks.sliding_window_view(ys, w)[ends - w + 1]
    m = win.min(axis=1)
    at = win == m[:, None]
    lm = ends - w + 1 + at.argmax(axis=1)
    rm = ends - at[:, ::-1].argmax(axis=1)
    off = ends - w + t
    tied = lm != rm
    out[0][ends] = ~tied & (lm == off)
    out[1][ends] = tied
    out[2][ends] = tied & (ys[off] == m)
    return out


def resolve_tied_runs(ys, emit, tied, unc, n, k, s, t):
    """Step 4 on bit-mask words (emit is updated); returns the windows
    replayed."""
    nw = (n + 31) // 32
    replayed = 0
    for j in range(nw):
        tj = tied[j]
        starts = tj & ~((tj << 1) & M32 | (tied[j - 1] >> 31 if j else 0))
        while starts:
            b = (starts & -starts).bit_length() - 1
            starts &= starts - 1
            a, last = 32 * j + b, -1
            for q in range(j, nw):
                frm = (M32 << (b if q == j else 0)) & M32
                ends = ~tied[q] & frm
                first_end = (ends & -ends).bit_length() - 1
                in_run = frm & ((1 << first_end) - 1) if ends else frm
                u = unc[q] & in_run
                if u:
                    last = 32 * q + u.bit_length() - 1
                if ends:
                    break
            if last < 0:
                continue
            qv, qp = 0, a - 1 - k  # as if the held minimum had slid out
            i = a if a == k - 1 else a - 1
            while i <= last:  # step only where the holder slides out
                qv, qp, e = tracker_step(i, k, s, t, ys, qv, qp)
                if e:
                    emit[i >> 5] |= 1 << (i & 31)
                e = qp + k - t  # the window where the holder emits
                if i < e <= last:
                    emit[e >> 5] |= 1 << (e & 31)
                i = qp + k
            replayed += last - a + 1
    return replayed


def kernel_emissions(packed, lengths, k, s, t):
    """(emit bool [R, L], kmer uint64 [R, L], replayed int [R]) as the
    kernel's steps 1-5 compute them."""
    R, L = packed.shape[0], packed.shape[1] * 4
    emit = np.zeros((R, L), dtype=bool)
    kmer = np.zeros((R, L), dtype=np.uint64)
    replayed = np.zeros(R, dtype=np.int64)
    for r in range(R):
        n = max(0, min(int(lengths[r]), L))
        sw = staged_words(packed[r])
        ys = kernel_smers(sw, L, s)
        kmer[r] = kernel_kmers(sw, L, k)
        e, d, u = (_words(x) for x in window_outcomes(ys, n, k, s, t, L))
        replayed[r] = resolve_tied_runs([int(y) for y in ys], e, d, u, n,
                                        k, s, t)
        bits = np.array(e, dtype="<u4").view(np.uint8)
        emit[r] = np.unpackbits(bits, bitorder="little")[:L].astype(bool)
    return emit, kmer, replayed


SCHEMES = [(22, 12, 5), (16, 8, 4), (32, 15, 9), (14, 12, 1), (22, 12, 1),
           (22, 12, 11), (9, 2, 4), (12, 3, 5)]


def tie_reads(rng, L):
    """Reads the tracker's history matters on: two-letter alphabets, a
    first window tied at the emission offset, homopolymers, a short
    tandem repeat."""
    two = [np.frombuffer(a, np.uint8)[rng.integers(0, 2, L - 5 * j)]
           .tobytes() for j, a in enumerate((b"AC", b"AT", b"GT", b"CG"))]
    return two + [b"A" * 40 + ACGT[rng.integers(0, 4, L - 40)].tobytes(),
                  b"T" * L, b"C" * (L - 7), (b"ACA" * L)[:L]]


def assert_model_matches(seqs, L, k, s, t, jax_too=True):
    packed, lengths = dsync.pack_reads(seqs, L)
    emit, kmer, replayed = kernel_emissions(packed, lengths, k, s, t)
    tk, te = dsync.syncmer_kmers(torch.from_numpy(packed),
                                 torch.from_numpy(lengths), k, s, t)
    np.testing.assert_array_equal(emit, te.numpy())
    np.testing.assert_array_equal(kmer.view(np.int64), tk.numpy())
    if jax_too:
        khi, klo, je = jdsync.syncmer_kmers(jnp.asarray(packed),
                                            jnp.asarray(lengths), k, s, t)
        np.testing.assert_array_equal(emit, np.asarray(je))
        jk = (np.asarray(khi).astype(np.uint64) << np.uint64(32)
              | np.asarray(klo).astype(np.uint64))
        # the JAX package leaves k-mers ending before k-1 unspecified
        np.testing.assert_array_equal(kmer[:, k - 1:], jk[:, k - 1:])
    return packed, lengths, emit, replayed


@pytest.mark.parametrize("k,s,t", SCHEMES)
def test_kernel_tracker_model_matches_exact_trackers(k, s, t):
    """The decomposition (parallel window outcomes, tied runs replayed)
    and the kernel's funnel-shift s-mers and k-mers equal the JAX
    package's syncmer_kmers and the port's twin, on random, homopolymer,
    tandem-repeat, N, two-letter and first-window-tied reads."""
    L = 256
    rng = np.random.default_rng(k * 1000 + s * 10 + t)
    seqs = reads(k + s + t, L, n=6) + tie_reads(rng, L)
    packed, lengths, emit, replayed = assert_model_matches(seqs, L, k, s, t)
    homo = seqs.index(b"T" * L)
    assert replayed[homo] == L - k + 1  # tied everywhere: the whole read
    sw = staged_words(packed[homo])
    ys = kernel_smers(sw, L, s)
    assert (ys[s - 1:] == 0).all()
    # a read with no uncertain window replays nothing
    for r in range(len(seqs)):
        n = int(lengths[r])
        _, _, unc = window_outcomes(kernel_smers(staged_words(packed[r]), L,
                                                 s), n, k, s, t, L)
        assert (replayed[r] == 0) == (not unc.any()), r
    if s <= 3:  # ties are everywhere: most reads take the resolver
        assert (replayed > 0).sum() >= len(seqs) // 2
    assert emit.any()


def test_kernel_tracker_model_first_window_tied():
    """A first window whose minimum is tied at the emission offset: the
    leftmost minimum holds (t = w puts the offset at its rightmost)."""
    k, s = 22, 12
    for t in (1, 5, 11):
        seq = b"A" * (s + 11) + b"CGTTGCAGGCTTACG" * 10
        _, _, emit, replayed = assert_model_matches([seq], 256, k, s, t)
        assert replayed[0] > 0


def test_kernel_tracker_model_counts_no_replay_on_random_reads():
    k, s, t, L = 22, 12, 5, 512
    rng = np.random.default_rng(3)
    seqs = [ACGT[rng.integers(0, 4, L)].tobytes() for _ in range(4)]
    _, _, _, replayed = assert_model_matches(seqs, L, k, s, t,
                                             jax_too=False)
    assert (replayed == 0).all()


_ALPHABETS = [b"ACGT", b"AC", b"AT", b"A", b"ACN"]


@settings(max_examples=40, deadline=None, derandomize=True)
@given(scheme=st.sampled_from(SCHEMES),
       alphabet=st.sampled_from(_ALPHABETS),
       length=st.integers(0, 256),
       seed=st.integers(0, 2**32 - 1))
def test_kernel_tracker_model_hypothesis(scheme, alphabet, length, seed):
    k, s, t = scheme
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    seq = alpha[rng.integers(0, len(alpha), length)].tobytes()
    assert_model_matches([seq], 256, k, s, t)


def test_all_tied_reads_are_tied_in_every_window():
    """The worst-case batch of tools/time_extract and chip_smoke.py: every
    window of every read tied, so each read is one run the resolver
    replays."""
    from taxor_tpu_torch.tools.time_extract import all_tied_reads

    k, s, t, L = 22, 12, 5, 512
    seqs = all_tied_reads(np.random.default_rng(1), L, 10)
    packed, lengths = dsync.pack_reads(seqs, L)
    _, _, replayed = kernel_emissions(packed, lengths, k, s, t)
    for r in range(len(seqs)):
        ys = kernel_smers(staged_words(packed[r]), L, s)
        _, tied, unc = window_outcomes(ys, L, k, s, t, L)
        assert tied[k - 1:].all() and unc.any()
        assert replayed[r] >= L - k + 1 - (k - s)
