"""The minimiser and plain k-mer schemes and FracMinHash on the port's flat
fused step, against the JAX package: the twin of K5
(``minimizer_kmers_plain``) against the JAX ``minimizer_kmers`` and the
host oracle, the scaling keep against the JAX ``_scaling_keep``, the flat
step's packed output against the JAX step's (Pallas in interpret mode),
and the device engine's TSV against the host engine's.  Every comparison
is exact: integer or byte equality."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.apps.build import BuildConfig, run_build
from taxor_tpu.device import e2e as jax_e2e
from taxor_tpu.device.pallas_probe import (choose_bin_tile4,
                                           prepare_fingerprints)
from taxor_tpu.hash import device_syncmer as jax_dsync
from taxor_tpu.hash.encode import encode_dna4
from taxor_tpu.hash.minimizer import minimiser_hashes
from taxor_tpu.hash.schemes import scaling_threshold_u64
from taxor_tpu.io.fastx import read_all
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu.utils.u64np import wyhash64
from taxor_tpu_torch.device import extract
from taxor_tpu_torch.device.e2e import fused_e2e_step
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.search.pipeline import _pairs_from_e2e, _read_threshold
from taxor_tpu_torch.search.thresholds import Thresholder
from taxor_tpu_torch.utils.u64 import split32

from .util import make_reads, make_ref_set, write_fasta

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def hard_reads(rng, k, window, L):
    """Random reads of many lengths (none with a k-mer, windows that never
    fill, the full bucket) and the hard cases: homopolymers (every window
    tied), tandem repeats, two-letter alphabets, N codes (packed as A), a
    first window tied at every offset."""
    lens = [0, k - 1, k, window - 1, window, window + 1, 173, L // 2, L]
    seqs = [ACGT[rng.integers(0, 4, n)].tobytes() for n in lens]
    arr = ACGT[rng.integers(0, 4, L)].copy()
    arr[rng.integers(0, L, L // 20)] = ord("N")
    arr[30:90] = ord("C")
    seqs += [arr.tobytes(), b"A" * L, (b"ACGTTG" * L)[:L - 3],
             b"A" * (window + 3) + ACGT[rng.integers(0, 4, 200)].tobytes()]
    for pair in (b"AC", b"GT"):
        two = np.frombuffer(pair, np.uint8)
        seqs.append(two[rng.integers(0, 2, L - 11)].tobytes())
    return seqs


def values(hi, lo, emit):
    """uint64 values of the emitted slots of one row."""
    return ((hi[emit].view(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo[emit].view(np.uint32).astype(np.uint64))


@pytest.mark.parametrize("k,window", [(20, 20), (18, 26), (20, 26), (32, 40),
                                      (2, 5)])
def test_minimizer_twin_matches_jax(k, window):
    """emit and n_emit exact everywhere, values exact where emitted, 0
    elsewhere; k = 32 puts the seed's top bit into every value (an
    unsigned compare), window == k is the plain k-mer path (w' = 1)."""
    rng = np.random.default_rng(k * 100 + window)
    for L in (256, 1024):
        packed, lengths = dsync.pack_reads(hard_reads(rng, k, window, L), L)
        want = [np.asarray(x) for x in jax_dsync.minimizer_kmers(
            packed, lengths, k, window)]
        hi, lo, emit, n_emit = (x.numpy() for x in dsync.minimizer_kmers_plain(
            torch.from_numpy(packed), torch.from_numpy(lengths), k, window))
        assert hi.dtype == lo.dtype == n_emit.dtype == np.int32
        np.testing.assert_array_equal(emit, want[2])
        np.testing.assert_array_equal(n_emit, want[3])
        np.testing.assert_array_equal(hi[emit], want[0].view(np.int32)[emit])
        np.testing.assert_array_equal(lo[emit], want[1].view(np.int32)[emit])
        assert not hi[~emit].any() and not lo[~emit].any()
        assert n_emit.max() > 0


@pytest.mark.parametrize("k,window", [(20, 20), (22, 22), (16, 24), (22, 30),
                                      (31, 41)])
def test_minimizer_twin_matches_host_oracle(k, window):
    """The port's twin of test_device_syncmer.py::TestDeviceMinimizer::
    test_matches_host_oracle: the emitted value sequence of each read
    equals the host oracle's, duplicates kept."""
    rng = np.random.default_rng(17)
    seqs = [
        rng.choice(ACGT, size=n).tobytes()
        for n in (k - 1, k, window, window + 1, 173, 500, 1000)
    ] + [b"A" * 300, b"ACGT" * 100]
    L = dsync.pad_len_bucket(max(len(s) for s in seqs))
    packed, lengths = dsync.pack_reads(seqs, L)
    hi, lo, emit, n_emit = (x.numpy() for x in dsync.minimizer_kmers_plain(
        torch.from_numpy(packed), torch.from_numpy(lengths), k, window))
    for r, s in enumerate(seqs):
        want = minimiser_hashes(encode_dna4(s), k, window)
        assert n_emit[r] == want.shape[0], r
        np.testing.assert_array_equal(values(hi[r], lo[r], emit[r]), want)


@pytest.mark.parametrize("wprime", [2, 7, 40])
def test_host_emissions_match_jax(monkeypatch, wprime):
    """The port's host rule (each window's leftmost argmin, vectorised in
    chunks, here of 7 windows) emits what the JAX package's loop over the
    reference's holder rule emits: values with many ties, random uint64
    values, a constant run, a single window."""
    from taxor_tpu.hash import minimizer as jax_minimizer
    from taxor_tpu_torch.hash import minimizer

    monkeypatch.setattr(minimizer, "_WINDOW_CHUNK", 7)
    rng = np.random.default_rng(wprime)
    for v in (rng.integers(0, 5, 3000).astype(np.uint64),
              rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64,
                           endpoint=True),
              np.full(100, 9, dtype=np.uint64),
              rng.integers(0, 3, wprime).astype(np.uint64),
              rng.integers(0, 3, wprime - 1).astype(np.uint64)):
        np.testing.assert_array_equal(
            minimizer.minimiser_emissions(v, wprime),
            jax_minimizer.minimiser_emissions(v, wprime))


def keep_both(vals: np.ndarray, thresh: int):
    """(port keep, JAX keep) of uint64 values at threshold thresh."""
    hi, lo = split32(torch.from_numpy(vals.view(np.int64)))
    got = extract.scaling_keep(hi, lo, thresh).numpy()
    want = np.asarray(jax_e2e._scaling_keep(
        jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        thresh))
    return got, want


@pytest.mark.parametrize("s", [2, 3, 7, 1000])
def test_scaling_keep_matches_jax(s):
    """wyhash64(value) <= T as uint64, T = scaling_threshold_u64(s), on
    values with and without the top bit set."""
    rng = np.random.default_rng(s)
    vals = rng.integers(0, 2**64 - 1, 4000, dtype=np.uint64, endpoint=True)
    got, want = keep_both(vals, scaling_threshold_u64(s))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_scaling_keep_at_the_threshold(offset):
    """Values whose hash is T + 1, T and T - 1 (T = hash + offset): kept
    iff the hash is at most T, in both packages."""
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 2**64 - 1, 64, dtype=np.uint64, endpoint=True)
    for v in vals[:16]:
        h = int(wyhash64(np.array([v], dtype=np.uint64))[0])
        thresh = min(max(h + offset, 0), 2**64 - 1)
        got, want = keep_both(vals, thresh)
        np.testing.assert_array_equal(got, want)
        assert got[vals == v].all() == (offset >= 0)


# ----------------------------------------------------------- flat indexes --
SCHEMES = {  # name -> build scheme
    "minimizer": dict(kmer_size=18, window_size=26, use_syncmer=False),
    "plain_kmer": dict(kmer_size=20, window_size=20, use_syncmer=False),
    "scaled_syncmer": dict(kmer_size=18, syncmer_size=8, use_syncmer=True,
                           scaling=3),
    "scaled_minimizer": dict(kmer_size=18, window_size=24, use_syncmer=False,
                             scaling=3),
}


@pytest.fixture(scope="module")
def flat_sets(tmp_path_factory):
    """One reference set and read set; indexes built on demand."""
    tmp = str(tmp_path_factory.mktemp("torch_minimizer"))
    rng = np.random.default_rng(8)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=12,
                                      genome_len=8000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=4,
                       read_len=1500, error_rate=0.02)
    recs = [(r.id, r.seq) for r in read_all(reads)]
    arr = np.frombuffer(recs[0][1], np.uint8).copy()
    arr[200:260] = ord("A")  # every window tied
    recs.append(("homopolymer_read", arr.tobytes()))
    whole = b"".join(genomes.values())  # over L_CAP: the long buckets
    recs += [("long0", whole[:33000]), ("long1", whole[4000:40000])]
    write_fasta(reads, recs)
    indexes = {}

    def index(name):
        if name not in indexes:
            idx = os.path.join(tmp, f"{name}.taxor.npz")
            indexes[name] = (run_build(BuildConfig(
                input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
                layout_mode="flat", layout_file="", **SCHEMES[name])), idx)
        return indexes[name]

    return index, reads, [s for _, s in recs], tmp


@pytest.mark.parametrize("name", list(SCHEMES))
def test_flat_step_matches_jax(flat_sets, name):
    """The packed [R, 2*topk + 2] output of the port's flat step equals
    the JAX step's (Pallas in interpret mode) on 16 short reads (H = L =
    256 for minimisers)."""
    index_of, _, seqs, _ = flat_sets
    index = index_of(name)[0]
    sch = index.scheme
    seqs = [s[:250] for s in seqs[:15]] + [b"A" * 240]
    L = 256
    packed, lengths = dsync.pack_reads(seqs, L)
    hcap = (dsync.hash_cap(L, sch.kmer_size, sch.syncmer_size, sch.t_syncmer)
            if sch.use_syncmer else L)
    scale = scaling_threshold_u64(sch.scaling) if sch.scaling > 1 else 0
    kind = "syncmer" if sch.use_syncmer else "minimizer"
    kw = dict(k=sch.kmer_size, s=sch.syncmer_size, t=sch.t_syncmer,
              hcap=hcap, topk=8, scheme_kind=kind, window=sch.window_size,
              scale_thresh=scale)
    ixf = index.hixf.ixfs[0]
    fp = prepare_fingerprints(ixf.fingerprints)
    starts, ends, users = index.hixf.runs_of_ixf(0)
    onehot = np.zeros((fp.shape[1] * 4, starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    want = np.asarray(jax_e2e.fused_e2e_step(
        jnp.asarray(fp), jnp.asarray(packed), jnp.asarray(lengths),
        jnp.asarray(onehot), jnp.asarray(users.astype(np.int32)),
        jnp.uint32(ixf.seed >> 32), jnp.uint32(ixf.seed & 0xFFFFFFFF),
        jnp.uint32(ixf.block_length),
        bin_tile4=choose_bin_tile4(*fp.shape), interpret=True, **kw))
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    got = fused_e2e_step(
        dh.table, torch.from_numpy(packed), torch.from_numpy(lengths),
        dh.run_offsets, dh.run_users, dh.seed, dh.block_length,
        prefix_runs=dh.prefix_runs, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] > 0).sum() >= 12  # most reads hit a bin


def final(prs):
    """The emitted (user bin, count) pairs after the 0.8*max rule."""
    if not prs:
        return []
    mx = max(c for _, c in prs)
    return sorted((u, c) for u, c in prs if not float(c) < float(mx) * 0.8)


def assert_decode_matches_host(index, reads, res, thresholder, min_hits):
    """The decoded fused result of every read equals the host oracle's
    emissions, with the same hash count."""
    from taxor_tpu_torch.hash.schemes import search_hashes

    scheme = index.scheme
    vals, users, counts, n_emit, hcap, sums = res
    pairs, hash_counts = _pairs_from_e2e(
        vals, users, counts, n_emit, reads, index, scheme, thresholder,
        index.hixf.user_bin_dfs_order(), hcap,
        sums=sums)
    n_hits = 0
    for r, (seq, hl) in enumerate(zip(reads, search_hashes(reads, scheme))):
        assert hash_counts[r] == hl.shape[0], r
        thr = _read_threshold(thresholder, hl.shape[0], len(seq),
                              scheme.kmer_size)
        expect = index.hixf.membership(hl, thr)
        assert final(pairs[r]) == final(expect), r
        n_hits += bool(expect)
    assert n_hits >= min_hits


def port_index(jax_index):
    """The port's TaxorIndex of a saved JAX-built index file."""
    from taxor_tpu_torch.hixf.index import load_index

    return load_index(jax_index[1])


@pytest.mark.parametrize("name", ["minimizer", "plain_kmer"])
def test_minimizer_fused_matches_host(flat_sets, name):
    """The port's twin of test_hixf_e2e_device.py::
    test_minimizer_fused_matches_host (plain k-mers and windowed
    minimisers on a flat index): the device extraction feeding the flat
    step reproduces the host engine's final emissions exactly."""
    index_of, _, seqs, _ = flat_sets
    index = port_index(index_of(name))
    scheme = index.scheme
    assert dsync.supports_minimizer(scheme)
    th = Thresholder.make(scheme.kmer_size, scheme.window_size, 0.04, -1.0,
                          scheme.use_syncmer)
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    reads = seqs[:48]
    L = dsync.pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = dsync.pack_reads(reads, L)
    res = dh.e2e_async(packed, lengths, scheme, th)()
    assert res[5] is None and res[4] == L  # hcap = L
    assert_decode_matches_host(index, reads, res, th, len(reads) // 2)


@pytest.mark.parametrize("name", ["scaled_syncmer", "scaled_minimizer"])
def test_scaled_fused_matches_host(flat_sets, name):
    """The port's twin of test_schemes_e2e.py::TestDeviceScaling::
    test_scaled_fused_matches_host: FracMinHash on the flat fused step
    reproduces the host engine's emissions exactly."""
    index_of, _, seqs, _ = flat_sets
    index = port_index(index_of(name))
    scheme = index.scheme
    assert scheme.scaling == 3
    assert (dsync.supports(scheme) if scheme.use_syncmer
            else dsync.supports_minimizer(scheme))
    th = Thresholder.make(scheme.kmer_size, scheme.window_size, 0.04, -1.0,
                          scheme.use_syncmer)
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    reads = seqs[:48]
    L = dsync.pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = dsync.pack_reads(reads, L)
    res = dh.e2e_async(packed, lengths, scheme, th)()
    assert_decode_matches_host(index, reads, res, th, 1)


@pytest.mark.parametrize("name", ["plain_kmer", "scaled_minimizer",
                                  "scaled_syncmer"])
def test_search_device_equals_host(flat_sets, name):
    """The whole search: the port's device engine (the fused step on the
    CPU twins) writes the TSV of the JAX host engine byte for byte, every
    read routed fused, the two over L_CAP too (``long_fused``): syncmers
    in pieces, minimisers and plain k-mers on their whole bucket."""
    index_of, reads, seqs, tmp = flat_sets
    idx = index_of(name)[1]
    out = {}
    for pkg, engine in (("jax", "host"), ("torch", "host"),
                        ("torch", "device")):
        path = os.path.join(tmp, f"{name}_{pkg}_{engine}.tsv")
        mod = jax_pipeline if pkg == "jax" else pipeline
        if pkg == "torch" and engine == "device":
            pipeline.ROUTES.reset()
        cfg = mod.SearchConfig(index_file=idx, query_file=reads,
                               report_file=path, engine=engine)
        if pkg == "torch":
            pipeline.run_search(cfg, device="cpu")
        else:
            mod.run_search(cfg)
        with open(path, "rb") as fh:
            out[pkg, engine] = fh.read()
    assert out["torch", "device"] == out["torch", "host"] == out["jax", "host"]
    routes = pipeline.ROUTES.counts
    assert routes["fused"] == len(seqs) and routes["long_fused"] == 2
    assert routes["host_hashes"] == 0


@pytest.mark.parametrize("scheme,fused", [
    (dict(kmer_size=22, syncmer_size=12, use_syncmer=True), True),
    (dict(kmer_size=22, syncmer_size=16, use_syncmer=True), True),
    (dict(kmer_size=20, window_size=26, use_syncmer=False, scaling=3), True),
    (dict(kmer_size=20, window_size=20, use_syncmer=False), True),
    (dict(kmer_size=20, window_size=19, use_syncmer=False), False),
    (dict(kmer_size=22, syncmer_size=22, use_syncmer=True), False),
])
def test_e2e_capable_takes_the_device_schemes(flat_sets, scheme, fused):
    """DeviceHIXF.e2e_capable(thresholder, scheme), the one gate of the
    search, prewarm and the bench, admits exactly the schemes the device
    extractors take: syncmers with 2 <= s < k <= 32 (64-bit s-mers past s
    = 15, where the JAX package's int32 lanes stop), minimisers and plain
    k-mers, scaled or not; s = k has no syncmer and stays on the host."""
    from taxor_tpu_torch.hash.schemes import HashScheme

    sch = HashScheme(**scheme)
    index = port_index(flat_sets[0]("plain_kmer"))
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    assert dh.e2e_capable(None, sch) is fused
    assert (dsync.supports(sch) or dsync.supports_minimizer(sch)) is fused
