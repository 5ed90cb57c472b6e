"""Syncmer schemes with s >= 16, which K1 and syncmer_track take through
their 64-bit s-mer instances (taxor_tpu_torch/csrc/extract.cu), and the
per-scheme hash capacity (hash/device_syncmer.hash_cap), on the CPU
twins: the hashes of every read, pieces past L_CAP included, against the
JAX package's host hashing (its int32 device lanes stop at s = 15), and
whole searches against its ``--engine host``, byte for byte."""

import os

import numpy as np
import pytest
import torch

from taxor_tpu.hash import device_syncmer as jax_dsync
from taxor_tpu.hash import schemes as jax_schemes
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device import e2e
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.utils.u64 import join32

from .util import make_reads, make_ref_set, mutate

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# (k, s) of the 64-bit instances; (30, 29) is the widest the CLI builds
WIDE = [(22, 16), (28, 18), (18, 16), (30, 29)]


def hard_reads(rng, k: int) -> list[bytes]:
    """Random reads of several buckets and the tracker's tied cases (a
    homopolymer run, a tandem repeat, two letters, Ns, a read without a
    k-mer), then a read past L_CAP with a homopolymer across its cut."""
    seqs = [ACGT[rng.integers(0, 4, int(n))].tobytes()
            for n in rng.integers(200, 5000, 10)]
    arr = ACGT[rng.integers(0, 4, 3000)].copy()
    arr[500:560] = ord("A")
    arr[rng.integers(0, 3000, 60)] = ord("N")
    seqs += [arr.tobytes(), (b"ACGTTG" * 400)[:2000],
             np.frombuffer(b"AT", np.uint8)[rng.integers(0, 2, 1500)]
             .tobytes(), b"G" * 900, b"ACGT" * ((k - 1) // 4)]
    long = ACGT[rng.integers(0, 4, 40000)].copy()
    c = dsync.PIECE_STRIDE + k - 1  # the second piece's first window
    long[c - 120:c + 120] = ord("C")
    return seqs + [long.tobytes()]


@pytest.mark.parametrize("k,s", WIDE)
def test_wide_smer_hashes_equal_jax_host_hashing(k, s):
    """Each read's hashes from the device engine's extraction (K1's twin,
    by length bucket; the read past L_CAP in pieces, then their union)
    equal ``taxor_tpu.hash.schemes.search_hashes``, n_unique their
    count, and no read emits past the scheme's capacity."""
    seqs = hard_reads(np.random.default_rng(k * 100 + s), k)
    scheme = jax_schemes.HashScheme.make(k, s, None, True)
    want = jax_schemes.search_hashes(seqs, scheme)
    t = scheme.t_syncmer
    buckets: dict[int, list[int]] = {}
    for i, q in enumerate(seqs):
        buckets.setdefault(dsync.bucket_len(len(q)), []).append(i)
    assert max(buckets) > dsync.L_CAP  # a bucket of pieces
    for L, idx in buckets.items():
        packed, lengths = dsync.pack_reads([seqs[i] for i in idx], L)
        hcap = dsync.hash_cap(L, k, s, t)
        hi, lo, valid, n_unique, n_emit = e2e._syncmer_hashes(
            torch.from_numpy(packed), torch.from_numpy(lengths), k, s, t,
            hcap)
        for r, i in enumerate(idx):
            got = np.sort(join32(hi[r], lo[r])[valid[r]].numpy()
                          .astype(np.uint64))
            np.testing.assert_array_equal(got, want[i])
            assert int(n_unique[r]) == len(want[i])
            assert 0 <= int(n_emit[r]) <= hcap


def test_hash_cap_closed_form():
    """hash_cap(L, k, s, t) = P * max(128, Lp / 4, min(sort_width(Lp),
    128 * ceil(2 Lp / (128 w)))), w = k - s + 1, Lp = min(L, L_CAP): the
    JAX package's static L/4 wherever w >= 8 (k = 22, s = 12 in every
    bucket), larger for narrow schemes, never past K1's sort buffer."""
    buckets = [1 << j for j in range(8, 16)] + [dsync.pieces_len(P)
                                                for P in (2, 4, 32)]
    for L in buckets:
        P, Lp = dsync.bucket_pieces(L), min(L, dsync.L_CAP)
        base = P * max(128, Lp // 4)
        assert dsync.hash_cap(L, 22, 12, 5) == base
        if L <= dsync.L_CAP:
            assert base == jax_dsync.hash_cap(L)
        for k in range(3, 33):
            for s in range(2, k):
                t = (k - s + 1) // 2
                w = k - s + 1
                W = dsync.sort_width(Lp, k, s, t)
                want = P * max(128, Lp // 4,
                               min(W, 128 * -(-2 * Lp // (128 * w))))
                got = dsync.hash_cap(L, k, s, t)
                assert got == want
                if w >= 8:
                    assert got == base
                assert got <= P * max(128, Lp // 4, W)
        # k - s + 1 <= 3: about twice the density of 1 / w
        assert dsync.hash_cap(L, 16, 14, 1) == P * min(
            dsync.sort_width(Lp, 16, 14, 1), 128 * -(-2 * Lp // 384))
        assert dsync.hash_cap(L, 30, 29, 1) == P * Lp
        if Lp >= 512:
            assert dsync.hash_cap(L, 16, 14, 1) > base
            assert dsync.hash_cap(L, 18, 16, 1) > base


@pytest.fixture(scope="module")
def ref_set(tmp_path_factory):
    """72 genomes of 2 kb (a hierarchy at --tmax 64), a read of 900 b from
    every other one and a read of 40 kb (past L_CAP) strung from 20 of
    them, 2% substitutions."""
    root = str(tmp_path_factory.mktemp("torch_wide"))
    rng = np.random.default_rng(28)
    tsv, gdir, genomes = make_ref_set(root, rng, n_species=72,
                                      genome_len=2000)
    picked = {a: genomes[a] for a in sorted(genomes)[::2]}
    reads = make_reads(root, rng, picked, n_reads_per_genome=1,
                       read_len=900, error_rate=0.02)
    strung = b"".join(genomes[a] for a in sorted(genomes)[:20])
    with open(reads, "ab") as fh:
        fh.write(b">long0\n" + mutate(rng, strung, 0.02) + b"\n")
    return root, tsv, gdir, reads, len(picked) + 1


@pytest.mark.parametrize("layout", ["flat", "auto"])
def test_wide_smer_search_equals_jax_host(ref_set, layout):
    """k = 28, s = 18: the port's device engine (the fused step on the
    CPU twins), its host engine and the JAX package's host engine write
    the same TSV, every read fused (the one past L_CAP in pieces), none
    hashed on the host, none past the hash capacity."""
    root, tsv, gdir, reads, n_reads = ref_set
    idx = os.path.join(root, f"wide_{layout}.taxor.npz")
    built = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
        kmer_size=28, syncmer_size=18, use_syncmer=True, layout_mode=layout,
        tmax=64 if layout == "auto" else 0,
        layout_file=(os.path.join(root, f"wide_{layout}.out")
                     if layout == "auto" else "")))
    assert (len(built.hixf.ixfs) > 1) == (layout == "auto")
    out = {}
    for pkg, engine in (("torch", "device"), ("torch", "host"),
                        ("jax", "host")):
        path = os.path.join(root, f"wide_{layout}_{pkg}_{engine}.tsv")
        if pkg == "torch":
            if engine == "device":
                pipeline.ROUTES.reset()
            pipeline.run_search(pipeline.SearchConfig(
                index_file=idx, query_file=reads, report_file=path,
                engine=engine), device="cpu")
            if engine == "device":
                routes = dict(pipeline.ROUTES.counts)
        else:
            jax_pipeline.run_search(jax_pipeline.SearchConfig(
                index_file=idx, query_file=reads, report_file=path,
                engine=engine))
        with open(path, "rb") as fh:
            out[pkg, engine] = fh.read()
    assert out["torch", "device"] == out["torch", "host"] == out["jax", "host"]
    assert out["jax", "host"].count(b"\n") > n_reads
    assert routes["fused"] == n_reads and routes["long_fused"] == 1
    assert routes["host_hashes"] == 0 and routes["hcap_overflow"] == 0
