"""Minimiser and plain k-mer reads longer than L_CAP on the port's device
engine: K5 takes a read's whole length bucket (a cluster a span of 32,768
positions on the card), then the fused step at H = L hash slots.  On the
CPU the plain twins run.  Held to the JAX package and the host layers
with inputs made from a seed with numpy:

  - the twin of K5 (``minimizer_kmers_plain``) at buckets past L_CAP
    (65,504 and the 130,976 of reads of ~100 kb) against the JAX
    ``minimizer_kmers`` (XLA on the CPU);
  - each read's emitted values after the FracMinHash keep, duplicates
    kept, in position order, against ``search_hashes`` of the port's host
    layer and of the JAX package, with N runs, homopolymers and a tandem
    repeat across every 32,768-position boundary;
  - the count-indexed threshold table (``count_thresholds``) against the
    scalar loop it replaces, at every count;
  - the TSV of the port's device engine equals the JAX package's
    ``--engine host``, flat and hierarchical, in the count-table and the
    per-read descent, every read past L_CAP counted in
    ``ROUTES['long_fused']`` and none hashed on the host; a plain k-mer
    read from a short genome taken as circular counts past 10^5 in one
    bin; under reads x bins meshes of gloo ranks (tests/torch_world.py)
    the same.
"""

import os

import numpy as np
import pytest
import torch

from taxor_tpu.hash import device_syncmer as jax_dsync
from taxor_tpu.hash import schemes as jax_schemes
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device import extract
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash import schemes
from taxor_tpu_torch.hash.schemes import scaling_threshold_u64
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.search.thresholds import Thresholder, count_thresholds
from taxor_tpu_torch.tools import synth

from .torch_world import agreed, run_world
from .util import make_ref_set

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
K5_SCHEMES = [(20, 20), (20, 26), (18, 26), (32, 40)]  # (k, window)
# the first bucket past L_CAP, and the bucket of reads of ~100 kb
LONG_BUCKETS = (dsync.bucket_len(dsync.L_CAP + 1), dsync.bucket_len(100_000))
SPAN = 32768  # end positions of one K5 cluster (csrc/minimizer.cu kSpan)
MESHES = [(1, 2), (2, 1), (2, 2)]
MESH_IDS = [f"{a}x{b}" for a, b in MESHES]


def boundary_reads(rng, L: int) -> list[bytes]:
    """Reads of bucket L: a random one of L/2 to L bases; N runs, a
    homopolymer and a tandem repeat across every SPAN-position boundary
    (ties in every window there); one just past L_CAP; the full bucket."""
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(L // 2, L)))]
            .tobytes()]
    for fill in (b"N", b"A", b"AC"):
        arr = ACGT[rng.integers(0, 4, L - 7)].copy()
        for b in range(SPAN, L, SPAN):
            run = np.frombuffer(fill * 80, np.uint8)[:80]
            arr[b - 45:b + 35] = run
            arr[b + 50:b + 52] = ord("N")
        seqs.append(arr.tobytes())
    seqs.append(ACGT[rng.integers(0, 4, dsync.L_CAP + 5)].tobytes())
    seqs.append(ACGT[rng.integers(0, 4, L)].tobytes())
    return seqs


@pytest.mark.parametrize("L", LONG_BUCKETS)
@pytest.mark.parametrize("k,window", K5_SCHEMES)
def test_long_twin_matches_jax(k, window, L):
    """emit and n_emit exact everywhere, values exact where emitted, 0
    elsewhere, at buckets past L_CAP (the JAX package hashed such reads
    on the host, but its XLA extractor takes any length)."""
    rng = np.random.default_rng(L + 7 * k + window)
    packed, lengths = dsync.pack_reads(boundary_reads(rng, L), L)
    want = [np.asarray(x) for x in jax_dsync.minimizer_kmers(
        packed, lengths, k, window)]
    hi, lo, emit, n_emit = (x.numpy() for x in dsync.minimizer_kmers_plain(
        torch.from_numpy(packed), torch.from_numpy(lengths), k, window))
    np.testing.assert_array_equal(emit, want[2])
    np.testing.assert_array_equal(n_emit, want[3])
    np.testing.assert_array_equal(hi[emit], want[0].view(np.int32)[emit])
    np.testing.assert_array_equal(lo[emit], want[1].view(np.int32)[emit])
    assert not hi[~emit].any() and not lo[~emit].any()
    assert n_emit.min() > 0


def emitted(hi, lo, valid) -> np.ndarray:
    """uint64 values of one row's valid slots, in position order."""
    return ((hi[valid].view(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo[valid].view(np.uint32).astype(np.uint64))


@pytest.mark.parametrize("scaling", [1, 3])
@pytest.mark.parametrize("k,window", K5_SCHEMES)
def test_long_emissions_equal_search_hashes(k, window, scaling):
    """K5's contract on the CPU (the twin, then the keep) at the bucket of
    ~100 kb reads: each read's valid values in position order are the
    vector ``search_hashes`` gives, duplicates kept, in the port's host
    layer and in the JAX package; n_emit counts the emissions and
    n_unique the values kept."""
    L = LONG_BUCKETS[1]
    seqs = boundary_reads(np.random.default_rng(k + window + scaling), L)
    packed, lengths = dsync.pack_reads(seqs, L)
    thresh = scaling_threshold_u64(scaling) if scaling > 1 else 0
    hi, lo, valid, n_emit, n_unique = (x.numpy() for x in (
        extract.minimizer_kmers(torch.from_numpy(packed),
                                torch.from_numpy(lengths), k, window,
                                thresh)))
    port = schemes.search_hashes(
        seqs, schemes.HashScheme.make(k, 10, window, False, scaling))
    ref = jax_schemes.search_hashes(
        seqs, jax_schemes.HashScheme.make(k, 10, window, False, scaling))
    for r in range(len(seqs)):
        got = emitted(hi[r], lo[r], valid[r])
        np.testing.assert_array_equal(got, port[r])
        np.testing.assert_array_equal(got, ref[r])
        assert n_unique[r] == got.shape[0] <= n_emit[r]
        assert (n_unique[r] < n_emit[r]) == (scaling > 1)


@pytest.mark.parametrize("kind,args,n", [
    ("kmer_model", (20, 20, 0.04, -1.0, False), dsync.bucket_len(10**6)),
    ("kmer_model", (32, 32, 0.0, -1.0, False), 70_000),
    ("kmer_model", (12, 12, 0.15, -1.0, False), 70_000),
    ("percentage", (20, 26, 0.04, 0.3, False), 70_000),
    ("syncmer_model", (22, 22, 0.04, -1.0, True), 70_000)])
def test_count_thresholds_equal_the_loop(kind, args, n):
    """The count-indexed descent table, computed over all counts at once,
    equals the scalar loop the device search ran before (one
    ``thresholder.get`` a count, clamped to int32) at every count up to
    n, the first up to the ~1 Mb bucket's 1,047,584; the k-mer model's
    wrapped ("impossible") thresholds included."""
    th = Thresholder.make(*args)
    assert th.kind == kind
    loop = np.array([min(th.get(c, 0.0), 2**31 - 1) for c in range(n + 1)],
                    dtype=np.int64)
    want = np.clip(loop, 0, 2**31 - 1).astype(np.int32)
    got = count_thresholds(th, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ searches --
SCHEMES = {"plain_kmer": dict(kmer_size=20, window_size=20),
           "minimizer": dict(kmer_size=20, window_size=26, scaling=3)}
# (scheme, layout, percentage): the descent each takes on a hierarchy
CASES = {"plain_kmer_flat": ("plain_kmer", "flat", -1.0),
         "plain_kmer_tree": ("plain_kmer", "auto", -1.0),  # count table
         "minimizer_flat": ("minimizer", "flat", -1.0),
         "minimizer_tree": ("minimizer", "auto", -1.0),  # per-read
         "minimizer_tree_pct": ("minimizer", "auto", 0.3)}  # count table
BIG_COUNT = 100_000


def long_read_set(root: str):
    """100 genomes of 3 kb (a hierarchy at --tmax 64); 40 reads of 1.5 kb
    and reads past L_CAP from genomes taken as circular, 1%
    substitutions: 33 kb, 40 kb, 70 kb and one of 150 kb (every k-mer of
    its genome ~50 times: a bin's plain k-mer count past 10^5), and one
    of 50 kb with N runs across every 32,768-position boundary."""
    rng = np.random.default_rng(2020)
    tsv, gdir, genomes = make_ref_set(root, rng, n_species=100,
                                      genome_len=3000)
    accs = sorted(genomes)
    recs = []
    for j in range(40):
        acc = accs[int(rng.integers(0, len(accs)))]
        off = int(rng.integers(0, 1500))
        recs.append((f"short{j}_{acc}",
                     synth.mutate(rng, genomes[acc][off:off + 1500], 0.02)))
    for j, n in enumerate((33000, 40000, 70000, 150000, 50000)):
        acc = accs[7 * j + 3]
        seq = genomes[acc] * (n // len(genomes[acc]) + 2)
        off = int(rng.integers(0, len(genomes[acc])))
        read = bytearray(synth.mutate(rng, seq[off:off + n], 0.01))
        if j == 4:
            for b in range(SPAN, n, SPAN):
                read[b - 30:b + 30] = b"N" * 60
        recs.append((f"long{j}_{acc}", bytes(read)))
    reads = os.path.join(root, "reads.fasta")
    synth.write_fasta(reads, recs)
    return tsv, gdir, reads, len(recs), sum(len(q) > dsync.L_CAP
                                            for _, q in recs)


@pytest.fixture(scope="module")
def long_searches(tmp_path_factory):
    """Each scheme's flat and hierarchical index of long_read_set, and the
    JAX host engine's TSV of every case."""
    root = str(tmp_path_factory.mktemp("torch_long_minimizer"))
    tsv, gdir, reads, n_reads, n_long = long_read_set(root)
    out = {"reads": reads, "n_reads": n_reads, "n_long": n_long,
           "root": root, "idx": {}, "jax": {}}
    for name, (scheme, layout, pct) in CASES.items():
        key = (scheme, layout)
        if key not in out["idx"]:
            idx = os.path.join(root, f"{scheme}_{layout}.taxor.npz")
            built = run_build(BuildConfig(
                input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
                layout_mode=layout, tmax=64 if layout == "auto" else 0,
                layout_file=os.path.join(root, f"{scheme}_{layout}.out"),
                **SCHEMES[scheme]))
            assert (len(built.hixf.ixfs) > 1) == (layout == "auto")
            out["idx"][key] = idx
        path = os.path.join(root, f"{name}_jax_host.tsv")
        jax_pipeline.run_search(jax_pipeline.SearchConfig(
            index_file=out["idx"][key], query_file=reads, report_file=path,
            engine="host", percentage=pct))
        with open(path, "rb") as fh:
            out["jax"][name] = fh.read()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_search_equals_jax_host(long_searches, name):
    """The port's device TSV (its twins) == its host engine's == the JAX
    host engine's, every read past L_CAP on K5's whole bucket and the
    fused step, none hashed on the host; the mode the hierarchy descends
    in is the one named; a plain k-mer read counts past 10^5 in a bin."""
    scheme, layout, pct = CASES[name]
    idx = long_searches["idx"][scheme, layout]
    root, reads = long_searches["root"], long_searches["reads"]
    texts = {}
    for engine in ("device", "host"):
        path = os.path.join(root, f"{name}_{engine}.tsv")
        pipeline.ROUTES.reset()
        pipeline.run_search(pipeline.SearchConfig(
            index_file=idx, query_file=reads, report_file=path,
            engine=engine, percentage=pct), device="cpu")
        if engine == "device":
            routes = dict(pipeline.ROUTES.counts)
        with open(path, "rb") as fh:
            texts[engine] = fh.read()
    assert texts["device"] == texts["host"] == long_searches["jax"][name]
    assert routes["fused"] == long_searches["n_reads"]
    assert routes["long_fused"] == long_searches["n_long"]
    assert routes["host_hashes"] == 0
    rows = [r.split("\t") for r in texts["host"].decode().splitlines()[1:]]
    hits = {r[0].split("_")[0] for r in rows if r[1] != "-"}
    assert {f"long{j}" for j in range(5)} <= hits
    if scheme == "plain_kmer":
        assert max(int(r[7]) for r in rows if r[1] != "-") > BIG_COUNT
    if layout == "auto":
        from taxor_tpu_torch.hixf.index import load_index

        index = load_index(idx)
        sch = index.scheme
        th = Thresholder.make(sch.kmer_size, sch.window_size, 0.04, pct,
                              sch.use_syncmer)
        L = dsync.bucket_len(150_000)
        mode = DeviceHIXF.from_hixf(index.hixf, "cpu").e2e_step(
            sch, th, L=L)[2]
        assert mode == ("per_read" if name == "minimizer_tree"
                        else "count_table")


@pytest.fixture(scope="module")
def long_world(long_searches):
    """One gloo world of 4 ranks: the sharded engine's search of the long
    reads on each scheme's hierarchy and the plain k-mer flat index, on
    every mesh."""
    cases = [{"kind": "search", "name": name,
              "index": long_searches["idx"][CASES[name][:2]],
              "query": long_searches["reads"],
              "percentage": CASES[name][2]}
             for name in ("plain_kmer_flat", "plain_kmer_tree",
                          "minimizer_tree")]
    out = os.path.join(long_searches["root"], "world")
    run_world(4, cases, MESHES, out)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ["plain_kmer_flat", "plain_kmer_tree",
                                  "minimizer_tree"])
def test_sharded_search_takes_k5_whole(long_searches, long_world, name,
                                       mesh):
    """Under a reads x bins mesh K5's long rows are gathered over the
    reads row whole: every read past L_CAP takes the fused step, and the
    TSV is the JAX host engine's."""
    got = agreed(long_world, name, mesh)
    assert int(got["route_long_fused"]) == long_searches["n_long"]
    assert int(got["route_host_hashes"]) == 0
    assert pipeline.HEADER + str(got["tsv"]) == long_searches["jax"][name] \
        .decode()
