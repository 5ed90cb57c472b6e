"""Minimiser and plain k-mer schemes on the port's hierarchical fused step,
against the JAX package: the descend-all chain-min descent of the
length-dependent fracminhash thresholds (scaling 1 and 3; the JAX step's
mode, which the port keeps as the reference of its per-read mode,
tests/test_torch_fmh_descent.py, and takes where it is asked for) and
the count-table descent of a plain k-mer hierarchy, as packed outputs
against the JAX grouped step (Pallas in interpret mode), decoded against
the host oracle, and as whole searches against the JAX host engine.
Every comparison is exact: integer or byte equality."""

import os

import numpy as np
import pytest

from taxor_tpu.apps.build import BuildConfig, run_build
from taxor_tpu.device.hixf_search import DeviceHIXF as JaxDeviceHIXF
from taxor_tpu.io.fastx import read_all
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu_torch.device import hixf_search
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hixf.index import load_index
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.search.thresholds import Thresholder

from .test_torch_minimizer import assert_decode_matches_host
from .util import make_reads, make_ref_set, write_fasta

HIERS = {  # name -> build scheme; the thresholds' kind at percentage -1
    "fmh_scaling1": (dict(kmer_size=16, window_size=22, use_syncmer=False),
                     "fracminhash"),
    "fmh_scaling3": (dict(kmer_size=16, window_size=22, use_syncmer=False,
                          scaling=3), "fracminhash"),
    "plain_kmer": (dict(kmer_size=20, window_size=20, use_syncmer=False),
                   "kmer_model"),
}


@pytest.fixture(scope="module")
def hier_sets(tmp_path_factory):
    """100 species x 3 kb (more user bins than the 64 technical bins of an
    IXF, so the layout is hierarchical), 200 reads of 800 b and two over
    L_CAP; indexes built on demand, as (port index, file)."""
    tmp = str(tmp_path_factory.mktemp("torch_descend_all"))
    rng = np.random.default_rng(55)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=3000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=2,
                       read_len=800, error_rate=0.02)
    recs = [(r.id, r.seq) for r in read_all(reads)]
    whole = b"".join(genomes.values())
    recs += [("long0", whole[:33000]), ("long1", whole[90000:125000])]
    write_fasta(reads, recs)
    indexes = {}

    def index(name):
        if name not in indexes:
            idx = os.path.join(tmp, f"{name}.taxor.npz")
            run_build(BuildConfig(
                input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
                layout_mode="auto", tmax=64,
                layout_file=os.path.join(tmp, f"{name}.out"),
                **HIERS[name][0]))
            indexes[name] = load_index(idx), idx
            assert len(indexes[name][0].hixf.ixfs) > 1
        return indexes[name]

    return index, reads, [s for _, s in recs], tmp


def thresholder_of(index, percentage=-1.0):
    sch = index.scheme
    return Thresholder.make(sch.kmer_size, sch.window_size, 0.04, percentage,
                            sch.use_syncmer)


def packed_reads(seqs, n):
    seqs = [s for s in seqs if len(s) <= dsync.L_CAP][:n]
    L = dsync.pad_len_bucket(max(len(s) for s in seqs))
    return seqs, *dsync.pack_reads(seqs, L)


@pytest.mark.parametrize("name", list(HIERS))
def test_grouped_step_matches_jax(hier_sets, name):
    """The port's grouped step equals the JAX grouped step element for
    element: in descend-all mode the packed [R, 3*topk + 2] (chain minima
    | leaf sums | users | n_unique | n_emit), for plain k-mers the
    count-table descent's [R, 2*topk + 2]; hcap is L for both."""
    index_of, _, seqs, _ = hier_sets
    index = index_of(name)[0]
    th = thresholder_of(index)
    assert th.kind == HIERS[name][1]
    _, packed, lengths = packed_reads(seqs, 48)
    ref = JaxDeviceHIXF(index.hixf, engine="pallas")
    ref._interpret = True
    want = ref.e2e_async(packed, lengths, index.scheme, th)()
    da = th.kind == "fracminhash"
    got = DeviceHIXF.from_hixf(index.hixf, "cpu").e2e_async(
        packed, lengths, index.scheme, th, descend_all=da)()
    assert len(want) == (6 if da else 5) and len(got) == 6
    assert (got[5] is None) == (not da)  # the port's sixth: sums or None
    assert got[4] == want[4] == packed.shape[1] * 4  # hcap = L
    for a, b in zip(got[:4] + got[5:len(want)], want[:4] + want[5:]):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (got[0][:, 0] > 0).sum() >= 40


@pytest.mark.parametrize("name", ["fmh_scaling1", "fmh_scaling3"])
def test_hier_fracminhash_descend_all_matches_host(hier_sets, name):
    """The port's twin of test_hixf_e2e_device.py::
    test_hier_fracminhash_descend_all_matches_host: scaled and
    length-dependent-threshold searches on a hierarchy dispatched fused in
    the descend-all mode reproduce the host oracle exactly."""
    index_of, _, seqs, _ = hier_sets
    index = index_of(name)[0]
    th = thresholder_of(index)
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    assert dh.e2e_capable(th) and len(dh.ixfs) > 1
    reads, packed, lengths = packed_reads(seqs, 200)
    res = dh.e2e_async(packed, lengths, index.scheme, th, k=16,
                       descend_all=True)()
    assert res[5] is not None  # (..., hcap, leaf sums)
    # scaling 3 on 800 b reads leaves few hashes against the threshold:
    # classification is sparse; the parity above is the test
    assert_decode_matches_host(index, reads, res, th,
                               10 if index.scheme.scaling > 1
                               else len(reads) // 2)


def test_hier_plain_kmer_matches_host(hier_sets):
    """The count-table descent of plain k-mers (kmer_model thresholds,
    a table of L + 1 entries) decoded equals the host oracle."""
    index_of, _, seqs, _ = hier_sets
    index = index_of("plain_kmer")[0]
    th = thresholder_of(index)
    reads, packed, lengths = packed_reads(seqs, 200)
    res = DeviceHIXF.from_hixf(index.hixf, "cpu").e2e_async(
        packed, lengths, index.scheme, th)()
    assert res[5] is None  # the count-table mode reports no leaf sums
    assert_decode_matches_host(index, reads, res, th, len(reads) // 2)


def test_threshold_table_is_built_once(hier_sets, monkeypatch):
    """The count table for hcap = L (1,025 entries at L = 1,024, 32,769 at
    32,768) is built on the host once per (thresholder, hcap), not per
    batch; the per-read mode of fracminhash thresholds builds none."""
    index_of, _, seqs, _ = hier_sets
    built = []
    real = hixf_search.count_thresholds
    monkeypatch.setattr(hixf_search, "count_thresholds",
                        lambda th, hcap: built.append(hcap)
                        or real(th, hcap))
    _, packed, lengths = packed_reads(seqs, 16)
    for name in ("plain_kmer", "fmh_scaling1"):
        index = index_of(name)[0]
        th = thresholder_of(index)
        dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
        for _ in range(3):
            dh.e2e_async(packed, lengths, index.scheme, th)()
    assert built == [packed.shape[1] * 4]


@pytest.mark.parametrize("topk", [1, 16])
def test_descend_all_decode_matches_jax(topk):
    """_pairs_from_e2e with leaf sums: the port's decode equals the JAX
    package's (the leaf sums reported, truncation whenever all k slots
    pass, with no 0.8 shortcut), including the fallback set."""
    rng = np.random.default_rng(topk)
    R = 40
    minv = -np.sort(-rng.integers(0, 60, (R, topk)), axis=1)
    sums = minv + rng.integers(0, 30, (R, topk))
    users = rng.integers(0, 100, (R, topk))
    counts = rng.integers(0, 200, R)
    n_emit = counts.copy()
    seqs = [b"A" * int(n) for n in rng.integers(100, 900, R)]

    class Hixf:
        @staticmethod
        def membership(hl, thr):
            return [(0, int(thr))]

    class Index:
        hixf = Hixf()

    from taxor_tpu_torch.hash.schemes import HashScheme

    scheme = HashScheme.make(16, 10, 22, False)
    th = Thresholder.make(16, 22, 0.04, -1.0, False)
    dfs = np.arange(100)[::-1].copy()
    out = []
    for mod in (pipeline, jax_pipeline):
        trunc: list = []
        out.append((*mod._pairs_from_e2e(
            minv.astype(np.int32), users.astype(np.int32), counts, n_emit,
            seqs, Index(), scheme, th, dfs, 1024,
            sums=sums.astype(np.int32), trunc_out=trunc), trunc[0]))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][2], out[1][2])
    assert out[0][2].any() and not out[0][2].all()


@pytest.mark.parametrize("name", ["fmh_scaling3", "plain_kmer"])
def test_hier_search_device_equals_host(hier_sets, name):
    """The whole search on a hierarchy: the port's device engine writes
    the JAX host engine's TSV byte for byte, every read routed fused, the
    two past L_CAP on their whole bucket (``long_fused``), none hashed on
    the host."""
    index_of, reads, seqs, tmp = hier_sets
    idx = index_of(name)[1]
    paths = {e: os.path.join(tmp, f"{name}_{e}.tsv")
             for e in ("jax", "device")}
    jax_pipeline.run_search(jax_pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=paths["jax"],
        engine="host"))
    pipeline.ROUTES.reset()
    pipeline.run_search(pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=paths["device"],
        engine="device"), device="cpu")
    routes = dict(pipeline.ROUTES.counts)
    with open(paths["jax"], "rb") as a, open(paths["device"], "rb") as b:
        assert a.read() == b.read()
    assert routes["fused"] == len(seqs) and routes["long_fused"] == 2
    assert routes["host_hashes"] == 0
    assert hixf_search.ACTIVITY.share() > 0


def test_bench_fractions_follow_the_descend_all_decode(hier_sets):
    """tools/bench.device_reads_per_s on a hierarchy in descend-all mode: its
    fallback fraction is the share the pipeline's decode sends to the
    host (all k chain minima pass their threshold, or n_emit > hcap; no
    0.8 shortcut) and its classified fraction the share of reads the host
    oracle classifies.  Random reads and a homopolymer, whose chain
    minima are small and level, tell these from the minima's own tests."""
    from taxor_tpu_torch.hash.schemes import search_hashes
    from taxor_tpu_torch.tools import bench

    index_of, _, seqs, _ = hier_sets
    index = index_of("fmh_scaling1")[0]
    scheme, th = index.scheme, thresholder_of(index)
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = packed_reads(seqs, 48)[0] + [b"A" * 800] + [
        acgt[rng.integers(0, 4, 800)].tobytes() for _ in range(15)]
    packed, lengths = dsync.pack_reads(
        reads, dsync.pad_len_bucket(max(len(s) for s in reads)))
    _, _, fb, classified = bench.device_reads_per_s(index, reads, th, "cpu",
                                                    descend_all=True)
    res = DeviceHIXF.from_hixf(index.hixf, "cpu").e2e_async(
        packed, lengths, scheme, th, descend_all=True)()
    trunc = []
    pipeline._pairs_from_e2e(*res[:4], reads, index, scheme, th,
                             index.hixf.user_bin_dfs_order(), res[4],
                             sums=res[5], trunc_out=trunc)
    assert fb == float(((res[3] > res[4]) | trunc[0]).mean())
    hit = [bool(index.hixf.membership(hl, pipeline._read_threshold(
        th, hl.shape[0], len(s), scheme.kmer_size)))
        for s, hl in zip(reads, search_hashes(reads, scheme))]
    assert classified == float(np.mean(hit)) >= 0.4
    assert not all(hit)
