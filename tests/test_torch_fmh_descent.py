"""The per-read descent of the fracminhash threshold models on the port's
hierarchical fused step, at a tiny size on the CPU twins.

A minimiser hierarchy (window > k, scaled or not) is searched with
thresholds that depend on the read's length as well as its hash count.
The port copies the extraction's hash counts to the host, computes each
read's exact threshold there (search/thresholds.device_thresholds) and
descends with them, so K2n probes only the pairs the reference walks;
the JAX step's descend-all mode, which probes every pair, stays as the
reference.  Held here, exactly: the routing rule by the thresholder's
kind, the thresholds against the host's and the count table's clamps,
the packed result decoded against the host oracle and the descend-all
mode (top-k 1 and 16, reads whose threshold is 0 or the "impossible"
sentinel, counts past 256), the activity handed to K2n against a numpy
walk of the same thresholds, whole searches against ``--engine host``,
the descend-all route and the JAX package's device engine (its Pallas
steps in interpret mode) with the top-k escalation, and tools/bench's
fractions."""

import dataclasses
import functools
import os

import numpy as np
import pytest

from taxor_tpu.device import hixf_search as jax_hixf_search
from taxor_tpu.hixf.index import load_index as jax_load_index
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu.search.thresholds import Thresholder as JaxThresholder
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device import hixf_search
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash.schemes import search_hashes
from taxor_tpu_torch.hixf.index import save_index
from taxor_tpu_torch.io.fastx import read_all
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.search.thresholds import (INT32_MAX, Thresholder,
                                               _read_threshold,
                                               count_thresholds,
                                               device_thresholds)

from .test_torch_minimizer import assert_decode_matches_host, final
from .util import make_reads, make_ref_set, random_genome, write_fasta

SCHEMES = {
    "scaling1": dict(kmer_size=16, window_size=22, use_syncmer=False),
    "scaling3": dict(kmer_size=16, window_size=22, use_syncmer=False,
                     scaling=3),
}
KINDS = ("percentage", "syncmer_model", "kmer_model", "fracminhash")


@pytest.fixture(scope="module")
def fmh(tmp_path_factory):
    """100 species x 3 kb (a hierarchy at --tmax 64); reads: 50 of 1.6 kb
    and 25 of 800 b (2% substitutions), 4 whole genomes (counts past
    256), genome pieces of 150-250 b (thresholds of 0 and the sentinel),
    a read of k - 1 = 15 b (the NaN sentinel), a random one, and one past
    L_CAP (K5 on its whole bucket, then the fused step)."""
    tmp = str(tmp_path_factory.mktemp("torch_fmh_descent"))
    rng = np.random.default_rng(181)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=3000)
    accs = sorted(genomes)
    recs = []
    for picked, read_len in ((accs[::2], 1600), (accs[1::4], 800)):
        reads = make_reads(tmp, rng, {a: genomes[a] for a in picked},
                           n_reads_per_genome=1, read_len=read_len,
                           error_rate=0.02)
        recs += [(r.id, r.seq) for r in read_all(reads)]
    recs += [(f"whole_{a}", genomes[a]) for a in accs[:4]]
    recs += [(f"piece{n}_{a}", genomes[a][100:100 + n])
             for n, a in zip(range(150, 260, 10), accs[10:])]
    recs += [("kminus1", genomes[accs[30]][:15]),
             ("random", random_genome(rng, 300))]
    # the JAX device engine's per-IXF traversal has no interpret mode
    short = os.path.join(tmp, "reads_short.fasta")
    write_fasta(short, recs)
    recs.append(("long", b"".join(genomes[a] for a in accs[:12])))
    write_fasta(reads, recs)
    indexes = {}

    def index(name):
        if name not in indexes:
            idx = os.path.join(tmp, f"{name}.taxor.npz")
            built = run_build(BuildConfig(
                input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
                layout_mode="auto", tmax=64,
                layout_file=os.path.join(tmp, f"{name}.out"),
                **SCHEMES[name]))
            assert len(built.hixf.ixfs) > 1
            indexes[name] = built, idx
        return indexes[name]

    seqs = [s for _, s in recs]
    assert len(seqs[-1]) > dsync.L_CAP
    return index, (reads, short), seqs, tmp


def thresholder_of(index):
    sch = index.scheme
    th = Thresholder.make(sch.kmer_size, sch.window_size, 0.04, -1.0,
                          sch.use_syncmer)
    assert th.kind == "fracminhash"
    return th


def fused_batch(seqs):
    """The reads up to L_CAP in one length bucket: (reads, packed,
    lengths)."""
    seqs = [s for s in seqs if len(s) <= dsync.L_CAP]
    L = dsync.pad_len_bucket(max(len(s) for s in seqs))
    return (seqs, *dsync.pack_reads(seqs, L))


def thresholds(index, seqs):
    """The per-read mode's int32 thresholds from the host's hash counts."""
    hl = search_hashes(seqs, index.scheme)
    return device_thresholds(thresholder_of(index),
                             np.array([h.shape[0] for h in hl]),
                             [len(s) for s in seqs], index.scheme.kmer_size)


@pytest.mark.parametrize("kind", [*KINDS, None])
def test_descent_mode_follows_the_thresholder_kind(fmh, kind):
    """The routing rule: the kind alone picks the descent, fracminhash
    the per-read mode and the count-only models the count table;
    descend-all only where it is asked for; a hierarchy without a
    thresholder has no fused step."""
    index = fmh[0]("scaling1")[0]
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    if kind is None:
        assert not hixf_search._per_read(None)
        with pytest.raises(ValueError, match="thresholder"):
            dh.e2e_step(index.scheme, None, 16, 1024)
        return
    th = Thresholder(kmer_size=16, error_rate=0.04, kind=kind,
                     percentage=0.5)
    assert hixf_search._per_read(th) == (kind == "fracminhash")
    _, hcap, mode = dh.e2e_step(index.scheme, th, 16, 1024)
    assert hcap == 1024
    assert mode == ("per_read" if kind == "fracminhash" else "count_table")
    assert dh.e2e_step(index.scheme, th, 16, 1024,
                       descend_all=True)[2] == "descend_all"


@pytest.mark.parametrize("kind", KINDS)
def test_device_thresholds_clamp_as_the_count_table(kind):
    """device_thresholds is the host's exact threshold clamped to
    [0, INT32_MAX]: equal to the count table's entry for the count-only
    models, INT32_MAX for the size_t and NaN sentinels (a read of
    length k - 1) and for batch padding (length 0)."""
    th = Thresholder(kmer_size=16, error_rate=0.04, kind=kind,
                     percentage=0.5)
    rng = np.random.default_rng(7)
    lens = np.concatenate([[0, 15, 16, 17], rng.integers(18, 5000, 300)])
    counts = np.minimum(rng.integers(0, 1200, lens.shape[0]),
                        np.maximum(lens - 15, 0))
    counts[1] = 0  # length k - 1: no hash
    got = device_thresholds(th, counts, lens.tolist(), 16)
    assert got.dtype == np.int32
    want = [INT32_MAX if n == 0 else
            int(np.clip(_read_threshold(th, c, n, 16), 0, INT32_MAX))
            for c, n in zip(counts.tolist(), lens.tolist())]
    np.testing.assert_array_equal(got, want)
    assert got[0] == INT32_MAX
    if kind == "fracminhash":
        assert got[1] == INT32_MAX  # 0 / 0: NaN, the sentinel
        assert (got == INT32_MAX).sum() > 2 and (got < 1000).sum() > 100
    else:
        table = count_thresholds(th, 1200)
        np.testing.assert_array_equal(got[1:], table[counts[1:]])


@pytest.mark.parametrize("topk", [1, 16])
@pytest.mark.parametrize("name", list(SCHEMES))
def test_per_read_step_matches_host_and_descend_all(fmh, name, topk):
    """The per-read step's packed result: the count-table packing (no
    leaf sums) with the descend-all step's hash and emission counts;
    decoded, every read equals the host oracle and the descend-all
    decode, and the reads sent to the host are a subset of descend-all's
    (the 0.8 shortcut holds again on leaf sums).  The batch has reads
    whose threshold is 0 or the sentinel, and counts past 256."""
    index_of, _, seqs, _ = fmh
    index = index_of(name)[0]
    th, scheme = thresholder_of(index), index.scheme
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    reads, packed, lengths = fused_batch(seqs)
    thr = thresholds(index, reads)
    assert (thr == 0).sum() >= 3 and (thr == INT32_MAX).sum() >= 8
    per = dh.e2e_async(packed, lengths, scheme, th, k=topk)()
    alls = dh.e2e_async(packed, lengths, scheme, th, k=topk,
                        descend_all=True)()
    assert per[5] is None and alls[5] is not None
    assert per[0].shape == (len(reads), topk) and per[4] == alls[4]
    for a, b in zip(per[2:4], alls[2:4]):
        np.testing.assert_array_equal(a, b)
    assert per[0].max() > 256
    assert_decode_matches_host(index, reads, per, th, len(reads) // 2)
    trunc = {}
    decoded = {}
    for mode, res in (("per_read", per), ("descend_all", alls)):
        out: list = []
        decoded[mode] = pipeline._pairs_from_e2e(
            *res[:4], reads, index, scheme, th,
            index.hixf.user_bin_dfs_order(), res[4], sums=res[5],
            trunc_out=out)
        trunc[mode] = out[0]
    assert decoded["per_read"][1] == decoded["descend_all"][1]
    assert [final(p) for p in decoded["per_read"][0]] == [
        final(p) for p in decoded["descend_all"][0]]
    assert not (trunc["per_read"] & ~trunc["descend_all"]).any()
    if topk == 16:  # the threshold-0 reads no longer fill every slot
        assert trunc["per_read"].sum() < trunc["descend_all"].sum()


@pytest.mark.parametrize("name", list(SCHEMES))
def test_native_walk_equals_numpy_walk(fmh, name):
    """HIXF.walk, the IXFs the host oracle's C++ walk visits (the CPU walk
    that chip_smoke.py holds the card's activity to), equals its numpy
    recursion for every read at its own threshold, 0 and the sentinel;
    every user bin the walk emits lies in a visited IXF."""
    from taxor_tpu_torch import native

    assert native.get_lib() is not None
    index_of, _, seqs, _ = fmh
    index = index_of(name)[0]
    hixf = index.hixf
    reads = seqs[:-1]
    thr = thresholds(index, reads)
    owner = {int(u): i for i, b2u in enumerate(hixf.bin_to_user)
             for u in b2u if u >= 0}
    for hl, t in zip(search_hashes(reads, index.scheme), thr.tolist()):
        for t2 in (t, 0, 2**63):
            walked = hixf.walk(hl, t2)
            assert walked == hixf.walk_plain(hl, t2)
            assert walked[0] == 0 and len(set(walked)) == len(walked)
        assert {owner[u] for u, _ in hixf.membership(hl, t)} <= set(
            hixf.walk(hl, t))
    assert len(hixf.walk(np.zeros(0, dtype=np.uint64), 0)) == len(hixf.ixfs)


@pytest.mark.parametrize("name", list(SCHEMES))
def test_activity_equals_a_numpy_walk(fmh, name):
    """The active (subgroup, read) pairs the per-read step hands K2n,
    launch by launch, equal those of a numpy walk of the same thresholds
    from the host's hashes (HIXF.walk_plain); threshold-0 reads walk
    every IXF, and the activity share is below 1."""
    index_of, _, seqs, _ = fmh
    index = index_of(name)[0]
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    reads, packed, lengths = fused_batch(seqs)
    thr = thresholds(index, reads)
    hixf_search.ACTIVITY.reset()
    with hixf_search.ACTIVITY.per_launch() as kept:
        dh.e2e_async(packed, lengths, index.scheme, thresholder_of(index))()
    pos = {ixf: p for p, ixf in enumerate(dh.bfs_order)}
    walked = np.zeros((len(dh.bfs_order), len(reads)), dtype=bool)
    for r, hl in enumerate(search_hashes(reads, index.scheme)):
        for i in index.hixf.walk_plain(hl, int(thr[r])):
            walked[pos[i], r] = True
    assert len(kept) == len(dh.groups)
    for g, got in zip(dh.groups, kept):
        act = np.zeros((g["tables"].shape[0], len(reads)), dtype=bool)
        for b, sub in zip(g["member_bfs"].tolist(),
                          g["member_sub"].tolist()):
            act[sub] |= walked[b]
        np.testing.assert_array_equal(got.numpy(), act.sum(axis=1))
    assert walked[:, thr == 0].all()
    assert 0 < hixf_search.ACTIVITY.share() < 1


def search_ways(tmp, idx, reads, label, monkeypatch, jax, **cfg):
    """The TSVs of the port's device engine (per-read), its device engine
    held to the descend-all mode and its host engine on ``reads``, and,
    with ``jax``, of the JAX package's device engine on the same reads
    but the one past L_CAP; the port's route counts."""
    out = {e: os.path.join(tmp, f"{label}_{e}.tsv")
           for e in ("per_read", "descend_all", "host", "jax")[:3 + jax]}
    routes = {}
    for mode in ("per_read", "descend_all", "host"):
        with monkeypatch.context() as m:
            if mode == "descend_all":
                m.setattr(DeviceHIXF, "e2e_async", functools.partialmethod(
                    DeviceHIXF.e2e_async, descend_all=True))
            pipeline.ROUTES.reset()
            pipeline.run_search(pipeline.SearchConfig(
                index_file=idx, query_file=reads[0], report_file=out[mode],
                engine="host" if mode == "host" else "device", **cfg),
                device="cpu")
            routes[mode] = dict(pipeline.ROUTES.counts)
    if jax:
        monkeypatch.setattr(jax_hixf_search, "_default_engine",
                            lambda: "pallas")
        monkeypatch.setattr(jax_hixf_search.DeviceHIXF, "_interpret", True,
                            raising=False)
        index = jax_load_index(idx)
        sch = index.scheme
        th = JaxThresholder.make(sch.kmer_size, sch.window_size, 0.04,
                                 -1.0, sch.use_syncmer)
        assert jax_hixf_search.DeviceHIXF(index.hixf).e2e_capable(th)
        jax_pipeline.run_search(jax_pipeline.SearchConfig(
            index_file=idx, query_file=reads[1], report_file=out["jax"],
            engine="device", **cfg))
    texts = {}
    for mode, path in out.items():
        with open(path, "rb") as fh:
            texts[mode] = fh.read()
    return texts, routes


@pytest.mark.parametrize("topk", [1, 16])
@pytest.mark.parametrize("name", list(SCHEMES))
def test_search_matches_host_descend_all_and_jax(fmh, name, topk,
                                                 monkeypatch):
    """Whole searches from an index saved with suggested_topk = topk, in
    batches of 32 reads one at a time: the per-read TSV equals the host
    engine's and the descend-all route's byte for byte, and at top-k 16
    the JAX device engine's (its Pallas steps compile once per top-k and
    bucket, so the ladder's every rung is held to the port's own routes);
    every read fused, the one past L_CAP on its whole bucket
    (``long_fused``), none hashed on the host; from top-k 1 the ladder
    climbs; the per-read route sends
    no more reads to the host oracle than descend-all."""
    index_of, reads, seqs, tmp = fmh
    built, _ = index_of(name)
    idx = os.path.join(tmp, f"{name}_topk{topk}.taxor.npz")
    save_index(idx, dataclasses.replace(built, suggested_topk=topk))
    texts, routes = search_ways(tmp, idx, reads, f"{name}_{topk}",
                                monkeypatch, jax=topk == 16, batch_size=32,
                                pipeline_depth=1, topk=1)
    assert texts["per_read"] == texts["host"] == texts["descend_all"]
    if topk == 16:
        assert texts["jax"] == b"".join(
            row for row in texts["per_read"].splitlines(keepends=True)
            if not row.startswith(b"long\t"))
    assert texts["per_read"].count(b"\n") > len(seqs)
    per, alls = routes["per_read"], routes["descend_all"]
    assert per["fused"] == len(seqs) and per["long_fused"] == 1
    assert per["host_hashes"] == 0
    assert per["hcap_overflow"] == 0
    assert per["host_fallback"] == per["truncated"] <= alls["truncated"]
    assert (per["topk_escalations"] > 0) == (topk == 1)


def test_bench_fractions_follow_the_per_read_decode(fmh):
    """tools/bench.device_reads_per_s on a hierarchy in the per-read mode,
    at top-k 1: its fallback fraction is the share the pipeline's decode
    sends to the host (all k slots pass their threshold and the 0.8 rule,
    or n_emit > hcap) and its classified fraction the share of reads the
    host oracle classifies."""
    from taxor_tpu_torch.tools import bench

    index_of, _, seqs, _ = fmh
    index = index_of("scaling1")[0]
    scheme, th = index.scheme, thresholder_of(index)
    reads, packed, lengths = fused_batch(seqs)
    _, _, fb, classified = bench.device_reads_per_s(index, reads, th, "cpu",
                                                    topk=1)
    res = DeviceHIXF.from_hixf(index.hixf, "cpu").e2e_async(
        packed, lengths, scheme, th, k=1)()
    assert res[5] is None
    trunc = []
    pipeline._pairs_from_e2e(*res[:4], reads, index, scheme, th,
                             index.hixf.user_bin_dfs_order(), res[4],
                             trunc_out=trunc)
    assert 0 < fb == float(((res[3] > res[4]) | trunc[0]).mean()) < 1
    hit = [bool(index.hixf.membership(hl, _read_threshold(
        th, hl.shape[0], len(s), scheme.kmer_size)))
        for s, hl in zip(reads, search_hashes(reads, scheme))]
    assert classified == float(np.mean(hit)) >= 0.5
    assert not all(hit)
