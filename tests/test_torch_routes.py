"""The routes of the device search that no main path takes, at a tiny
size: scaled syncmers (flat and in the count-table descent), unscaled
minimisers (flat and in the descend-all descent), plain k-mers in the
count-table descent, a narrow syncmer scheme at its own hash capacity,
64-bit s-mers, the hash-capacity overflow, and the top-k escalation 16
-> 64 -> 256 on strains of one species.  Each search's TSV is held byte
for byte to the JAX package's device engine (its fused Pallas steps in
interpret mode, as its own tests run them on the CPU; for s >= 16, which
its int32 lanes do not take fused, its host engine) and to the port's
host engine; the route counts (search/pipeline.ROUTES) show which route
each read took."""

import dataclasses
import os

import numpy as np
import pytest

from taxor_tpu.device import hixf_search as jax_hixf_search
from taxor_tpu.hash import device_syncmer as jax_dsync
from taxor_tpu.hixf.index import load_index as jax_load_index
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu.search.thresholds import Thresholder as JaxThresholder
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device import hixf_search
from taxor_tpu_torch.hixf.index import save_index
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.tools.bench import PARITY_FAMILIES

from .util import make_reads, make_ref_set, mutate

# the bench gate's families of the routes no main path takes
NEW_FAMILIES = ("scaled_syncmer", "hier_scaled_syncmer", "minimizer",
                "hier_minimizer", "hier_plain_kmer", "narrow_syncmer",
                "wide_smer_syncmer")


@pytest.fixture(scope="module")
def ref_sets(tmp_path_factory):
    """Two reference sets, as the bench gate's two problems: (0) 24
    genomes of 3 kb and a read of 1 kb from each, (1) 72 genomes of 2 kb
    (more user bins than the 64 technical bins of an IXF, so --tmax 64
    gives a hierarchy) and a read of 900 b from every other one."""
    tmp = str(tmp_path_factory.mktemp("torch_routes"))
    rng = np.random.default_rng(16)
    sets = []
    for i, (n, glen, read_len, every) in enumerate(
            ((24, 3000, 1000, 1), (72, 2000, 900, 2))):
        root = os.path.join(tmp, f"set{i}")
        os.makedirs(root)
        tsv, gdir, genomes = make_ref_set(root, rng, n_species=n,
                                          genome_len=glen)
        picked = {a: genomes[a] for a in sorted(genomes)[::every]}
        reads = make_reads(root, rng, picked, n_reads_per_genome=1,
                           read_len=read_len, error_rate=0.02)
        sets.append((tsv, gdir, reads, len(picked)))
    return tmp, sets


def search_three_ways(tmp, idx, reads, label, monkeypatch, **cfg):
    """(the port's device TSV on its plain twins, its host TSV, the JAX
    device engine's TSV, or its host engine's where its device engine
    does not take the scheme fused), each search with the SearchConfig
    fields ``cfg``; the port's route counts of its device search."""
    out = {e: os.path.join(tmp, f"{label}_{e}.tsv")
           for e in ("device", "host", "jax")}
    pipeline.ROUTES.reset()
    for engine in ("device", "host"):
        pipeline.run_search(pipeline.SearchConfig(
            index_file=idx, query_file=reads, report_file=out[engine],
            engine=engine, **cfg), device="cpu")
        if engine == "device":
            routes = dict(pipeline.ROUTES.counts)
    monkeypatch.setattr(jax_hixf_search, "_default_engine", lambda: "pallas")
    monkeypatch.setattr(jax_hixf_search.DeviceHIXF, "_interpret", True,
                        raising=False)
    index = jax_load_index(idx)
    sch = index.scheme
    th = JaxThresholder.make(sch.kmer_size, sch.window_size, 0.04, -1.0,
                             sch.use_syncmer)
    fused = jax_dsync.supports(sch) or not sch.use_syncmer
    # the JAX device engine takes its fused steps on this index
    assert jax_hixf_search.DeviceHIXF(index.hixf).e2e_capable(th)
    jax_pipeline.run_search(jax_pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=out["jax"],
        engine="device" if fused else "host", **cfg))
    texts = []
    for engine in ("device", "host", "jax"):
        with open(out[engine], "rb") as fh:
            texts.append(fh.read())
    return texts, routes


@pytest.mark.parametrize("family", NEW_FAMILIES)
def test_family_matches_jax_device_and_host(family, ref_sets, monkeypatch):
    tmp, sets = ref_sets
    layout, src, scheme = PARITY_FAMILIES[family]
    tsv, gdir, reads, n_reads = sets[src]
    idx = os.path.join(tmp, f"{family}.taxor.npz")
    run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
        layout_mode=layout, tmax=64 if layout == "auto" else 0,
        layout_file=(os.path.join(tmp, f"{family}.out")
                     if layout == "auto" else ""), **scheme))
    index = jax_load_index(idx)
    assert (len(index.hixf.ixfs) > 1) == (layout == "auto")
    (port, host, jax_dev), routes = search_three_ways(
        tmp, idx, reads, family, monkeypatch)
    assert port == host == jax_dev
    assert port.count(b"\n") > n_reads  # the header and a row a read
    assert routes["fused"] == n_reads and routes["host_hashes"] == 0
    assert routes["host_fallback"] == (routes["hcap_overflow"]
                                       + routes["truncated"])
    # narrow_syncmer: ~330 emissions a 1 kb read, past L/4 but within its
    # own capacity
    assert routes["hcap_overflow"] == 0


def test_hcap_overflow_falls_back_to_the_host(ref_sets, monkeypatch):
    """The hash-capacity overflow, end to end: the narrow scheme (k = 16,
    s = 14, ~330 emissions a 1 kb read) searched with the capacity held
    at the JAX package's rule, L/4 of the bucket, sends every read past
    it to the host oracle, and the TSV is still the JAX package's
    ``--engine host`` byte for byte."""
    tmp, sets = ref_sets
    layout, src, scheme = PARITY_FAMILIES["narrow_syncmer"]
    tsv, gdir, reads, n_reads = sets[src]
    idx = os.path.join(tmp, "narrow_overflow.taxor.npz")
    run_build(BuildConfig(input_file=tsv, input_sequence_dir=gdir,
                          output_filename=idx, layout_mode=layout,
                          layout_file="", **scheme))
    monkeypatch.setattr(hixf_search, "hash_cap",
                        lambda L, k, s, t: jax_dsync.hash_cap(L))
    out = {e: os.path.join(tmp, f"narrow_overflow_{e}.tsv")
           for e in ("device", "jax")}
    pipeline.ROUTES.reset()
    pipeline.run_search(pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=out["device"],
        engine="device"), device="cpu")
    routes = dict(pipeline.ROUTES.counts)
    jax_pipeline.run_search(jax_pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=out["jax"],
        engine="host"))
    texts = []
    for engine in ("device", "jax"):
        with open(out[engine], "rb") as fh:
            texts.append(fh.read())
    assert texts[0] == texts[1] and texts[0].count(b"\n") > n_reads
    assert routes["fused"] == n_reads and routes["host_hashes"] == 0
    assert routes["hcap_overflow"] == routes["host_fallback"] == n_reads


def test_topk_escalates_on_strains(tmp_path, monkeypatch):
    """80 strains of one species (its ancestor with 0.5% substitutions)
    and 16 unrelated genomes, searched from an index saved with
    suggested_topk = 16 in batches of 16 reads, one at a time: the first
    batch truncates at k = 16, the next at k = 64, the ladder ends at
    256, and every truncated read is decided by the host oracle.  The
    JAX device engine, with the same ladder, writes the same TSV."""
    rng = np.random.default_rng(61)
    tmp = str(tmp_path)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=96,
                                      genome_len=3000)
    accs = sorted(genomes)
    ancestor = genomes[accs[0]]
    for acc in accs[:80]:
        genomes[acc] = mutate(rng, ancestor, 0.005)
        with open(os.path.join(gdir, f"{acc}_genomic.fna"), "wb") as fh:
            fh.write(b">" + acc.encode() + b"\n" + genomes[acc] + b"\n")
    reads = make_reads(tmp, rng, {a: genomes[a] for a in accs[:48]},
                       n_reads_per_genome=1, read_len=600, error_rate=0.01)
    built = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True, layout_mode="flat",
        layout_file=""))
    assert built.suggested_topk == 256  # the build sees the strains
    idx = os.path.join(tmp, "topk16.taxor.npz")
    save_index(idx, dataclasses.replace(built, suggested_topk=16))
    (port, host, jax_dev), routes = search_three_ways(
        tmp, idx, reads, "topk16", monkeypatch, batch_size=16,
        pipeline_depth=1)
    assert port == host == jax_dev
    # from k = 16, two steps of the ladder end it at 256
    assert routes["topk_escalations"] == 2
    assert routes["truncated"] >= 16 and routes["hcap_overflow"] == 0
    assert routes["host_fallback"] == routes["truncated"]
    assert routes["fused"] == 48
