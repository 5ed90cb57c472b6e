"""The port's own copy of the host layer against the JAX package's: the
same index from the same references (flat and hierarchical) with the
same layout file, the same host hashes for each scheme, the same CAMI
profile and binning text.  Every comparison is exact."""

import json
import os

import numpy as np
import pytest

from taxor_tpu.apps import build as jax_build
from taxor_tpu.hash import schemes as jax_schemes
from taxor_tpu.profile import profile as jax_profile
from taxor_tpu_torch.apps import build
from taxor_tpu_torch.hash import schemes
from taxor_tpu_torch.profile import profile
from taxor_tpu_torch.search import pipeline

from .util import make_reads, make_ref_set

PACKAGES = {"jax": jax_build, "port": build}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """100 species x 3 kb: more user bins than the 64 technical bins of
    an IXF, so the auto layout is hierarchical."""
    tmp = str(tmp_path_factory.mktemp("hostlayer"))
    rng = np.random.default_rng(5)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=3000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=1,
                       read_len=900, error_rate=0.02)
    return tmp, tsv, gdir, reads


def build_with(pkg, refs, layout: str):
    """Index file and layout file of one package's build."""
    tmp, tsv, gdir, _ = refs
    idx = os.path.join(tmp, f"{pkg}_{layout}.taxor.npz")
    lay = os.path.join(tmp, f"{pkg}_{layout}.binning.out")
    mod = PACKAGES[pkg]
    mod.run_build(mod.BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
        kmer_size=22, syncmer_size=12, use_syncmer=True, layout_mode=layout,
        tmax=64, layout_file=lay))
    return idx, lay


@pytest.mark.parametrize("layout", ["flat", "auto"])
def test_build_writes_the_jax_index(refs, layout):
    (jidx, jlay), (pidx, play) = (build_with(p, refs, layout)
                                  for p in ("jax", "port"))
    with np.load(jidx) as a, np.load(pidx) as b:
        assert sorted(a.files) == sorted(b.files)
        meta = json.loads(bytes(b["meta"]).decode())
        assert meta == json.loads(bytes(a["meta"]).decode())
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
    assert (len(meta["ixf_seeds"]) > 1) == (layout == "auto")
    with open(jlay, "rb") as fa, open(play, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("kw", [
    dict(kmer_size=22, syncmer_size=12, window_size=None, use_syncmer=True),
    dict(kmer_size=19, syncmer_size=10, window_size=25, use_syncmer=False),
    dict(kmer_size=20, syncmer_size=10, window_size=None, use_syncmer=True,
         scaling=4)], ids=["syncmer", "minimizer", "scaled"])
def test_search_hashes_match_jax(refs, kw):
    """Random reads of 10-3,000 bases, every third with N codes."""
    rng = np.random.default_rng(len(kw))
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    seqs = [acgtn[rng.integers(0, 5 if j % 3 == 0 else 4, int(n))].tobytes()
            for j, n in enumerate(rng.integers(10, 3000, 40))]
    want = jax_schemes.search_hashes(seqs, jax_schemes.HashScheme.make(**kw))
    got = schemes.search_hashes(seqs, schemes.HashScheme.make(**kw))
    assert len(got) == len(want) and sum(g.size for g in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_profile_writes_the_jax_text(refs):
    """From one search TSV (the port's host engine on the hierarchical
    index), both packages' profile write the same CAMI and binning
    files."""
    tmp, _, _, reads = refs
    idx, _ = build_with("port", refs, "auto")
    tsv = os.path.join(tmp, "search.tsv")
    pipeline.run_search(pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=tsv, engine="host"),
        device="cpu")
    text = {}
    for name, mod in (("jax", jax_profile), ("port", profile)):
        cami = os.path.join(tmp, f"{name}.cami.tsv")
        binning = os.path.join(tmp, f"{name}.binning.tsv")
        mod.run_profile(mod.ProfileConfig(
            search_file=tsv, report_file=cami, binning_file=binning,
            sample_id="s1"))
        with open(cami, "rb") as fa, open(binning, "rb") as fb:
            text[name] = (fa.read(), fb.read())
    assert text["port"] == text["jax"]
    assert text["port"][0].count(b"\n") > 10 and text["port"][1]
