"""The host oracle's HIXF walk (``hixf/container.HIXF.membership``) in
C++ (``native/ref_baseline.cpp``) against its numpy walk
(``membership_plain``) and the JAX package's ``membership``, on one
multi-level index that the JAX package builds and the port loads: every
(user bin, count) pair and its order, for hash lists of reads, of random
values and of none, at thresholds from negative to past int64.  Every
comparison is exact."""

import os
import threading

import numpy as np
import pytest

from taxor_tpu.apps.build import BuildConfig, run_build
from taxor_tpu.io.fastx import read_all
from taxor_tpu_torch import native
from taxor_tpu_torch.hash.schemes import search_hashes
from taxor_tpu_torch.hixf.index import load_index

from .util import make_reads, make_ref_set

THRESHOLDS = {  # name -> threshold of a list of n hashes
    "negative": lambda n: -1,
    "zero": lambda n: 0,
    "one": lambda n: 1,
    "quarter": lambda n: n // 4,
    "all": lambda n: n,
    "past_int64": lambda n: 2**63,
    "u64_max": lambda n: 2**64 - 1,
}


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """(JAX index, port index of the same file, reads): 100 species x 3
    kb, k = 22 / s = 12 syncmers, --layout auto --tmax 64 (hierarchical),
    100 reads of 800 b."""
    tmp = str(tmp_path_factory.mktemp("torch_membership"))
    rng = np.random.default_rng(12)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=3000)
    idx = os.path.join(tmp, "hier.taxor.npz")
    jax_index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
        kmer_size=22, syncmer_size=12, use_syncmer=True,
        layout_mode="auto", tmax=64,
        layout_file=os.path.join(tmp, "b.out")))
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=1,
                       read_len=800, error_rate=0.02)
    index = load_index(idx)
    assert len(index.hixf.ixfs) > 1  # genuinely hierarchical
    assert native.get_lib() is not None
    return jax_index, index, [r.seq for r in read_all(reads)]


def hash_lists(index, seqs, kind: str) -> list[np.ndarray]:
    if kind == "reads":
        return search_hashes(seqs[:40], index.scheme)
    if kind == "random":
        rng = np.random.default_rng(7)
        return [rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
                for n in (1, 17, 300)]
    return [np.zeros(0, dtype=np.uint64)]


@pytest.mark.parametrize("kind", ["reads", "random", "empty"])
@pytest.mark.parametrize("threshold", list(THRESHOLDS))
def test_native_walk_matches_numpy_and_jax(indexes, kind, threshold):
    jax_index, index, seqs = indexes
    n_pairs = 0
    for hl in hash_lists(index, seqs, kind):
        thr = THRESHOLDS[threshold](hl.shape[0])
        got = index.hixf.membership(hl, thr)
        assert got == index.hixf.membership_plain(hl, thr)
        assert got == jax_index.hixf.membership(hl, thr)
        assert all(type(u) is int and type(c) is int for u, c in got)
        n_pairs += len(got)
    if threshold in ("negative", "zero"):  # every user bin, in DFS order
        assert n_pairs == len(hash_lists(index, seqs, kind)) \
            * index.hixf.num_user_bins
    if threshold in ("past_int64", "u64_max"):
        assert n_pairs == 0


def test_walk_without_the_library_is_numpy(indexes, monkeypatch):
    _, index, seqs = indexes
    hl = search_hashes(seqs[:1], index.scheme)[0]
    calls = []
    plain = type(index.hixf).membership_plain

    def spy(self, hashes, threshold):
        calls.append(threshold)
        return plain(self, hashes, threshold)

    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(type(index.hixf), "membership_plain", spy)
    assert index.hixf.membership(hl, 2) == plain(index.hixf, hl, 2)
    assert calls == [2]


def test_native_walk_from_threads(indexes):
    """Search workers call the walk at once; the contiguous view it walks
    is made once."""
    jax_index, index, seqs = indexes
    hls = search_hashes(seqs[:32], index.scheme)
    want = [jax_index.hixf.membership(h, 0) for h in hls]
    index.hixf.__dict__.pop("_flat_view", None)
    got = [None] * len(hls)

    def work(i):
        got[i] = index.hixf.membership(hls[i], 0)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(hls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want
    assert "_flat_view" in index.hixf.__dict__
