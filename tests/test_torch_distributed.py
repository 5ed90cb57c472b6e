"""Multi-process search of the port on torch.distributed: the CLI's
``search --engine sharded --distributed`` in one process a rank (gloo on
the CPU, a tcp rendezvous on a free local port) writes the JAX package's
host-engine TSV byte for byte.  The twin of tests/test_distributed.py:
its flat index searched by 4 ranks on a 2 x 2 mesh, and a hierarchical
one by 2 ranks on the default mesh (every rank a bins shard); each with
two reads over L_CAP, which take the sharded fused step in pieces."""

import os
import subprocess
import sys

import numpy as np
import pytest

from taxor_tpu.apps.build import BuildConfig, run_build
from taxor_tpu.hixf.index import save_index
from taxor_tpu.io.fastx import read_all
from taxor_tpu.search.pipeline import SearchConfig, run_search

from .torch_world import REPO, free_port
from .util import make_reads, make_ref_set, write_fasta

# name -> (seed, species, genome length, layout, ranks, mesh flags)
CASES = {
    "flat_2x2": (5, 8, 6000, "flat", 4, ["--mesh-reads", "2",
                                         "--mesh-bins", "2"]),
    "hier_default": (9, 100, 2500, "auto", 2, []),
}


@pytest.fixture(scope="module", params=list(CASES))
def problem(request, tmp_path_factory):
    seed, n_species, glen, layout, ranks, mesh = CASES[request.param]
    tmp = str(tmp_path_factory.mktemp(f"torch_dist_{request.param}"))
    rng = np.random.default_rng(seed)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=n_species,
                                      genome_len=glen)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=4 if
                       layout == "flat" else 1, read_len=900,
                       error_rate=0.03)
    whole = b"".join(genomes.values())
    recs = [(r.id, r.seq) for r in read_all(reads)]
    recs += [("long0", whole[:34000]), ("long1", whole[-36000:])]
    write_fasta(reads, recs)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True, layout_mode=layout,
        tmax=64, layout_file=os.path.join(tmp, "b.out")))
    assert (len(index.hixf.ixfs) > 1) == (layout == "auto")
    idx = os.path.join(tmp, "idx.taxor.npz")
    save_index(idx, index)
    expect = os.path.join(tmp, "expect.tsv")
    run_search(SearchConfig(index_file=idx, query_file=reads,
                            report_file=expect, engine="host"))
    return tmp, idx, reads, expect, ranks, mesh


def test_multi_process_sharded_search_matches_host(problem):
    tmp, idx, reads, expect, ranks, mesh = problem
    port = free_port()
    out = os.path.join(tmp, "dist.tsv")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "taxor_tpu_torch.cli", "search",
         "--index-file", idx, "--query-file", reads, "--output-file", out,
         "--engine", "sharded", "--distributed",
         "--coordinator-address", f"127.0.0.1:{port}",
         "--num-processes", str(ranks), "--process-id", str(r), *mesh,
         "--device", "cpu", "--write-time"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(ranks)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "collectives on gloo" in outs[0][1]
    with open(out) as fh, open(expect) as eh:
        got, want = fh.read(), eh.read()
    assert got == want
    assert got.count("GCF_") > 10 and "long0" in got
    assert os.path.exists(out + ".time")
