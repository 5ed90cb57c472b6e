"""The slice as a whole: the port's fused step against the JAX fused step
(Pallas in interpret mode), and the port's search pipeline (device engine
on the CPU twins, host engine) against the JAX package's host oracle,
byte for byte, on a single-IXF index whose user bins are split over
several technical bins."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.apps.build import BuildConfig, run_build
from taxor_tpu.device.e2e import fused_e2e_step as jax_fused_e2e_step
from taxor_tpu.device.pallas_probe import (choose_bin_tile4,
                                           prepare_fingerprints)
from taxor_tpu.hixf.index import save_index
from taxor_tpu.io.fastx import read_all
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu.search.thresholds import Thresholder
from taxor_tpu_torch.device import e2e, hixf_search
from taxor_tpu_torch.device.e2e import fused_e2e_step
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.search import pipeline

from .test_torch_hixf import build_hier_index, split_engine  # noqa: F401
from .util import make_reads, make_ref_set, write_fasta

SPLITS = [3, 1, 2, 1, 2, 1]  # technical bins per user bin


@pytest.fixture(scope="module")
def split_setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_e2e"))
    rng = np.random.default_rng(21)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=len(SPLITS),
                                      genome_len=6000)
    layout = os.path.join(tmp, "binning.out")
    lines, b = [], 0
    for name, n in zip(sorted(os.listdir(gdir)), SPLITS):
        lines.append(f"{os.path.join(gdir, name)}\t{b}\t{n}")
        b += n
    with open(layout, "w") as fh:
        fh.write("#HIGH_LEVEL_IBF max_bin_id:0\n"
                 "#FILES\tBIN_INDICES\tNUMBER_OF_BINS\n"
                 + "\n".join(lines) + "\n")
    idx = os.path.join(tmp, "idx.taxor.npz")
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
        kmer_size=22, syncmer_size=12, use_syncmer=True,
        layout_file=layout, resume=True))
    reads_fa = make_reads(tmp, rng, genomes, n_reads_per_genome=3,
                          read_len=900, error_rate=0.03)
    recs = [(r.id, r.seq) for r in read_all(reads_fa)]
    arr = np.frombuffer(recs[0][1], np.uint8).copy()
    arr[100:140] = ord("A")  # tied window minima
    recs.append(("homopolymer_read", arr.tobytes()))
    whole = b"".join(genomes.values())  # 36 kb: over L_CAP
    recs += [("long0", whole[:33000]), ("long1", whole[1000:34500])]
    write_fasta(reads_fa, recs)
    return index, idx, reads_fa, [s for _, s in recs], tmp


def test_split_index_has_multi_bin_runs(split_setup):
    index = split_setup[0]
    starts, ends, _ = index.hixf.runs_of_ixf(0)
    assert len(index.hixf.ixfs) == 1 and (ends - starts).max() == 3
    assert DeviceHIXF.from_hixf(index.hixf, "cpu").prefix_runs == 0


def flat_steps(split_setup, hcap, topk):
    """(port step, JAX step in interpret mode, the reads' lengths) on the
    last 16 reads up to L_CAP, with the extraction engine each package's
    flag selects."""
    index, _, _, seqs, _ = split_setup
    seqs = [s for s in seqs if len(s) <= dsync.L_CAP][-16:]  # one tile
    scheme = index.scheme
    ixf = index.hixf.ixfs[0]
    L = dsync.pad_len_bucket(max(len(s) for s in seqs))
    hcap = hcap or dsync.hash_cap(L, scheme.kmer_size, scheme.syncmer_size,
                                  scheme.t_syncmer)
    packed, lengths = dsync.pack_reads(seqs, L)
    rpad = (-len(seqs)) % 16  # the Pallas read tile
    packed = np.pad(packed, ((0, rpad), (0, 0)))
    lengths = np.pad(lengths, (0, rpad))
    kw = dict(k=scheme.kmer_size, s=scheme.syncmer_size,
              t=scheme.t_syncmer, hcap=hcap, topk=topk)

    fp = prepare_fingerprints(ixf.fingerprints)
    starts, ends, users = index.hixf.runs_of_ixf(0)
    onehot = np.zeros((fp.shape[1] * 4, starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    want = np.asarray(jax_fused_e2e_step(
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
    return got, want, lengths[:len(seqs)]


@pytest.mark.parametrize("hcap,topk", [(None, 16), (8, 2)])
def test_fused_step_matches_jax(split_setup, hcap, topk):
    """Identical packed [R, 2*topk + 2] output; hcap=8 makes every read
    overflow the hash capacity and topk=2 truncates the candidates."""
    got, want, lengths = flat_steps(split_setup, hcap, topk)
    assert got.dtype == np.int32 and got.shape == (len(want),
                                                   2 * topk + 2)
    np.testing.assert_array_equal(got, want)
    n_emit = got[:len(lengths), -1]
    if hcap == 8:
        assert (n_emit[lengths >= 100] > hcap).all()


@pytest.mark.parametrize("hcap,topk", [(None, 16), (8, 2)])
def test_split_step_matches_jax(split_setup, split_engine, hcap, topk):
    """With the split engine (USE_FUSED_EXTRACT = False) in both packages
    the flat steps are equal, and equal the port's K1 step."""
    got, want, _ = flat_steps(split_setup, hcap, topk)
    np.testing.assert_array_equal(got, want)
    split_engine.setattr(e2e, "USE_FUSED_EXTRACT", True)
    np.testing.assert_array_equal(got, flat_steps(split_setup, hcap,
                                                  topk)[0])


def search(config_kw, idx, reads, out, device="cpu"):
    cfg = pipeline.SearchConfig(index_file=idx, query_file=reads,
                                report_file=out, **config_kw)
    pipeline.run_search(cfg, device=device)
    with open(out, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def host_tsv(split_setup):
    _, idx, reads, _, tmp = split_setup
    out = os.path.join(tmp, "jax_host.tsv")
    jax_pipeline.run_search(jax_pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=out, engine="host"))
    with open(out, "rb") as fh:
        return fh.read()


def test_search_device_equals_host(split_setup, host_tsv):
    _, idx, reads, seqs, tmp = split_setup
    pipeline.ROUTES.reset()
    dev = search({"engine": "device"}, idx, reads,
                 os.path.join(tmp, "dev.tsv"))
    routes = dict(pipeline.ROUTES.counts)
    host = search({"engine": "host"}, idx, reads,
                  os.path.join(tmp, "host.tsv"))
    assert dev == host == host_tsv
    # the reads over L_CAP take the fused step in pieces
    assert routes["long_fused"] == 2 and routes["host_hashes"] == 0
    assert routes["fused"] == len(seqs)
    rows = host_tsv.decode().splitlines()[1:]
    hits = sum(r.split("\t")[1] != "-" for r in rows)
    assert hits >= len(seqs) * 3 // 4


def test_search_split_engine_equals_host(split_setup, host_tsv,
                                        monkeypatch):
    _, idx, reads, _, tmp = split_setup
    monkeypatch.setattr(e2e, "USE_FUSED_EXTRACT", False)
    dev = search({"engine": "device"}, idx, reads,
                 os.path.join(tmp, "dev_split.tsv"))
    assert dev == host_tsv


def test_search_hash_capacity_overflow_falls_back(split_setup, host_tsv,
                                                  monkeypatch):
    _, idx, reads, _, tmp = split_setup
    monkeypatch.setattr(hixf_search, "hash_cap", lambda L, k, s, t: 8)
    pipeline.ROUTES.reset()
    dev = search({"engine": "device"}, idx, reads,
                 os.path.join(tmp, "dev_hcap.tsv"))
    assert dev == host_tsv
    assert pipeline.ROUTES.counts["host_fallback"] >= 10


def test_search_topk_truncation_falls_back(split_setup, host_tsv):
    index, _, reads, _, tmp = split_setup
    idx1 = os.path.join(tmp, "idx_topk1.taxor.npz")
    save_index(idx1, dataclasses.replace(index, suggested_topk=1))
    pipeline.ROUTES.reset()
    dev = search({"engine": "device", "topk": 1, "pipeline_depth": 1,
                  "batch_size": 4}, idx1, reads,
                 os.path.join(tmp, "dev_topk1.tsv"))
    assert dev == host_tsv
    assert pipeline.ROUTES.counts["host_fallback"] >= 1


def test_hierarchical_index_is_refused(tmp_path):
    """A genuine hierarchical index is accepted (no longer refused): it
    takes the grouped descent, not the flat fast path."""
    index = build_hier_index(str(tmp_path))[0]
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    assert len(dh.ixfs) > 1 and not dh.flat_fast_path
    assert dh.e2e_capable(Thresholder.make(22, 22, 0.04, -1.0, True))


def test_cuda_without_a_card_is_refused(split_setup, monkeypatch):
    _, idx, reads, _, tmp = split_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search({"engine": "device"}, idx, reads,
               os.path.join(tmp, "never.tsv"), device="cuda")
