"""The hierarchical slice: the port's level-grouped descent and per-IXF
traversal against the JAX package on a multi-level index (Pallas in
interpret mode, or its XLA engine), and the grouped probe twin against
count_xla and the TPU's replicated-row kernel ``_kernel_repl``.  Every
comparison is exact integer or byte equality."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.apps.build import BuildConfig, run_build
from taxor_tpu.device import e2e as jax_e2e
from taxor_tpu.device import pallas_probe
from taxor_tpu.device.hixf_search import DeviceHIXF as JaxDeviceHIXF
from taxor_tpu.device.probe import count_xla
from taxor_tpu.device.probe import pad_fingerprints as jax_pad_fingerprints
from taxor_tpu.hash.schemes import search_hashes
from taxor_tpu.hixf.index import save_index
from taxor_tpu.io.fastx import read_all
from taxor_tpu.ixf.xor_filter import compute_probes
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu.search.thresholds import Thresholder
from taxor_tpu.utils.u64np import fingerprint8, mix_split
from taxor_tpu_torch.device import e2e, hixf_search, probe
from taxor_tpu_torch.device.e2e import make_hixf_e2e_grouped_fn
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.tools.synth import write_wide_root_layout
from taxor_tpu_torch.utils.u64 import split32

from .util import make_reads, make_ref_set, simulate_read, write_fasta


def build_hier_index(tmp: str):
    """100 species x 3 kb, k=22/s=12 syncmers, the hierarchical layout
    (tmax 64 technical bins per IXF); 200 reads of 800 b, 2% errors, then
    two reads over L_CAP.  Returns (index, index file, reads file,
    sequences)."""
    rng = np.random.default_rng(21)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=3000)
    idx = os.path.join(tmp, "hier.taxor.npz")
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
        kmer_size=22, syncmer_size=12, use_syncmer=True,
        layout_mode="auto", tmax=64,
        layout_file=os.path.join(tmp, "b.out")))
    assert len(index.hixf.ixfs) > 1  # genuinely hierarchical
    reads_fa = make_reads(tmp, rng, genomes, n_reads_per_genome=2,
                          read_len=800, error_rate=0.02)
    recs = [(r.id, r.seq) for r in read_all(reads_fa)]
    whole = b"".join(genomes.values())
    recs += [("long0", whole[:33000]), ("long1", whole[90000:125000])]
    write_fasta(reads_fa, recs)
    return index, idx, reads_fa, [s for _, s in recs]


@pytest.fixture(scope="module")
def hier_setup(tmp_path_factory):
    return build_hier_index(str(tmp_path_factory.mktemp("torch_hier")))


@pytest.fixture
def split_engine(monkeypatch):
    """USE_FUSED_EXTRACT = False in both packages.  The JAX steps read the
    flag when they trace, so their jit caches are cleared before and
    after."""
    jax.clear_caches()
    monkeypatch.setattr(jax_e2e, "USE_FUSED_EXTRACT", False)
    monkeypatch.setattr(e2e, "USE_FUSED_EXTRACT", False)
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def thresholder_of(index, percentage=-1.0):
    sch = index.scheme
    return Thresholder.make(sch.kmer_size, sch.window_size, 0.04, percentage,
                            sch.use_syncmer)


def fused_reads(seqs, n=48):
    seqs = [s for s in seqs if len(s) <= dsync.L_CAP][:n]
    L = dsync.pad_len_bucket(max(len(s) for s in seqs))
    return dsync.pack_reads(seqs, L)


def test_tree_metadata_matches_jax(hier_setup):
    index = hier_setup[0]
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    ref = JaxDeviceHIXF(index.hixf, engine="xla")
    assert not dh.flat_fast_path and len(dh.ixfs) == len(ref.ixfs)
    assert dh.bfs_order == ref.bfs_order and dh.parent == ref.parent
    assert dh._depths() == ref._depths()
    # the level below the root splits into stacked subgroups
    Gs = [g["tables"].shape[0] for g in dh.groups]
    assert Gs[0] == 1 and max(Gs) >= 2
    assert all(g["tables"].shape[2] <= probe.NARROW_MAX_BINS
               for g in dh.groups)
    _, jax_leaf_users = ref._build_probe_groups(max_group_b4=128)
    np.testing.assert_array_equal(dh.leaf_users.numpy(), jax_leaf_users)


@pytest.mark.parametrize("percentage", [-1.0, 0.3])
def test_grouped_step_matches_jax(hier_setup, percentage):
    """The packed [R, 2*topk + 2] output of the port's grouped step equals
    the JAX grouped step's (Pallas in interpret mode) element for
    element."""
    index = hier_setup[0]
    th = thresholder_of(index, percentage)
    packed, lengths = fused_reads(hier_setup[3])
    ref = JaxDeviceHIXF(index.hixf, engine="pallas")
    ref._interpret = True
    assert ref.e2e_capable(th)
    want = ref.e2e_async(packed, lengths, index.scheme, th)()
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    assert dh.e2e_capable(th) and not dh.e2e_capable(None)
    got = dh.e2e_async(packed, lengths, index.scheme, th)()
    assert got[4] == want[4]  # hcap
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (got[0][:, 0] >= 0).all()  # every read reached a leaf


def test_grouped_split_step_matches_jax(hier_setup, split_engine):
    """With the split engine (USE_FUSED_EXTRACT = False) in both packages,
    the port's grouped step equals the JAX grouped step (its XLA tracker
    and the Pallas dedup in interpret mode), and equals the port's K1
    step."""
    index = hier_setup[0]
    th = thresholder_of(index)
    packed, lengths = fused_reads(hier_setup[3])
    ref = JaxDeviceHIXF(index.hixf, engine="pallas")
    ref._interpret = True
    want = ref.e2e_async(packed, lengths, index.scheme, th)()
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    got = dh.e2e_async(packed, lengths, index.scheme, th)()
    split_engine.setattr(e2e, "USE_FUSED_EXTRACT", True)
    k1 = dh.e2e_async(packed, lengths, index.scheme, th)()
    assert got[4] == want[4] == k1[4]  # hcap
    for a, b, c in zip(got[:4], want[:4], k1[:4]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert (got[0][:, 0] >= 0).all()


def test_thr_table_matches_jax(hier_setup):
    index = hier_setup[0]
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    ref = JaxDeviceHIXF(index.hixf, engine="xla")
    for pct in (-1.0, 0.25, 1.0):
        th = thresholder_of(index, pct)
        got = dh._thr_table(th, 512)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref._thr_table(th, 512))


def test_stacked_equals_unstacked(hier_setup):
    """Subgroups of 128 words stacked into one launch over G, the same
    subgroups one launch each, and one group per level give the same
    packed output."""
    index = hier_setup[0]
    th = thresholder_of(index)
    packed, lengths = fused_reads(hier_setup[3])
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    split, leaf_users = dh._build_probe_groups(max_group_b4=128)
    whole, leaf_users_w = dh._build_probe_groups()
    np.testing.assert_array_equal(leaf_users, leaf_users_w)
    variants = {
        "stacked": dh._stack_host_groups(split),
        "one per launch": [dh._stack_host_groups([g])[0] for g in split],
        "one per level": dh._stack_host_groups(whole),
    }
    assert max(g["tables"].shape[0] for g in variants["stacked"]) >= 2
    assert len(variants["one per level"]) < len(variants["one per launch"])
    hcap = dsync.hash_cap(packed.shape[1] * 4)
    tbl = torch.from_numpy(dh._thr_table(th, hcap))
    sch = index.scheme
    outs = {}
    for name, groups in variants.items():
        fn = make_hixf_e2e_grouped_fn(
            dh.upload_groups(groups), torch.from_numpy(
                leaf_users.astype(np.int32)), k=sch.kmer_size,
            s=sch.syncmer_size, t=sch.t_syncmer, topk=16)
        outs[name] = fn(torch.from_numpy(packed), torch.from_numpy(lengths),
                        tbl, hcap).numpy()
    for name in variants:
        np.testing.assert_array_equal(outs[name], outs["stacked"])


def test_counts_traversal_matches_jax(hier_setup):
    """The per-IXF traversal for reads over L_CAP: (counts, emitted) equal
    the JAX traversal's (XLA engine)."""
    index, _, _, seqs = hier_setup
    th = thresholder_of(index)
    seqs = seqs[:20] + seqs[-2:]
    hl = search_hashes(seqs, index.scheme)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    H = max(h.shape[0] for h in hl)
    hashes = np.zeros((len(hl), H), dtype=np.uint64)
    mask = np.zeros((len(hl), H), dtype=bool)
    for r, h in enumerate(hl):
        hashes[r, :h.shape[0]] = h
        mask[r, :h.shape[0]] = True
    want = JaxDeviceHIXF(index.hixf, engine="xla").counts(hashes, mask, thr)
    hi, lo, valid = probe.pack_hash_lists(hl, H)
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    got = dh.counts_async(hi, lo, valid, thr)()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any(axis=1).sum() >= len(seqs) // 2


def run_search(idx, reads, out, **kw):
    cfg = pipeline.SearchConfig(index_file=idx, query_file=reads,
                                report_file=out, **kw)
    pipeline.run_search(cfg, device="cpu")
    with open(out, "rb") as fh:
        return fh.read()


def test_search_cpu_equals_jax_host(hier_setup, tmp_path):
    """The hierarchical --device cpu TSV (the plain twins) equals the JAX
    --engine host TSV byte for byte, with two reads over L_CAP on the
    per-IXF traversal."""
    _, idx, reads, seqs = hier_setup
    want_path = str(tmp_path / "jax_host.tsv")
    jax_pipeline.run_search(jax_pipeline.SearchConfig(
        index_file=idx, query_file=reads, report_file=want_path,
        engine="host"))
    with open(want_path, "rb") as fh:
        want = fh.read()
    pipeline.ROUTES.reset()
    dev = run_search(idx, reads, str(tmp_path / "dev.tsv"), engine="device")
    routes = dict(pipeline.ROUTES.counts)
    host = run_search(idx, reads, str(tmp_path / "host.tsv"), engine="host")
    assert dev == host == want
    assert routes["host_hashes"] == 2 and routes["fused"] == len(seqs) - 2
    rows = want.decode().splitlines()[1:]
    assert sum(r.split("\t")[1] != "-" for r in rows) >= len(seqs) * 3 // 4


def test_search_topk_truncation_falls_back(hier_setup, tmp_path):
    """top-k 1 truncates the leaf candidates of reads that hit two user
    bins: they fall back to the host oracle and the text stays equal."""
    index, _, reads, _ = hier_setup
    idx1 = str(tmp_path / "hier_topk1.taxor.npz")
    save_index(idx1, dataclasses.replace(index, suggested_topk=1))
    host = run_search(idx1, reads, str(tmp_path / "host.tsv"), engine="host")
    pipeline.ROUTES.reset()
    dev = run_search(idx1, reads, str(tmp_path / "dev.tsv"), engine="device",
                     topk=1, pipeline_depth=1, batch_size=32)
    assert dev == host
    assert pipeline.ROUTES.counts["host_fallback"] >= 1


def keys_case(rng, R, H, ixf_seed):
    """Random keys, read 0 all fingerprint 0 (counts > 256 in zero
    columns), the last read all invalid, invalid slots elsewhere."""
    pool = rng.integers(0, 2**64, 400_000, dtype=np.uint64)
    zero = pool[fingerprint8(mix_split(pool, ixf_seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = zero[:H]
    valid = rng.random((R, H)) < 0.8
    valid[R - 1] = False
    hi, lo = split32(torch.from_numpy(keys.view(np.int64)))
    return keys, hi.contiguous(), lo.contiguous(), valid


def test_grouped_twin_matches_plain_and_count_xla():
    rng = np.random.default_rng(9)
    G, R, H, bl, Bp = 3, 5, 400, 300, 64
    ixf_seed = int(rng.integers(0, 2**63))
    tables = rng.integers(0, 256, (G, 3 * bl, Bp), dtype=np.uint8)
    tables[:, :, ::5] = 0
    keys, hi, lo, valid = keys_case(rng, R, H, ixf_seed)
    active = rng.random((G, R)) < 0.6
    active[:, 0] = True
    active[1] = False  # a subgroup no read descends into
    got = probe.probe_counts_grouped(
        hi, lo, torch.from_numpy(valid), torch.from_numpy(tables),
        torch.from_numpy(active), ixf_seed, bl).numpy()
    assert got.shape == (G, R, Bp) and got.dtype == np.int32
    pos, fpr, _ = compute_probes(keys.reshape(-1), ixf_seed, bl)
    for g in range(G):
        m = valid & active[g][:, None]
        plain = probe.probe_counts_plain(
            hi, lo, torch.from_numpy(m), torch.from_numpy(tables[g]),
            ixf_seed, bl).numpy()
        xla = np.asarray(count_xla(
            jnp.asarray(tables[g]),
            jnp.asarray(pos.reshape(R, H, 3).astype(np.int32)),
            jnp.asarray(fpr.reshape(R, H)), jnp.asarray(m)))
        np.testing.assert_array_equal(got[g], plain)
        np.testing.assert_array_equal(got[g], xla)
        assert (got[g][~active[g]] == 0).all()
    assert got[0, 0].max() > 256 and (got[:, R - 1] == 0).all()


@pytest.mark.parametrize("bins", [16, 64, 100, 512])
def test_k2n_twin_matches_kernel_repl(monkeypatch, bins):
    """The twin K2n is held to: the TPU's replicated-row kernel
    _kernel_repl (switched on for the test, interpret mode) at B4 <= 128
    words, the widths that K2n serves; bins=100 is a B4 that is not a
    power of two."""
    monkeypatch.setattr(pallas_probe, "USE_REPL_PROBE", True)
    rng = np.random.default_rng(bins)
    R, H, bl = 16, 512, 200  # R: one Pallas read tile
    ixf_seed = int(rng.integers(0, 2**63))
    table = rng.integers(0, 256, (3 * bl, bins), dtype=np.uint8)
    table[:, ::3] = 0
    keys, hi, lo, valid = keys_case(rng, R, H, ixf_seed)
    act = np.ones(R, dtype=bool)
    act[2] = False
    m = valid & act[:, None]
    fp_packed = pallas_probe.prepare_fingerprints(table, lane=4)
    S1, B4 = fp_packed.shape
    assert pallas_probe._repl_eligible(S1, B4)
    pos, fpr, _ = compute_probes(keys.reshape(-1), ixf_seed, bl)
    pos = np.where(m[..., None], pos.reshape(R, H, 3), S1 - 1)
    f4 = np.where(m, fpr.reshape(R, H).astype(np.uint32), 1) * np.uint32(
        0x01010101)
    want = np.asarray(pallas_probe._probe_call_chunked(
        jnp.asarray(fp_packed), jnp.asarray(pos.astype(np.int32)),
        jnp.asarray(f4.astype(np.uint32).view(np.int32)), jnp.asarray(m),
        B4, True))
    tables = torch.from_numpy(probe.pad_fingerprints(table))[None]
    got = probe.probe_counts_grouped(
        hi, lo, torch.from_numpy(valid), tables,
        torch.from_numpy(act)[None], ixf_seed, bl)[0].numpy()
    np.testing.assert_array_equal(got[:, :bins], want[:, :bins])
    assert got[0].max() > 256 and (got[2] == 0).all()


def descent_inputs(index, seqs):
    """K1-twin hashes (hi, lo, valid) and the count-indexed thresholds of
    the fused reads of seqs, as the grouped step computes them."""
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    packed, lengths = fused_reads(seqs)
    sch = index.scheme
    hcap = dsync.hash_cap(packed.shape[1] * 4)
    hi, lo, valid, n_unique, _ = e2e._syncmer_hashes(
        torch.from_numpy(packed), torch.from_numpy(lengths), sch.kmer_size,
        sch.syncmer_size, sch.t_syncmer, hcap)
    thr = torch.from_numpy(dh._thr_table(thresholder_of(index), hcap))[
        n_unique.clamp(0, hcap).long()]
    return dh, hi, lo, valid, thr


def test_run_sums_twin_matches_jax_onehot(hier_setup):
    """Every descent group's run sums (probe_run_sums_grouped's twin, the
    contract K2n computes), with the descent's own activity, against the
    JAX composite member by member: count_xla on the member IXF's own
    table under its subgroup's mask, times the JAX DeviceHIXF's one-hot
    run matrix of that IXF."""
    index, _, _, seqs = hier_setup
    dh, hi, lo, valid, thr = descent_inputs(index, seqs)
    ref = JaxDeviceHIXF(index.hixf, engine="xla")
    keys = ((hi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo.numpy().view(np.uint32).astype(np.uint64))
    R, H = keys.shape
    n_nodes = len(dh.bfs_order)
    partial = 0
    for gi, g in enumerate(dh.groups):
        act = e2e.descend(dh.groups, n_nodes, hi, lo, valid, thr, upto=gi)
        got = probe.probe_run_sums_grouped(
            hi, lo, valid, g["tables"], act, g["run_off"], g["run_s"],
            g["run_e"], g["seed"], g["bl"]).numpy()
        assert got.shape == (g["run_s"].shape[0], R)
        partial += 0 < int(act.sum()) < act.numel()
        for (b, ro, n, _, _), sub in zip(g["members"],
                                         g["member_sub"].tolist()):
            i = dh.bfs_order[b]
            jx = ref.ixfs[i]
            fp = index.hixf.ixfs[i].fingerprints
            pos, fpr, _ = compute_probes(keys.reshape(-1), jx.seed,
                                         jx.block_length)
            mask = valid.numpy() & act[sub].numpy()[:, None]
            counts = np.asarray(count_xla(
                jnp.asarray(jax_pad_fingerprints(fp)),
                jnp.asarray(pos.reshape(R, H, 3).astype(np.int32)),
                jnp.asarray(fpr.reshape(R, H)), jnp.asarray(mask)))
            B = fp.shape[1]
            want = counts[:, :B].astype(np.float64) @ jx.onehot_host[:B]
            np.testing.assert_array_equal(got[ro:ro + n].T,
                                          want.astype(np.int32))
    assert partial >= 1  # a group probed with a mixed activity mask


def test_descent_takes_run_sums_not_dense_counts(hier_setup, monkeypatch):
    """descend and DeviceHIXF.counts reach probe_run_sums_grouped, once a
    group and once an IXF descended into, and never the dense counts
    (probe_counts_grouped) or their segment sums."""
    index, _, _, seqs = hier_setup
    calls = []
    real = probe.probe_run_sums_grouped

    def spy(*args, **kw):
        calls.append(kw["route"])
        return real(*args, **kw)

    def sentinel(*args, **kw):
        raise AssertionError("a descent group took dense counts")

    for mod in (e2e, hixf_search):
        monkeypatch.setattr(mod, "probe_run_sums_grouped", spy)
    monkeypatch.setattr(e2e, "segment_sums", sentinel)
    monkeypatch.setattr(probe, "probe_counts_grouped", sentinel)
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    packed, lengths = fused_reads(seqs)
    out = dh.e2e_async(packed, lengths, index.scheme,
                       thresholder_of(index))()
    assert calls == ["fused"] * len(dh.groups)
    assert (out[0][:, 0] > 0).any()
    calls.clear()
    hl = search_hashes(seqs[:20], index.scheme)
    th = thresholder_of(index)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    hi, lo, valid = probe.pack_hash_lists(hl, max(h.shape[0] for h in hl))
    counts, emitted = dh.counts(hi, lo, valid, thr)
    assert len(calls) > 1 and set(calls) == {"host_hashes"}
    assert emitted.any()


# -------------------------------------------- a root wider than 512 bins --
@pytest.fixture(scope="module")
def wide_setup(tmp_path_factory):
    """A hierarchical index whose root has 529 technical bins (544
    padded, past K2n's domain: the root is a descent group of its own on
    K2's route), built from a hand-written layout (write_wide_root_layout)
    over 540 genomes of 600 b; 48 reads of 400 b, 2% errors, from the
    split genome, root genomes and both children, then one read over
    L_CAP.  Returns (index, sequences)."""
    tmp = str(tmp_path_factory.mktemp("torch_wide"))
    rng = np.random.default_rng(29)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=540,
                                      genome_len=600)
    files = [os.path.join(gdir, f"{acc}_genomic.fna") for acc in genomes]
    layout = os.path.join(tmp, "wide.out")
    assert write_wide_root_layout(files, layout) == 529
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=22, syncmer_size=12, use_syncmer=True, layout_file=layout,
        resume=True))
    seqs = list(genomes.values())
    picks = [0, 0, 1, 7, 300, 519, *range(520, 540, 2),
             *rng.integers(1, 520, 28)]
    reads = [simulate_read(rng, seqs[i], 400, 0.02) for i in picks]
    return index, reads + [b"".join(seqs[:60])]


def test_wide_root_grouped_step_matches_jax(wide_setup):
    """The grouped step on an index whose root is wider than 512 bins (its
    group on K2's route, summed by segment sums) equals the JAX grouped
    step (Pallas in interpret mode, its chunked wide probe) element for
    element."""
    index, seqs = wide_setup
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    assert dh.groups[0]["tables"].shape[2] > probe.NARROW_MAX_BINS
    th = thresholder_of(index)
    packed, lengths = fused_reads(seqs)
    ref = JaxDeviceHIXF(index.hixf, engine="pallas")
    ref._interpret = True
    assert ref.e2e_capable(th) and dh.e2e_capable(th)
    want = ref.e2e_async(packed, lengths, index.scheme, th)()
    got = dh.e2e_async(packed, lengths, index.scheme, th)()
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert (got[0][:, 0] > 0).all()  # every read reached a leaf
    assert len(set(got[1][:, 0].tolist())) > 20  # many leaves, both levels


def test_wide_root_counts_traversal_matches_jax(wide_setup):
    """The per-IXF traversal on the wide-root index: (counts, emitted)
    equal the JAX traversal's (XLA engine), the children descended."""
    index, seqs = wide_setup
    th = thresholder_of(index)
    hl = search_hashes(seqs, index.scheme)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    H = max(h.shape[0] for h in hl)
    hashes = np.zeros((len(hl), H), dtype=np.uint64)
    mask = np.zeros((len(hl), H), dtype=bool)
    for r, h in enumerate(hl):
        hashes[r, :h.shape[0]] = h
        mask[r, :h.shape[0]] = True
    want = JaxDeviceHIXF(index.hixf, engine="xla").counts(hashes, mask, thr)
    hi, lo, valid = probe.pack_hash_lists(hl, H)
    got = DeviceHIXF.from_hixf(index.hixf, "cpu").counts(hi, lo, valid, thr)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][:, 520:].any()  # reads reached both children
