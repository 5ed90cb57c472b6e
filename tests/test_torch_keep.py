"""FracMinHash in K5's contract and the layout sketch of scaled schemes,
against the JAX package.

K5 (``device/extract.minimizer_kmers``) computes the FracMinHash keep
itself: on a CPU tensor its plain twin must give what the JAX
``minimizer_kmers`` followed by the JAX ``_scaling_keep`` gives, element
for element, and the flat fused step of a scaled minimiser scheme must
give the JAX step's packed output.  The layout of a scaled scheme sketches
its hashes with a mix independent of the keep (ROADMAP C.2): the sketch
of a scaled set estimates its size, and a scaled hierarchy is as shallow
as the same set's unscaled one, where the JAX package's layout of the
same hashes degenerates into a chain.  Every comparison of outputs is
exact (integer equality)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxor_tpu.apps.build import BuildConfig as JaxBuildConfig
from taxor_tpu.apps.build import run_build as jax_run_build
from taxor_tpu.device import e2e as jax_e2e
from taxor_tpu.device.pallas_probe import (choose_bin_tile4,
                                           prepare_fingerprints)
from taxor_tpu.hash import device_syncmer as jax_dsync
from taxor_tpu.hixf import binning as jax_binning
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device import extract
from taxor_tpu_torch.device.e2e import fused_e2e_step
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash.schemes import (HashScheme, scaling_filter,
                                          scaling_threshold_u64)
from taxor_tpu_torch.hixf import binning
from taxor_tpu_torch.hixf.build import precompute_file_hashes
from taxor_tpu_torch.hixf.layout import parse_layout

from .test_torch_minimizer import hard_reads
from .util import make_ref_set

U64_MAX = (1 << 64) - 1
KEEP_SCHEMES = [(20, 26), (20, 20), (32, 40), (18, 26)]  # (k, window)
THRESHOLDS = {  # name -> scale_thresh
    "none": 0,
    "scaling2": scaling_threshold_u64(2),
    "scaling3": scaling_threshold_u64(3),
    "scaling7": scaling_threshold_u64(7),
    "scaling1000": scaling_threshold_u64(1000),
    "all": U64_MAX,
}


@pytest.mark.parametrize("thresh", list(THRESHOLDS))
@pytest.mark.parametrize("k,window", KEEP_SCHEMES)
def test_minimizer_keep_matches_jax(k, window, thresh):
    """(hi, lo, valid, n_emit, n_unique) of the port's minimizer_kmers
    with scale_thresh against the JAX minimizer_kmers followed by the JAX
    _scaling_keep: valid = emit and kept, n_emit the emissions before the
    keep, n_unique the valid slots; hi/lo the emitted value wherever it
    is emitted (kept or not) and 0 elsewhere.  Ragged reads, reads
    shorter than k and than the window, N bases, tied windows."""
    T = THRESHOLDS[thresh]
    rng = np.random.default_rng(k * 1000 + window)
    L = 512
    packed, lengths = dsync.pack_reads(hard_reads(rng, k, window, L), L)
    whi, wlo, wemit, wn_emit = (np.asarray(x) for x in
                                jax_dsync.minimizer_kmers(packed, lengths, k,
                                                          window))
    wvalid = wemit & (np.asarray(jax_e2e._scaling_keep(
        jnp.asarray(whi), jnp.asarray(wlo), T)) if T else True)
    hi, lo, valid, n_emit, n_unique = (x.numpy() for x in
                                       extract.minimizer_kmers(
                                           torch.from_numpy(packed),
                                           torch.from_numpy(lengths), k,
                                           window, T))
    assert valid.dtype == bool and n_unique.dtype == n_emit.dtype == np.int32
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_array_equal(n_emit, wn_emit)
    np.testing.assert_array_equal(n_unique, wvalid.sum(axis=1))
    np.testing.assert_array_equal(hi[wemit], whi.view(np.int32)[wemit])
    np.testing.assert_array_equal(lo[wemit], wlo.view(np.int32)[wemit])
    assert not hi[~wemit].any() and not lo[~wemit].any()
    assert n_emit.max() > 0
    if thresh in ("none", "all"):
        np.testing.assert_array_equal(valid, wemit)
    elif thresh != "scaling1000":
        assert 0 < n_unique.sum() < n_emit.sum()


@pytest.mark.parametrize("k,window,L", [(20, 300, 256), (16, 600, 512),
                                        (20, 280, 512)])
def test_minimizer_twin_windows_past_the_bucket(k, window, L):
    """Windows as long as the bucket or longer (the twin once failed on
    a shift past the row): each read, cut to the bucket, emits what the
    host oracle emits for it, none where the read is shorter than the
    window."""
    from taxor_tpu.hash.encode import encode_dna4
    from taxor_tpu.hash.minimizer import minimiser_hashes

    from .test_torch_minimizer import values

    rng = np.random.default_rng(window)
    seqs = [s[:L] for s in hard_reads(rng, k, window, L)
            if b"N" not in s]
    packed, lengths = dsync.pack_reads(seqs, L)
    hi, lo, valid, n_emit, n_unique = (x.numpy() for x in
                                       extract.minimizer_kmers(
                                           torch.from_numpy(packed),
                                           torch.from_numpy(lengths), k,
                                           window))
    for r, s in enumerate(seqs):
        want = minimiser_hashes(encode_dna4(s), k, window)
        assert n_emit[r] == n_unique[r] == want.shape[0], r
        np.testing.assert_array_equal(values(hi[r], lo[r], valid[r]), want)
    assert (n_emit.sum() > 0) == (window < L)


# ----------------------------------------------------- the flat fused step --
@pytest.fixture(scope="module")
def scaled_flat(tmp_path_factory):
    """One reference set; a flat JAX-built minimiser index per scaling,
    built on demand."""
    tmp = str(tmp_path_factory.mktemp("torch_keep_flat"))
    rng = np.random.default_rng(12)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=12,
                                      genome_len=8000)
    indexes = {}

    def index(scaling):
        if scaling not in indexes:
            from taxor_tpu_torch.hixf.index import load_index

            idx = os.path.join(tmp, f"scaled{scaling}.taxor.npz")
            jax_run_build(JaxBuildConfig(
                input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
                kmer_size=18, window_size=24, use_syncmer=False,
                scaling=scaling, layout_mode="flat", layout_file=""))
            indexes[scaling] = load_index(idx)
        return indexes[scaling]

    return index, genomes


@pytest.mark.parametrize("scaling", [2, 3, 7])
def test_scaled_minimizer_flat_step_matches_jax(scaled_flat, scaling):
    """The packed [R, 2*topk + 2] output of the port's flat step (the
    keep in K5's twin) equals the JAX fused_e2e_step's (Pallas in
    interpret mode, the keep after its extraction) on reads from the
    references, a read of N bases, one shorter than the window, an empty
    one and a homopolymer."""
    index_of, genomes = scaled_flat
    index = index_of(scaling)
    sch = index.scheme
    assert sch.scaling == scaling and not sch.use_syncmer
    rng = np.random.default_rng(scaling)
    seqs = [g[o:o + int(n)] for g, o, n in zip(
        genomes.values(), rng.integers(0, 7000, 12),
        rng.integers(150, 257, 12))]
    seqs += [b"N" * 200, b"ACGT" * 5, b"", b"A" * 240]  # 16: blocks of 8
    L = 256
    packed, lengths = dsync.pack_reads(seqs, L)
    kw = dict(k=sch.kmer_size, s=sch.syncmer_size, t=sch.t_syncmer, hcap=L,
              topk=8, scheme_kind="minimizer", window=sch.window_size,
              scale_thresh=scaling_threshold_u64(scaling))
    ixf = index.hixf.ixfs[0]
    fp = prepare_fingerprints(ixf.fingerprints)
    starts, ends, users = index.hixf.runs_of_ixf(0)
    onehot = np.zeros((fp.shape[1] * 4, starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    want = np.asarray(jax_e2e.fused_e2e_step(
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
    np.testing.assert_array_equal(got, want)
    assert (got[:, -2] < got[:, -1]).sum() >= 10  # the keep dropped some
    assert (got[:12, 0] > 0).sum() >= 10  # most reads hit a bin


# ------------------------------------------------ the layout sketch (C.2) --
@pytest.mark.parametrize("scaling", [2, 3, 4])
def test_scaled_sketch_estimates_the_set(scaling):
    """The sketch of a FracMinHash-scaled set (the hashes whose wyhash64
    is at most 2^64 / scaling) estimates its true size within 10%, at
    several sizes."""
    rng = np.random.default_rng(scaling)
    pool = rng.integers(0, U64_MAX, 120_000, dtype=np.uint64, endpoint=True)
    for n in (3_000, 30_000, 120_000):
        kept = scaling_filter(pool[:n], scaling)
        est = binning.make_sketch(kept, scaling=scaling).estimate()
        assert abs(est - kept.size) <= 0.1 * kept.size, (n, kept.size, est)


def test_unscaled_sketch_is_the_jax_sketch():
    """Unscaled sets keep the JAX package's sketch (wyhash64), register
    for register, so their layouts stay byte-equal to the JAX package's
    (tests/test_torch_hostlayer.py)."""
    rng = np.random.default_rng(9)
    h = rng.integers(0, U64_MAX, 20_000, dtype=np.uint64, endpoint=True)
    np.testing.assert_array_equal(
        binning.make_sketch(h).registers, jax_binning.make_sketch(h).registers)


def layout_depth(node) -> int:
    return 1 + max((layout_depth(c) for c in node.children.values()),
                   default=0)


@pytest.fixture(scope="module")
def layout_set(tmp_path_factory):
    """200 genomes of 30 kb: under k = 16, window 22 and scaling 3 the
    JAX package's sketches saturate (each holds ~2,400 hashes) and its
    layout is a chain; layouts of the port's builds by scaling."""
    tmp = str(tmp_path_factory.mktemp("torch_keep_layout"))
    rng = np.random.default_rng(3)
    tsv, gdir, _ = make_ref_set(tmp, rng, n_species=200, genome_len=30000)
    depths = {}

    def depth(scaling):
        if scaling not in depths:
            lay = os.path.join(tmp, f"scaling{scaling}.binning.out")
            run_build(BuildConfig(
                input_file=tsv, input_sequence_dir=gdir, output_filename="",
                kmer_size=16, window_size=22, use_syncmer=False,
                scaling=scaling, layout_mode="auto", tmax=64,
                layout_file=lay))
            depths[scaling] = layout_depth(parse_layout(lay))
        return depths[scaling]

    return depth, gdir


@pytest.mark.parametrize("scaling", [3, 4])
def test_scaled_layout_stays_shallow(layout_set, scaling):
    """A scaled `--layout auto` build is at most one level deeper than the
    same set unscaled, where the JAX package's layout of the same hashes
    is a chain more than ten levels deep."""
    depth, gdir = layout_set
    files = sorted(os.path.join(gdir, f) for f in os.listdir(gdir))
    scheme = HashScheme.make(kmer_size=16, syncmer_size=0, window_size=22,
                             use_syncmer=False, scaling=scaling)
    jax_depth = layout_depth(jax_binning.compute_layout_from_hashes(
        precompute_file_hashes(files, scheme),
        {f"A{i}": [f] for i, f in enumerate(files)}, tmax=64))
    assert jax_depth > 10
    assert depth(1) >= 2  # hierarchical: more genomes than technical bins
    assert depth(scaling) <= depth(1) + 1
