"""The port's sharded fused steps against the JAX package's, each case
exact: over reads x bins meshes 1 x 2, 2 x 1 and 2 x 2 of gloo ranks on
the CPU (tests/torch_world.py: one world of 4 runs every case), the
flat step (``sharding.sharded_e2e_fn``) and ``DeviceHIXF`` under a mesh
equal the JAX ``sharded_e2e_fn(interpret=True)`` on ``make_mesh(2, 2)``
of the virtual CPU devices; the hierarchical steps (percentage -1 and
0.3, and descend-all) equal the JAX ``DeviceHIXF`` under that mesh, and
the per-read descent of a scaled minimiser hierarchy decodes as the JAX
descend-all step does;
plain k-mers and scaled syncmers equal the JAX sharded step; and each
equals the port's own single-device step.  The mixed-engine fixture
(a root past the TPU's VMEM budget: the port has no engine split) is
held to the single-device step and the host oracle.  The search
pipeline under a mesh takes the fused path and writes the JAX host
engine's TSV; ``DeviceHIXF.counts`` (the long reads' traversal) under a
mesh equals the single-device one.  Every rank of a mesh ends with the
whole result (``torch_world.agreed``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from taxor_tpu.device.hixf_search import DeviceHIXF as JaxDeviceHIXF
from taxor_tpu.device.hixf_search import _scale_thresh as jax_scale_thresh
from taxor_tpu.device.pallas_probe import _READ_TILE, prepare_fingerprints
from taxor_tpu.device.sharding import make_mesh as jax_make_mesh
from taxor_tpu.device.sharding import sharded_e2e_fn as jax_sharded_e2e_fn
from taxor_tpu.hixf.index import load_index as jax_load_index
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu.search.thresholds import Thresholder as JaxThresholder
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.device.probe import pack_hash_lists
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash.schemes import search_hashes
from taxor_tpu_torch.hixf.index import save_index
from taxor_tpu_torch.io.fastx import read_all
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.search.thresholds import Thresholder

from .test_torch_minimizer import final
from .torch_world import agreed, run_world
from .util import make_reads, make_ref_set

MESHES = [(1, 2), (2, 1), (2, 2)]
MESH_IDS = [f"{a}x{b}" for a, b in MESHES]

# name -> (seed, species, genome length, reads a genome, read length,
#          build flags); the JAX suite's fixtures
FIXTURES = {
    "flat": (3, 8, 5000, 8, 800, dict(
        kmer_size=16, syncmer_size=8, use_syncmer=True, layout_mode="flat")),
    "hier": (11, 100, 2500, 1, 700, dict(
        kmer_size=16, syncmer_size=8, use_syncmer=True, layout_mode="auto",
        tmax=64)),
    "fmh": (13, 100, 2500, 1, 700, dict(
        kmer_size=16, window_size=22, use_syncmer=False, scaling=2,
        layout_mode="auto", tmax=64)),
    "mixed": (23, 192, 30000, 1, 800, dict(
        kmer_size=16, syncmer_size=8, use_syncmer=True, layout_mode="auto",
        tmax=64)),
    "kmer": (5, 6, 4000, 6, 600, dict(
        use_syncmer=False, kmer_size=18, layout_mode="flat")),
    "scaled": (5, 6, 4000, 6, 600, dict(
        use_syncmer=True, kmer_size=16, syncmer_size=8, scaling=4,
        layout_mode="flat")),
}


def build(tmp: str, name: str) -> dict:
    """The fixture's index (built by the port, saved, loaded by both
    packages), its reads and their packed bucket."""
    seed, n_species, glen, per, rlen, flags = FIXTURES[name]
    work = os.path.join(tmp, name)
    os.makedirs(work)
    rng = np.random.default_rng(seed)
    tsv, gdir, genomes = make_ref_set(work, rng, n_species=n_species,
                                      genome_len=glen)
    reads_file = make_reads(work, rng, genomes, n_reads_per_genome=per,
                            read_len=rlen, error_rate=0.03)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        layout_file=os.path.join(work, "b.out"), **flags))
    assert (len(index.hixf.ixfs) > 1) == (flags["layout_mode"] == "auto")
    idx = os.path.join(work, "idx.taxor.npz")
    save_index(idx, index)
    reads = [r.seq for r in read_all(reads_file)]
    L = dsync.pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = dsync.pack_reads(reads, L)
    packed_file = os.path.join(work, "packed.npz")
    np.savez(packed_file, packed=packed, lengths=lengths)
    return dict(index=index, idx=idx, reads=reads, reads_file=reads_file,
                packed=packed, lengths=lengths, packed_file=packed_file,
                work=work)


def host_hashes(f, percentage: float = -1.0) -> str:
    """Every read hashed on the host, packed for ``DeviceHIXF.counts``
    with the pipeline's thresholds; the .npz path."""
    scheme = f["index"].scheme
    thr = Thresholder.make(scheme.kmer_size, scheme.window_size, 0.04,
                           percentage, scheme.use_syncmer)
    hl = search_hashes(f["reads"], scheme)
    H = max(h.shape[0] for h in hl)
    hi, lo, valid = pack_hash_lists(hl, 1 << (H - 1).bit_length())
    thresholds = np.array([min(thr.get(h.shape[0], pipeline._scaling_ratio(
        h.shape[0], len(s), scheme.kmer_size)), 2**62)
        for h, s in zip(hl, f["reads"])], dtype=np.int64)
    path = os.path.join(f["work"], "hashes.npz")
    np.savez(path, hi=hi, lo=lo, valid=valid, thresholds=thresholds)
    return path


PCTS = {"hier_m1": ("hier", -1.0), "hier_03": ("hier", 0.3),
        "fmh": ("fmh", -1.0), "mixed": ("mixed", -1.0)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_sharded_e2e"))
    fx = {name: build(tmp, name) for name in FIXTURES}
    cases = [{"kind": "flat_step", "name": "flat_step",
              "index": fx["flat"]["idx"], "reads": fx["flat"]["packed_file"]},
             {"kind": "e2e", "name": "flat_e2e", "index": fx["flat"]["idx"],
              "reads": fx["flat"]["packed_file"]}]
    for case, (name, pct) in PCTS.items():
        cases.append({"kind": "e2e", "name": case, "index": fx[name]["idx"],
                      "reads": fx[name]["packed_file"], "percentage": pct,
                      "descend_all": case == "fmh"})
    cases.append({"kind": "e2e", "name": "fmh_per_read",
                  "index": fx["fmh"]["idx"], "reads": fx["fmh"]["packed_file"],
                  "percentage": -1.0})
    for name in ("kmer", "scaled"):
        cases.append({"kind": "flat_step", "name": f"{name}_step",
                      "index": fx[name]["idx"],
                      "reads": fx[name]["packed_file"]})
    for name in ("kmer", "scaled", "hier", "fmh"):
        cases.append({"kind": "search", "name": f"{name}_search",
                      "index": fx[name]["idx"],
                      "query": fx[name]["reads_file"]})
    for name in ("flat", "hier"):
        fx[name]["hashes"] = host_hashes(fx[name])
        cases.append({"kind": "counts", "name": f"{name}_counts",
                      "index": fx[name]["idx"], "hashes": fx[name]["hashes"]})
    out = os.path.join(tmp, "out")
    run_world(4, cases, MESHES, out)
    return out, fx


def single(f, percentage=None, descend_all=False) -> tuple:
    """The port's single-device step: DeviceHIXF.e2e_async on the CPU."""
    index = f["index"]
    s = index.scheme
    thr = (None if percentage is None else Thresholder.make(
        s.kmer_size, s.window_size, 0.04, percentage, s.use_syncmer))
    return DeviceHIXF(index.hixf, "cpu").e2e_async(
        f["packed"], f["lengths"], s, thr, descend_all=descend_all)()


_JAX: dict = {}


def jax_flat(f) -> np.ndarray:
    """The JAX sharded_e2e_fn on make_mesh(2, 2), interpreted; [R0, 34]."""
    key = f["idx"]
    if key in _JAX:
        return _JAX[key]
    index = jax_load_index(f["idx"])
    scheme, ixf = index.scheme, index.hixf.ixfs[0]
    fp = prepare_fingerprints(ixf.fingerprints)
    B4 = 128 * 2
    fp = np.pad(fp, ((0, 0), (0, B4 - fp.shape[1])))
    starts, ends, users = index.hixf.runs_of_ixf(0)
    onehot = np.zeros((4 * B4, starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    packed, lengths = f["packed"], f["lengths"]
    R0, L = packed.shape[0], packed.shape[1] * 4
    rpad = -R0 % (4 * _READ_TILE)
    packed = np.pad(packed, ((0, rpad), (0, 0)))
    lengths = np.pad(lengths, (0, rpad)).astype(np.int32)
    step = jax_sharded_e2e_fn(
        jax_make_mesh(2, 2), k=scheme.kmer_size, s=scheme.syncmer_size,
        t=scheme.t_syncmer, hcap=dsync.hash_cap(
            L, scheme.kmer_size, scheme.syncmer_size, scheme.t_syncmer)
        if scheme.use_syncmer else L, topk=16, interpret=True,
        scheme_kind="syncmer" if scheme.use_syncmer else "minimizer",
        window=scheme.window_size, scale_thresh=jax_scale_thresh(scheme))
    out = np.asarray(step(
        jnp.asarray(fp), jnp.asarray(packed), jnp.asarray(lengths),
        jnp.asarray(onehot), jnp.asarray(users.astype(np.int32)),
        jnp.uint32(ixf.seed >> 32), jnp.uint32(ixf.seed & 0xFFFFFFFF),
        jnp.uint32(ixf.block_length)))[:R0]
    _JAX[key] = out
    return out


def jax_hier(f, percentage: float):
    """The JAX DeviceHIXF under make_mesh(2, 2), interpreted."""
    key = (f["idx"], percentage)
    if key not in _JAX:
        index = jax_load_index(f["idx"])
        s = index.scheme
        thr = JaxThresholder.make(s.kmer_size, s.window_size, 0.04,
                                  percentage, s.use_syncmer)
        dh = JaxDeviceHIXF(index.hixf, mesh=jax_make_mesh(2, 2))
        dh._interpret = True
        assert dh.e2e_capable(thr)
        _JAX[key] = dh.e2e_async(f["packed"], f["lengths"], s, thr)()
    return _JAX[key]


def check_packed(got: np.ndarray, single_res, k: int = 16) -> None:
    """A packed [R, 2k + 2] flat result equals the single-device
    collector's tuple."""
    vals, users, counts, n_emit, _, _ = single_res
    np.testing.assert_array_equal(got[:, :k], vals)
    np.testing.assert_array_equal(got[:, k:2 * k], users)
    np.testing.assert_array_equal(got[:, 2 * k], counts)
    np.testing.assert_array_equal(got[:, 2 * k + 1], n_emit)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_sharded_flat_step_equals_jax_and_single_device(world, mesh):
    out, fx = world
    got = agreed(out, "flat_step", mesh)["packed"][:len(fx["flat"]["reads"])]
    np.testing.assert_array_equal(got, jax_flat(fx["flat"]))
    check_packed(got, single(fx["flat"]))
    assert (got[:, 0] > 0).mean() > 0.8


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_device_hixf_sharded_dispatch(world, mesh):
    """DeviceHIXF.e2e_async under a mesh (padding, shards, collector
    contract, the whole batch on every rank)."""
    out, fx = world
    got = agreed(out, "flat_e2e", mesh)
    want = jax_flat(fx["flat"])
    packed = np.concatenate([got["vals"], got["users"],
                             got["counts"][:, None], got["n_emit"][:, None]],
                            axis=1)
    np.testing.assert_array_equal(packed, want)
    check_packed(packed, single(fx["flat"]))
    assert "sums" not in got


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", ["hier_m1", "hier_03"])
def test_sharded_hixf_equals_jax_and_single_device(world, case, mesh):
    """The count-table descent, every group's runs summed over the bins
    shards before it is read, at percentage -1 and 0.3."""
    out, fx = world
    name, pct = PCTS[case]
    got = agreed(out, case, mesh)
    e_vals, e_users, e_counts, e_nemit, e_hcap = jax_hier(fx[name], pct)
    assert int(got["hcap"]) == e_hcap
    for key, want in (("vals", e_vals), ("users", e_users),
                      ("counts", e_counts), ("n_emit", e_nemit)):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    s = single(fx[name], pct)
    for key, want in zip(("vals", "users", "counts", "n_emit"), s[:4]):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert (got["vals"][:, 0] > 0).mean() > 0.5


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_sharded_descend_all_equals_jax_and_single_device(world, mesh):
    """The descend-all (chain-min) mode of a scaled minimiser hierarchy:
    the six-element collector, leaf sums included."""
    out, fx = world
    got = agreed(out, "fmh", mesh)
    want = jax_hier(fx["fmh"], -1.0)
    assert len(want) == 6
    s = single(fx["fmh"], -1.0, descend_all=True)
    for i, key in enumerate(("vals", "users", "counts", "n_emit")):
        np.testing.assert_array_equal(got[key], np.asarray(want[i]),
                                      err_msg=key)
        np.testing.assert_array_equal(got[key], s[i], err_msg=key)
    assert int(got["hcap"]) == want[4] == s[4]
    np.testing.assert_array_equal(got["sums"], np.asarray(want[5]))
    np.testing.assert_array_equal(got["sums"], s[5])


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_sharded_per_read_equals_single_device_and_jax(world, mesh):
    """The per-read descent of the scaled minimiser hierarchy under the
    mesh (the hash counts copied to the host after the row gather, the
    thresholds of the row's reads): the count-table packing, equal to
    the single-device per-read step, and decoded to the pairs that the
    JAX descend-all step decodes to, every read."""
    out, fx = world
    f = fx["fmh"]
    got = agreed(out, "fmh_per_read", mesh)
    assert "sums" not in got
    s = single(f, -1.0)
    assert s[5] is None and int(got["hcap"]) == s[4]
    for key, want in zip(("vals", "users", "counts", "n_emit"), s[:4]):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    index, scheme = f["index"], f["index"].scheme
    thr = Thresholder.make(scheme.kmer_size, scheme.window_size, 0.04, -1.0,
                           scheme.use_syncmer)
    dfs = index.hixf.user_bin_dfs_order()
    jax = [np.asarray(x) for x in jax_hier(f, -1.0)]
    pairs = [pipeline._pairs_from_e2e(*res[:4], f["reads"], index, scheme,
                                      thr, dfs, int(res[4]), sums=sums)[0]
             for res, sums in (((got["vals"], got["users"], got["counts"],
                                 got["n_emit"], got["hcap"]), None),
                               (jax, jax[5]))]
    assert [final(p) for p in pairs[0]] == [final(p) for p in pairs[1]]
    assert sum(bool(p) for p in pairs[0]) > len(f["reads"]) // 4


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_sharded_mixed_fixture_equals_single_device_and_host(world, mesh):
    """The JAX suite's mixed-engine index (its ~12k-slot root exceeds
    the TPU's shrunk VMEM budget there; the port has no engine split):
    the sharded step equals the single-device step on every read, and
    the decoded pairs equal the host oracle's membership."""
    out, fx = world
    f = fx["mixed"]
    got = agreed(out, "mixed", mesh)
    s = single(f, -1.0)
    for key, want in zip(("vals", "users", "counts", "n_emit"), s[:4]):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    index, scheme = f["index"], f["index"].scheme
    thr = Thresholder.make(scheme.kmer_size, scheme.window_size, 0.04, -1.0,
                           scheme.use_syncmer)
    pairs, _ = pipeline._pairs_from_e2e(
        got["vals"], got["users"], got["counts"], got["n_emit"], f["reads"],
        index, scheme, thr, index.hixf.user_bin_dfs_order(),
        int(got["hcap"]))
    hl = search_hashes(f["reads"], scheme)
    for r, h in enumerate(hl):
        want = index.hixf.membership(h, int(thr.get(h.shape[0], 0.0)))
        assert sorted(pairs[r]) == sorted(want), f"read {r}"


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ["kmer", "scaled"])
def test_sharded_nondefault_schemes_equal_jax(world, name, mesh):
    """Plain k-mers (K5) and FracMinHash-scaled syncmers (the keep after
    K1) through the sharded flat step."""
    out, fx = world
    f = fx[name]
    got = agreed(out, f"{name}_step", mesh)["packed"][:len(f["reads"])]
    np.testing.assert_array_equal(got, jax_flat(f))
    check_packed(got, single(f))


_HOST_TSV: dict = {}


def jax_host_tsv(f) -> str:
    """The JAX package's host engine on the fixture's reads."""
    if f["idx"] not in _HOST_TSV:
        path = os.path.join(f["work"], "jax_host.tsv")
        jax_pipeline.run_search(jax_pipeline.SearchConfig(
            index_file=f["idx"], query_file=f["reads_file"],
            report_file=path, engine="host"))
        with open(path) as fh:
            _HOST_TSV[f["idx"]] = fh.read()
    return _HOST_TSV[f["idx"]]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ["kmer", "scaled", "hier", "fmh"])
def test_pipeline_uses_fused_path_under_mesh(world, name, mesh):
    """search_single with a sharded DeviceHIXF: every read takes the
    fused step, and the TSV is the JAX host engine's byte for byte."""
    out, fx = world
    f = fx[name]
    got = agreed(out, f"{name}_search", mesh)
    assert int(got["route_fused"]) == len(f["reads"])
    assert int(got["route_host_hashes"]) == 0
    assert pipeline.HEADER + str(got["tsv"]) == jax_host_tsv(f)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ["flat", "hier"])
def test_counts_under_mesh_equal_single_device(world, name, mesh):
    """The long reads' traversal (DeviceHIXF.counts) under a mesh: the
    reads split over the rows, each IXF's run sums added over the bins
    shards, the rows gathered; a flat index takes it too."""
    out, fx = world
    f = fx[name]
    got = agreed(out, f"{name}_counts", mesh)
    inp = np.load(f["hashes"])
    counts, emitted = DeviceHIXF(f["index"].hixf, "cpu").counts(
        inp["hi"], inp["lo"], inp["valid"], inp["thresholds"])
    np.testing.assert_array_equal(got["counts"], counts)
    np.testing.assert_array_equal(got["emitted"], emitted)
    assert emitted.any(axis=1).mean() > 0.8
