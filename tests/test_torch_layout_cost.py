"""The layout DP's ``device`` cost model (hixf/device_cost.py): its host
copies of the probe kernels' routing rules against their closed forms,
the layouts it picks, its scaled-scheme charge, and what a ``device``
index searches to; the ``cpu`` model still writes the JAX package's
layout."""

import os
import re

import numpy as np
import pytest

from taxor_tpu import cli as jax_cli
from taxor_tpu.hixf import binning as jax_binning
from taxor_tpu.hixf import layout as jax_layout
from taxor_tpu_torch import cli
from taxor_tpu_torch.hixf import binning, device_cost
from taxor_tpu_torch.hixf.layout import LayoutNode, LayoutRecord, write_layout

from .util import make_reads, make_ref_set

SMEM = 232_448  # the H100's opt-in shared memory a block


def slab_closed_form(S, Bpad, H=0):
    """The widest slab of 128, 64, 32, 16 bins, no wider than Bpad needs,
    that fits SMEM, else, for reads of 8,192 hash slots or more, the
    widest thin slab of 8 or 4 bins that fits; 0 past 196,607 slots."""
    if S >= 196_608:
        return 0
    first = next(b for b in (16, 32, 64, 128) if b >= Bpad or b == 128)
    thin = (8, 4) if H >= 8192 else ()
    return next((b for b in (128, 64, 32, 16, *thin)
                 if b <= first and S * b <= SMEM), 0)


def fit_closed_form(S, Bpad):
    """The widest slab of any width down to 1 bin that fits SMEM; 0 past
    196,607 slots."""
    if S >= 196_608:
        return 0
    first = next(b for b in (16, 32, 64, 128) if b >= Bpad or b == 128)
    return next((b for b in (128, 64, 32, 16, 8, 4, 2, 1)
                 if b <= first and S * b <= SMEM), 0)


def smem_closed_form(S, Bpad):
    """K2n's smem block: the table, the control words (8 ballots and 256
    reads), 8 warps' staging (512 B) and prefix (4 (Bpad + 1) B, to 16)."""
    pref = -(-4 * (Bpad + 1) // 16) * 16
    fits = S * Bpad + 1056 + 8 * (512 + pref) <= SMEM
    return "smem" if Bpad <= 512 and fits else "rows"


@pytest.mark.parametrize("lo,hi", [(16, 512), (528, 2048), (2064, 4096)])
def test_host_routing_rules_on_the_grid(lo, hi):
    grid = [(s, b) for s, b in device_cost.routing_grid() if lo <= b <= hi]
    assert grid
    for s, b in grid:
        assert device_cost.narrow_mode(s, b) == smem_closed_form(s, b), (s, b)
        assert device_cost.slab_fit(s, b) == fit_closed_form(s, b), (s, b)
        for h in (2048, 8191, 8192):
            assert device_cost.slab_bins(s, b, h) == \
                slab_closed_form(s, b, h), (s, b, h)


@pytest.mark.parametrize("S,Bpad,want", [
    (411, 512, "k2n_smem"), (412, 512, "k2n_rows"), (3632, 4096, "k2_slab"),
    (14528, 4096, "k2_slab"), (14529, 4096, "k2_thin"),
    (39621, 1024, "k2_thin"), (58112, 528, "k2_thin"),
    (58113, 528, "k2_rows"), (65535, 528, "k2_rows"), (1, 16, "k2n_smem")])
def test_routes_at_the_limits(S, Bpad, want):
    """The route of reads of 8,192 hash slots; the model's batch of
    2,048 slots a read takes no thin slab."""
    assert device_cost.route(S, Bpad, 8192) == want
    assert device_cost.route(S, Bpad) == want.replace("thin", "rows")
    assert device_cost.SMEM_OPTIN == SMEM


def synthetic_hashes(sizes, seed=0):
    rng = np.random.default_rng(seed)
    fh = {f"f{i}": np.unique(rng.integers(0, 2**64, n, dtype=np.uint64))
          for i, n in enumerate(sizes)}
    return fh, {f"a{i}": [f"f{i}"] for i in range(len(sizes))}


def layout_text(node, path):
    write_layout(node, str(path))
    with open(path) as fh:
        return fh.read()


def test_device_model_is_deterministic_and_picks_a_slab_flat(tmp_path):
    """600 user bins of 1,000 hashes: the flat table [1,368, 608] takes
    K2's slab route in one launch, which beats any tree's launches."""
    fh, cl = synthetic_hashes([1000] * 600)
    a, b = (binning.compute_layout_from_hashes(fh, cl, cost_model="device")
            for _ in range(2))
    assert layout_text(a, tmp_path / "a") == layout_text(b, tmp_path / "b")
    assert not a.children and a.num_technical_bins == 600
    slots = device_cost.ixf_geometry(1000)[1]
    assert device_cost.route(slots, device_cost.pad_bins(600)) == "k2_slab"


@pytest.fixture(scope="module")
def many_bins():
    """6,144 user bins, one of 100,000 hashes: the flat table [132,048,
    6,144] (811 MB) takes K2's rows route from HBM."""
    return synthetic_hashes([100_000] + [100] * 6143, seed=1)


def test_device_model_picks_a_tree_past_a_rows_flat(many_bins, capsys):
    fh, cl = many_bins
    node = binning.compute_layout_from_hashes(fh, cl, cost_model="device",
                                              verbose=True)
    flat_slots = device_cost.ixf_geometry(100_000)[1]
    assert device_cost.route(flat_slots, 6144) == "k2_rows"
    assert node.children, "the device model kept the flat layout"
    out = capsys.readouterr().out
    assert "## flat\texpected query cost = " in out
    assert "device ms a read" in out and "chosen t_max = 0" not in out
    flat = LayoutNode(num_technical_bins=6144)
    flat.records = [LayoutRecord([f], i, 1) for i, f in enumerate(fh)]
    flat.est_max_card = 100_000.0
    assert (binning._expected_query_cost_device(node)
            < binning._expected_query_cost_device(flat))


def test_device_sweep_scores_every_t_max(capsys):
    """The device model's cost is not monotone in t_max: 4,095 user bins
    of 100 hashes and one of 100,000 give a t = 64 tree of three levels
    that costs more than flat, and a t = 128 tree of two levels that
    costs less.  The sweep scores every candidate and keeps the
    cheapest, where the cpu model's sweep stops at the first worse one."""
    fh, cl = synthetic_hashes([100_000] + [100] * 4095, seed=1)
    node = binning.compute_layout_from_hashes(fh, cl, cost_model="device",
                                              verbose=True)
    out = capsys.readouterr().out
    cost = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"## (flat|t_max = \d+)\texpected query cost = ([0-9.]+)", out)}
    assert cost["t_max = 64"] > cost["flat"] > cost["t_max = 128"]
    assert "## chosen t_max = 128\t" in out
    assert node.children and node.num_technical_bins == 128
    assert round(binning._expected_query_cost_device(node), 6) \
        == cost["t_max = 128"]


def tree(n_children=64, leaves=64, card=2000.0):
    """A root of n_children merged bins, each a child of ``leaves`` user
    bins: a level of n_children * leaves bins below the root."""
    root = LayoutNode(num_technical_bins=n_children)
    root.est_max_card = card * leaves
    for c in range(n_children):
        kid = LayoutNode(num_technical_bins=leaves)
        kid.est_max_card = card
        kid.records = [LayoutRecord([f"g{c}_{j}"], j, 1)
                       for j in range(leaves)]
        root.children[c] = kid
    return root


@pytest.mark.parametrize("scaling", [2, 3, 8])
def test_scaled_scheme_charges_every_subgroup(scaling):
    """The count-table descent probes a read in one subgroup a level;
    the descend-all descent of a scaled scheme in every one, with
    HASHES_PER_READ / scaling hashes a read."""
    levels = device_cost.layout_levels(tree())
    plain = device_cost.batch_launches(levels)
    scaled = device_cost.batch_launches(levels, scaling)
    R, h = device_cost.BATCH, device_cost.HASHES_PER_READ
    G = plain[1]["shape"][0]
    assert plain[1]["shape"] == [8, 2688, 512] and G == 8
    assert plain[1]["pairs"] == pytest.approx(R)
    assert scaled[1]["pairs"] == G * R
    assert scaled[1]["hashes"] == pytest.approx(G * R * h / scaling)
    assert scaled[0]["pairs"] == plain[0]["pairs"] == R
    assert (binning._expected_query_cost_device(tree(), scaling)
            == pytest.approx(sum(x["ms"] for x in scaled) / R))


def test_hixf_levels_match_the_layout_levels():
    """The model on a built index and on its layout see the same groups
    (the layout's slots estimated, the index's built)."""
    from taxor_tpu_torch.hixf.build import build_hixf_from_layout
    from taxor_tpu_torch.hash.schemes import HashScheme

    root = tree(4, 6, 50.0)
    rng = np.random.default_rng(3)
    keys = {f"g{c}_{j}": np.unique(rng.integers(0, 2**64, 50,
                                                dtype=np.uint64))
            for c in range(4) for j in range(6)}
    hixf, _ = build_hixf_from_layout(
        root, HashScheme.make(kmer_size=16, syncmer_size=8, window_size=16,
                              use_syncmer=True),
        hash_fn=lambda fs: np.unique(np.concatenate([keys[f] for f in fs])))
    a = device_cost.batch_launches(device_cost.layout_levels(root))
    b = device_cost.batch_launches(device_cost.hixf_levels(hixf))
    assert [(x["route"], x["shape"][0], x["shape"][2], x["pairs"])
            for x in a] == [(x["route"], x["shape"][0], x["shape"][2],
                             x["pairs"]) for x in b]


def test_cpu_model_writes_the_jax_layout(tmp_path):
    fh, cl = synthetic_hashes([800 + 10 * i for i in range(150)], seed=4)
    a = binning.compute_layout_from_hashes(fh, cl, tmax=64)
    b = jax_binning.compute_layout_from_hashes(fh, cl, tmax=64)
    write_layout(a, str(tmp_path / "port"))
    jax_layout.write_layout(b, str(tmp_path / "jax"))
    with open(tmp_path / "port") as x, open(tmp_path / "jax") as y:
        assert x.read() == y.read()


def test_device_index_searches_as_the_jax_host_engine(tmp_path, monkeypatch):
    """The port's CLI builds with --layout-cost device and searches on the
    CPU twins; the JAX package's host engine searches the same file."""
    rng = np.random.default_rng(9)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=80,
                                      genome_len=2500)
    reads = make_reads(str(tmp_path), rng, genomes, n_reads_per_genome=1,
                       read_len=700, error_rate=0.02)
    monkeypatch.chdir(tmp_path)
    idx = os.path.join(str(tmp_path), "idx.taxor.npz")
    assert cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                     gdir, "--output-filename", idx, "--kmer-size", "22",
                     "--syncmer-size", "12", "--use-syncmer", "--tmax", "64",
                     "--layout-cost", "device"]) == 0
    port_tsv, jax_tsv = (os.path.join(str(tmp_path), f"{n}.tsv")
                         for n in ("port", "jax"))
    assert cli.main(["search", "--index-file", idx, "--query-file", reads,
                     "--output-file", port_tsv, "--engine", "device",
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["search", "--index-file", idx, "--query-file",
                         reads, "--output-file", jax_tsv, "--engine",
                         "host"]) == 0
    with open(port_tsv) as a, open(jax_tsv) as b:
        text = a.read()
        assert text == b.read()
    assert text.count("\n") > 80
