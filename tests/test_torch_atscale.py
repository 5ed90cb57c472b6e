"""The port's at-scale demo (taxor_tpu_torch/tools/at_scale_demo.py)
against the JAX package's (tools/at_scale_demo.py) on the CPU, at the
smallest scale: one block of 1,024 genomes and 256 reads.

``gen`` of both demos (the JAX one in a subprocess) must write the same
genomes, taxonomy, reads (compared decompressed) and parity subset, byte
for byte.  Then the port's ``build``, ``search --device cpu`` (the plain
twins) and ``parity`` run on the taxonomy cut to its first 48 genomes:
the device TSV must equal the JAX package's host engine on the same
index file byte for byte, and the result JSON must hold what each stage
promises."""

import gzip
import json
import os
import subprocess
import sys

import pytest

from taxor_tpu.hixf.index import load_index as jax_load_index
from taxor_tpu.search.pipeline import SearchConfig as JaxSearchConfig
from taxor_tpu.search.pipeline import search_single as jax_search_single
from taxor_tpu_torch.tools import at_scale_demo as demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 256
CUT = 48  # genomes of the searched index


def _files(root: str, rel: str) -> dict:
    """{name: bytes} of a file or of every file of a directory under
    root; .gz files decompressed."""
    path = os.path.join(root, rel)
    paths = ({n: os.path.join(path, n) for n in sorted(os.listdir(path))}
             if os.path.isdir(path) else {rel: path})
    out = {}
    for name, p in paths.items():
        with (gzip.open if p.endswith(".gz") else open)(p, "rb") as fh:
            out[name] = fh.read()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gens, then the port's build, search and parity on the cut
    taxonomy (its own work directory, the gen's files linked in)."""
    base = tmp_path_factory.mktemp("atscale")
    port = demo.Demo(work=str(base / "port"), result=str(base / "port.json"),
                     seq_gb=0.001, n_reads=N_READS, device="cpu")
    os.makedirs(port.work)
    demo.gen(port)
    jax_dir = base / "jax"
    env = dict(os.environ, ATSCALE_DIR=str(jax_dir),
               ATSCALE_RESULT=str(base / "jax.json"), ATSCALE_SEQ_GB="0.001",
               ATSCALE_READS=str(N_READS), JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "tools/at_scale_demo.py", "gen"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

    cut = demo.Demo(work=str(base / "cut"), result=str(base / "cut.json"),
                    n_reads=N_READS, device="cpu")
    os.makedirs(cut.work)
    for name in ("genomes", "reads.fq.gz", "parity_reads.fna"):
        os.symlink(port.path(name), cut.path(name))
    with open(port.path("taxonomy.tsv")) as fh:
        rows = fh.read().splitlines()[:CUT]
    with open(cut.path("taxonomy.tsv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    for stage in (demo.build, demo.search, demo.parity):
        stage(cut)
    with open(cut.result) as fh:
        result = json.load(fh)
    return dict(port=port, jax_dir=str(jax_dir), jax_json=base / "jax.json",
                cut=cut, result=result)


@pytest.mark.parametrize("rel", ["genomes", "taxonomy.tsv", "reads.fq.gz",
                                 "parity_reads.fna"])
def test_gen_writes_the_jax_demos_files(runs, rel):
    got = _files(runs["port"].work, rel)
    want = _files(runs["jax_dir"], rel)
    assert got.keys() == want.keys()
    assert got == want
    if rel == "genomes":
        assert len(got) == 1024


def test_gen_records_what_the_jax_demo_records(runs):
    with open(runs["port"].result) as fh:
        got = json.load(fh)["gen"]
    with open(runs["jax_json"]) as fh:
        want = json.load(fh)["gen"]
    got.pop("wall_s"), want.pop("wall_s")
    assert got == want and got["n_species"] == 1024


def test_device_tsv_equals_the_jax_host_engine(runs):
    """The port's device TSV of the parity reads (the plain twins) equals
    the JAX package's --engine host on the port's index file."""
    cut = runs["cut"]
    out = cut.path("jax_host.tsv")
    with open(out, "w") as fh:
        jax_search_single(jax_load_index(cut.path("index.npz")),
                          cut.path("parity_reads.fna"), fh,
                          JaxSearchConfig(engine="host"), None)
    with open(out, "rb") as fh, \
            open(cut.path("device_parity.tsv"), "rb") as dh:
        want, got = fh.read(), dh.read()
    assert got == want
    assert want.count(b"\tGCF_") >= 5  # some reads name a genome
    assert got.count(b"\n") >= N_READS


def test_result_holds_every_stage_record(runs):
    res = runs["result"]
    assert {"build", "search", "parity"} <= res.keys()
    build = res["build"]
    assert build["n_user_bins"] == CUT and build["threads"] >= 1
    assert build["n_ixfs"] > 1 and build["depth"] >= 2
    for key in ("phases", "fingerprint_gb", "largest_ixf_mb", "max_slots",
                "index_npz_gb", "suggested_topk", "peak_rss_gb",
                "spill_peak_gb", "root_bins"):
        assert key in build, key
    assert build["host"]["cpu_count"] == build["threads"]
    s = res["search"]
    assert s["device"] == "cpu" and s["card"] is None
    assert s["n_reads"] == N_READS and len(s["warm_walls_s"]) == 2
    assert s["routes"] == {"plain twin": len(s["groups"])}
    assert s["device_table_bytes"] >= s["fingerprint_bytes"] > 0
    assert s["step_activity"]["group_launches"] == len(s["groups"])
    # the plain twins count no launch
    assert set(s["search_launches"].values()) == {0}
    for key in ("index_load_s", "device_prep_s", "cold_wall_s",
                "full_pipeline_reads_per_s", "device_burst_reads_per_s",
                "peak_rss_gb", "launches_per_step", "classified_fraction",
                "correct_of_classified", "baseline_1thread_reads_per_s"):
        assert key in s, key
    assert res["parity"] == dict(res["parity"], n_reads=N_READS,
                                 byte_identical=True)


def test_parity_fails_where_the_tsvs_differ(runs, tmp_path):
    """The parity stage exits non-zero on one changed byte."""
    cut = runs["cut"]
    bad = demo.Demo(work=str(tmp_path), result=str(tmp_path / "r.json"))
    for name in ("index.npz", "parity_reads.fna"):
        os.symlink(cut.path(name), bad.path(name))
    with open(cut.path("device_parity.tsv"), "rb") as fh:
        text = bytearray(fh.read())
    text[-2] = ord("0") if text[-2] != ord("0") else ord("1")
    with open(bad.path("device_parity.tsv"), "wb") as fh:
        fh.write(bytes(text))
    with pytest.raises(SystemExit):
        demo.parity(bad)
    with open(bad.result) as fh:
        assert json.load(fh)["parity"]["byte_identical"] is False


@pytest.mark.parametrize("name", ["ATSCALE_r04.json", "ATSCALE_r05.json"])
def test_demo_never_writes_the_jax_record(tmp_path, name):
    with pytest.raises(ValueError):
        demo.Demo(work=str(tmp_path), result=str(tmp_path / name))


def test_search_refuses_a_missing_card(tmp_path):
    """--device cuda without a card fails instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        demo.search(demo.Demo(work=str(tmp_path),
                              result=str(tmp_path / "r.json")))


def test_step_activity_reads_the_searched_step(runs):
    """The burst step's activity comes from the cached step the search
    ran: one record a group launch, the root's active pairs all the
    reads of the batch."""
    a = runs["result"]["search"]["step_activity"]
    assert a["group_launches"] == len(a["active_pairs"]) >= 2
    assert a["active_pairs"][0] == a["reads"] == demo.BURST_READS
    assert 0 <= a["empty_subgroups"] <= a["subgroups"]


def test_per_launch_keeps_each_launch_only_while_open():
    import torch

    from taxor_tpu_torch.device.e2e import ActivityStats

    stats = ActivityStats()
    act = torch.tensor([[True, False, True], [False, False, False]])
    stats.add(act)
    with stats.per_launch() as kept:
        stats.add(act)
        stats.add(torch.ones((1, 3), dtype=torch.bool))
    stats.add(act)
    assert [k.tolist() for k in kept] == [[2, 0], [3]]
    assert stats.total == 3 * 6 + 3 and int(stats.active) == 3 * 2 + 3


def test_launch_counts_read_since_reset():
    """device/launches.py reads every wrapper's counter and sets them
    back to 0; ``since`` gives the differences of the numeric ones."""
    from taxor_tpu_torch.device import extract, launches, probe

    saved = launches.read()
    try:
        before = launches.read()
        extract.syncmer_hashes.LAUNCHES += 3
        probe.k2n_counts.MODES["rows"] = (
            probe.k2n_counts.MODES.get("rows", 0) + 2)
        diff = launches.since(before)
        assert diff["K1"] == 3 and diff["K2n rows"] == 2
        assert "K2n routes" not in diff
        assert set(diff) - {"K1", "K2n rows"} and all(
            v == 0 for k, v in diff.items() if k not in ("K1", "K2n rows"))
        launches.reset()
        assert all(v in (0, {}) for v in launches.read().values())
    finally:
        extract.syncmer_hashes.LAUNCHES = saved["K1"]
        probe.k2n_counts.MODES = {m: saved[f"K2n {m}"]
                                  for m in ("smem", "rows")}
