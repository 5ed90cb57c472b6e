"""The port's bins sharding against the JAX package's: the bin-sharded
counts and ``sharded_search_step_fn`` over reads x bins meshes of gloo
ranks on the CPU equal the JAX ``sharded_count_fn`` /
``sharded_search_step_fn`` on ``make_mesh(2, 2)`` of the virtual CPU
devices and the port's single-device ``probe_counts``; the dry run of
``tools/dryrun_multichip`` over 4 ranks; the mesh layouts; the
collectives' backend rule; and runs clipped to a bins shard.  Every
comparison is exact.

One world of 4 ranks runs every case of the module
(tests/torch_world.py)."""

import os

import numpy as np
import pytest
import torch

from taxor_tpu.device.probe import count_xla
from taxor_tpu.device.probe import pad_fingerprints as jax_pad_fingerprints
from taxor_tpu.device.sharding import make_mesh as jax_make_mesh
from taxor_tpu.device.sharding import shard_ixf as jax_shard_ixf
from taxor_tpu.device.sharding import sharded_count_fn as jax_count_fn
from taxor_tpu.device.sharding import (
    sharded_search_step_fn as jax_search_step_fn)
from taxor_tpu.ixf.xor_filter import build_ixf, compute_probes
from taxor_tpu_torch.device import distributed, probe, sharding
from taxor_tpu_torch.device.distributed import Mesh, collective_backend

from .torch_world import agreed, results, run_world

MESHES = [(1, 2), (2, 1), (2, 2)]
MESH_IDS = [f"{a}x{b}" for a, b in MESHES]
RUN_LAYOUTS = ("one_bin", "wide")


def make_problem(layout: str):
    """The JAX suite's problem (256 bins of 50 keys, 8 reads of up to 64
    keys, 20 of each from read r's own bin) with its runs: one a bin, or
    runs of 1-7 bins that straddle the shard boundaries."""
    rng = np.random.default_rng(0)
    n_bins = 256
    bins = [rng.integers(0, 2**63, 50, dtype=np.uint64)
            for _ in range(n_bins)]
    ixf = build_ixf(bins, max_elements_per_bin=1000)
    fp = jax_pad_fingerprints(ixf.fingerprints)
    R, H = 8, 64
    keys = np.zeros((R, H), dtype=np.uint64)
    mask = np.zeros((R, H), dtype=bool)
    for r in range(R):
        k = np.unique(np.concatenate([
            bins[r][:20], rng.integers(0, 2**63, 40, dtype=np.uint64)]))[:H]
        keys[r, :k.shape[0]] = k
        mask[r, :k.shape[0]] = True
    if layout == "one_bin":
        offsets = np.arange(fp.shape[1] + 1)
    else:
        offsets = np.concatenate([[0], np.cumsum(rng.integers(1, 8, 200))])
        offsets = np.append(offsets[offsets < fp.shape[1]], fp.shape[1])
    return dict(
        table=fp, seed=np.uint64(ixf.seed), block_length=ixf.block_length,
        keys=keys, valid=mask,
        hi=(keys >> np.uint64(32)).astype(np.uint32).view(np.int32),
        lo=(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
        run_offsets=offsets.astype(np.int64),
        thresholds=np.full(R, 5, dtype=np.int32))


def jax_expect(p) -> dict:
    """The JAX sharded count and search steps on make_mesh(2, 2)."""
    keys, mask = p["keys"], p["valid"]
    R, H = keys.shape
    pos = np.zeros((R, H, 3), dtype=np.int32)
    fpr = np.zeros((R, H), dtype=np.uint8)
    for r in range(R):
        n = int(mask[r].sum())
        q, f, _ = compute_probes(keys[r, :n], int(p["seed"]),
                                 int(p["block_length"]))
        pos[r, :n], fpr[r, :n] = q, f
    fp = p["table"]
    mesh = jax_make_mesh(2, 2)
    counts = np.asarray(jax_count_fn(mesh)(jax_shard_ixf(mesh, fp), pos,
                                           fpr, mask))
    off = p["run_offsets"]
    onehot = np.zeros((fp.shape[1], off.shape[0] - 1), dtype=np.float32)
    for j in range(off.shape[0] - 1):
        onehot[off[j]:off[j + 1], j] = 1.0
    sums, emitted = jax_search_step_fn(mesh)(
        jax_shard_ixf(mesh, fp), pos, fpr, mask, onehot, p["thresholds"])
    np.testing.assert_array_equal(counts, np.asarray(
        count_xla(fp, pos, fpr, mask)))
    return {"counts": counts, "sums": np.asarray(sums),
            "emitted": np.asarray(emitted)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_sharding"))
    cases, problems = [], {}
    for layout in RUN_LAYOUTS:
        problems[layout] = make_problem(layout)
        path = os.path.join(tmp, f"problem_{layout}.npz")
        np.savez(path, **{k: v for k, v in problems[layout].items()
                          if k != "keys"})
        cases.append({"kind": "search_step", "name": f"step_{layout}",
                      "problem": path})
    cases += [{"kind": "dryrun", "name": "dryrun", "meshes": [[2, 2]]},
              {"kind": "layout", "name": "layout", "meshes": [[2, 2]]}]
    out = os.path.join(tmp, "out")
    run_world(4, cases, MESHES, out)
    return out, problems


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_bin_sharded_counts_equal_jax_and_single_device(world, mesh):
    out, problems = world
    p = problems["one_bin"]
    got = agreed(out, "step_one_bin", mesh)["counts"]
    single = probe.probe_counts(*(torch.from_numpy(p[x]) for x in (
        "hi", "lo", "valid", "table")), int(p["seed"]),
        int(p["block_length"])).numpy()
    np.testing.assert_array_equal(got[:, :single.shape[1]], single)
    np.testing.assert_array_equal(got[:, :single.shape[1]],
                                  jax_expect(p)["counts"])
    assert got.shape[0] == 8 and got.max() >= 20  # the reads' own bins


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("layout", RUN_LAYOUTS)
def test_sharded_search_step_equals_jax(world, layout, mesh):
    out, problems = world
    got = agreed(out, f"step_{layout}", mesh)
    want = jax_expect(problems[layout])
    np.testing.assert_array_equal(got["sums"], want["sums"])
    np.testing.assert_array_equal(got["emitted"], want["emitted"])
    assert got["emitted"].any()


def test_dryrun_multichip_over_four_ranks(world):
    out, _ = world
    res = agreed(out, "dryrun", (2, 2))
    assert bool(res["count_step"]) and bool(res["fused_step"])


def test_dryrun_multichip_tool_starts_its_ranks(capsys):
    """The tool's own entry: it starts 2 gloo ranks on this host (one
    reads row, 2 bins shards) and reports both steps equal."""
    import json

    from taxor_tpu_torch.tools import dryrun_multichip

    assert dryrun_multichip.main(["--ranks", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rcs"] == [0, 0] and out["count_step"] and out["fused_step"]
    assert out["mesh"] == ("mesh 1 reads x 2 bins, cell (r=0, b=0), "
                           "collectives on gloo")


@pytest.mark.parametrize("which", ["global", "make"])
def test_mesh_rank_order(world, which):
    """global_mesh lays the ranks out as the JAX global_mesh (rank
    b * nr + r; by default every rank a bins shard), make_mesh as the
    JAX make_mesh (rank r * nb + b)."""
    out, _ = world
    res = results(out, "layout", (2, 2))
    for rank, cell in enumerate(r[which] for r in res):
        r, b = cell
        assert rank == (b * 2 + r if which == "global" else r * 2 + b)
    if which == "global":
        assert [tuple(x["global_default"]) for x in res] == \
            [(1, 4, 0, b) for b in range(4)]


def test_one_process_mesh_is_one_by_one():
    """Without a world, make_mesh gives the 1 x 1 mesh, whose steps are
    the single-device ones, and refuses a larger grid."""
    with pytest.raises(ValueError, match="need 4 ranks, have 1"):
        distributed.make_mesh(2, 2, "cpu")
    mesh = distributed.make_mesh(1, 1, "cpu")
    assert (mesh.nr, mesh.nb, mesh.r, mesh.b, mesh.row_group) == \
        (1, 1, 0, 0, None)
    p = make_problem("wide")
    t = {k: torch.from_numpy(p[k]) for k in (
        "hi", "lo", "valid", "table", "run_offsets", "thresholds")}
    sums, emitted = sharding.sharded_search_step_fn(mesh)(
        sharding.shard_ixf(mesh, p["table"]), t["hi"], t["lo"], t["valid"],
        int(p["seed"]), int(p["block_length"]), t["run_offsets"],
        t["thresholds"])
    want = jax_expect(p)
    np.testing.assert_array_equal(sharding.host_view(sums, mesh),
                                  want["sums"])
    np.testing.assert_array_equal(sharding.host_view(emitted, mesh),
                                  want["emitted"])


@pytest.mark.parametrize("pairs,nccl,want", [
    ([("h", "cuda", 0), ("h", "cuda", 1)], True, "nccl"),
    ([("h", "cuda", 0)], True, "nccl"),
    ([("h", "cuda", 0), ("h", "cuda", 0)], True, "gloo"),
    ([("a", "cuda", 0), ("b", "cuda", 0)], True, "nccl"),
    ([("h", "cpu", None), ("h", "cpu", None)], True, "gloo"),
    ([("h", "cuda", 0), ("h", "cuda", 1)], False, "gloo"),
], ids=["two-cards", "one-rank", "shared-card", "two-hosts", "cpu",
        "no-nccl"])
def test_collective_backend_rule(pairs, nccl, want):
    assert collective_backend(pairs, nccl) == want


def shard_meshes(nb: int):
    return [Mesh(1, nb, 0, b, torch.device("cpu")) for b in range(nb)]


@pytest.mark.parametrize("nb", [2, 3, 4])
def test_clipped_runs_add_up_over_the_shards(nb):
    """A stack's runs clipped to each bins shard (empty in a shard they
    miss, split where they straddle a boundary, starting at a shard's
    column 0) sum, over the shards, to the runs of the whole table: the
    CPU twin of K2n's run sums and the segment sums of K2's counts."""
    rng = np.random.default_rng(nb)
    G, R, H, bins = 3, 6, 40, 100
    tables = rng.integers(0, 256, (G, 3 * 50, bins), dtype=np.uint8)
    tables[rng.random(tables.shape) < 0.5] = 0
    widths = [rng.integers(1, 30, 12) for _ in range(G)]
    run_s, run_e, run_off = [], [], [0]
    for w in widths:
        ends = np.minimum(np.cumsum(w), bins)
        starts = np.concatenate([[0], ends[:-1]])
        keep = ends > starts
        run_s.append(starts[keep])
        run_e.append(ends[keep])
        run_off.append(run_off[-1] + int(keep.sum()))
    run_s, run_e = np.concatenate(run_s), np.concatenate(run_e)
    hi, lo = (torch.from_numpy(rng.integers(-2**31, 2**31, (R, H)).astype(
        np.int32)) for _ in range(2))
    valid = torch.from_numpy(rng.random((R, H)) < 0.9)
    active = torch.from_numpy(rng.random((G, R)) < 0.7)
    off = torch.tensor(run_off)
    want = probe.probe_run_sums_grouped(
        hi, lo, valid, torch.from_numpy(tables), active, off,
        torch.from_numpy(run_s), torch.from_numpy(run_e), 77, 50)
    total = torch.zeros_like(want)
    empty = 0
    for mesh in shard_meshes(nb):
        shard = sharding.shard_ixf(mesh, tables)
        s, e = sharding.shard_runs(mesh, shard.shape[2], run_s, run_e)
        empty += int((e <= s).sum())
        total += probe.probe_run_sums_grouped(
            hi, lo, valid, shard, active, off, torch.from_numpy(s),
            torch.from_numpy(e), 77, 50)
        total_k2 = probe.segment_sums(
            probe.probe_counts_grouped(hi, lo, valid, shard, active, 77, 50),
            probe.run_groups(off), torch.from_numpy(s), torch.from_numpy(e))
        assert torch.equal(total_k2, probe.probe_run_sums_grouped(
            hi, lo, valid, shard, active, off, torch.from_numpy(s),
            torch.from_numpy(e), 77, 50))
    assert empty > 0 and int(want.max()) > 0
    assert torch.equal(total, want)


@pytest.mark.parametrize("col", ["first", "middle", "last"])
def test_run_clipped_to_nothing_sums_to_zero(col):
    """An empty run (run_s == run_e) sums to 0 in the CPU twin, at a
    shard's first column, inside it and past its last."""
    rng = np.random.default_rng(5)
    Bp = 32
    tables = torch.from_numpy(rng.integers(1, 4, (1, 150, Bp),
                                           dtype=np.uint8))
    c = {"first": 0, "middle": 7, "last": Bp}[col]
    run_s = torch.tensor([0, c, 3])
    run_e = torch.tensor([Bp, c, 9])
    hi, lo = (torch.from_numpy(rng.integers(-2**31, 2**31, (4, 16)).astype(
        np.int32)) for _ in range(2))
    valid = torch.ones((4, 16), dtype=torch.bool)
    sums = probe.probe_run_sums_grouped(hi, lo, valid, tables, None,
                                        torch.tensor([0, 3]), run_s, run_e,
                                        9, 50)
    counts = probe.probe_counts_grouped(hi, lo, valid, tables, None, 9, 50)
    assert int(sums[1].abs().sum()) == 0
    assert torch.equal(sums[0], counts[0].sum(1, dtype=torch.int32))
    assert torch.equal(sums[2], counts[0, :, 3:9].sum(1, dtype=torch.int32))
