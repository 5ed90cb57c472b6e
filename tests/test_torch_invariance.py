"""The port of the JAX package's last tools without a kernel, on the CPU
twins: layout_invariance and seed_invariance (classification rows under
different layouts and filter seeds), debug_parity (the device-vs-host
repros) and bench_gather_scale (the cost model's fit)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from taxor_tpu.hixf.index import load_index as jax_load_index
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.hixf.index import save_index
from taxor_tpu_torch.tools import (bench_gather_scale, debug_parity,
                                   layout_invariance, seed_invariance)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.layout_invariance import classify_rows as jax_classify_rows  # noqa


@pytest.fixture(scope="module")
def small_problem(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("invariance"))
    return (tmp, *layout_invariance.make_problem(tmp, 40, 80))


@pytest.mark.parametrize("layout,tmax,cost", [("flat", 0, "cpu"),
                                              ("auto", 16, "cpu"),
                                              ("auto", 4096, "device")])
def test_classify_rows_equal_the_jax_tool(small_problem, layout, tmax, cost):
    """The port's rows (device engine on the CPU twins) are the JAX tool's
    (the host oracle) on the same index file."""
    tmp, tsv, gdir, reads = small_problem
    idx = os.path.join(tmp, f"{layout}{tmax}{cost}.taxor.npz")
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True, layout_mode=layout,
        tmax=tmax, layout_cost=cost,
        layout_file=os.path.join(tmp, f"{layout}{tmax}{cost}.out")))
    save_index(idx, index)
    got = layout_invariance.classify_rows(index, reads, device="cpu")
    want = jax_classify_rows(jax_load_index(idx), reads)
    assert got == want
    assert sum(bool(v) for v in got.values()) > 70


def test_layout_invariance_table_has_the_device_model(tmp_path):
    results = layout_invariance.run(30, 60, device="cpu", tmp=str(tmp_path))
    assert list(results) == [x[0] for x in layout_invariance.LAYOUTS]
    text = layout_invariance.table(results)
    rows = [line.split() for line in text.splitlines()[1:]
            if not line.startswith("  diff")]
    assert [r[0] for r in rows][-1] == "device_model"
    for name, n_ixfs, same, top in rows:
        assert top.endswith("/60") and int(top.split("/")[0]) >= 57


def test_seed_invariance_at_a_tiny_size(tmp_path, capsys):
    out = seed_invariance.run(30, 60, device="cpu", tmp=str(tmp_path))
    assert [x[0] for x in out][0].startswith("same layout")
    for _, same, top, n in out:
        assert n == 60 and 0 <= same <= top <= n and top >= 57
    assert "IXFs" in capsys.readouterr().out


def test_filter_seed_is_restored():
    from taxor_tpu_torch.hixf import build as hb
    from taxor_tpu_torch.ixf.xor_filter import build_ixf

    with seed_invariance.filter_seed(7):
        assert hb.build_ixf.keywords == {"seed": 7}
    assert hb.build_ixf is build_ixf


@pytest.fixture(scope="module")
def parity_problem(tmp_path_factory):
    return debug_parity.problem(root=str(tmp_path_factory.mktemp("parity")))


def test_debug_parity_diff_hashes_finds_no_mismatch(parity_problem):
    index, seqs = parity_problem
    out = debug_parity.diff_hashes(index, seqs, device="cpu")
    assert out["equal"] and not out["mismatch"] and len(out["reads"]) == 8
    assert set(out["engines"]) == {"K1", "split"}
    assert all(e["host"] == e["device"] > 0 for e in out["engines"].values())


@pytest.mark.parametrize("read", [0, 1, 5])
def test_debug_parity_localize_finds_no_difference(parity_problem, read):
    _, seqs = parity_problem
    out = debug_parity.localize(seqs[read], device="cpu")
    assert out["first"] is None and out["differing"] == 0
    assert out["host_emissions"] == out["device_emissions"] > 0


def test_localize_reports_the_window_of_a_difference(monkeypatch):
    """A device tracker that drops one emission: the first difference is
    that end position, with the s-mers of its k-mer's window."""
    from taxor_tpu_torch.device import extract

    real = extract.syncmer_track

    def drop_first(packed, lengths, k, s, t):
        kmer, emit = real(packed, lengths, k, s, t)
        emit = emit.clone()
        first = int(torch.nonzero(emit[0])[0, 0])
        emit[0, first] = False
        return kmer, emit

    monkeypatch.setattr(extract, "syncmer_track", drop_first)
    seq = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(2).integers(0, 4, 600)].tobytes()
    out = debug_parity.localize(seq, device="cpu")
    first = out["first"]
    assert out["differing"] == 1 and first["device"] is None
    k, s = debug_parity.K, debug_parity.S
    assert len(first["smers"]) == k - s + 1
    assert first["t_end"] in first["min_ends"]


def test_bench_gather_scale_holds_its_twins_on_the_cpu(capsys):
    assert bench_gather_scale.main(["--device", "cpu", "--shapes",
                                    "tiny"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = out["shapes"]["tiny"]
    assert out["device"] == "cpu" and out["equal"]
    assert set(rec["routes"]) == {"k2_rows", "k2n_rows", "call", "descent"}
    assert all(r["model_ms"] > 0 for r in rec["routes"].values())


def test_bench_gather_scale_knows_its_shapes():
    names = bench_gather_scale.shape_names("sweep")
    assert names[:len(bench_gather_scale.DEFAULT)] == list(
        bench_gather_scale.DEFAULT)
    assert len(names) > 40 and "jax_2^23x256" not in names
    assert "jax_2^23x256" in bench_gather_scale.shape_names("all")


def test_bench_gather_scale_fits_one_route():
    """--fit-only k2_thin: the thin slabs' coefficients recovered from
    device times their model gives, every other value as it was."""
    from taxor_tpu_torch.hixf import device_cost

    names = bench_gather_scale.shape_names("thin")
    assert names[0] == "thin_39621x1024" and len(names) == 7
    truth = {"c0": 9e-4, "c1": 3e-4, "read": 0.7}
    keep = dict(device_cost.COEF)
    out = {"shapes": {}}
    for name in names:
        sh = bench_gather_scale.SHAPES.get(name) or \
            bench_gather_scale._sweep()[name]
        Bp = -(-sh.bins // 16) * 16
        hashes = float(sh.R * sh.nvalid)
        device_cost.COEF = dict(keep, k2_thin=truth)
        try:
            dms = device_cost.device_ms("k2_thin", 1, sh.S, Bp, sh.R,
                                        sh.R, hashes, sh.R * Bp, 1.0)
        finally:
            device_cost.COEF = keep
        out["shapes"][name] = {
            "tables": [1, sh.S, Bp], "R": sh.R, "active_pairs": sh.R,
            "valid_hashes": hashes, "runs": False,
            "routes": {"k2_thin": {"device_ms": dms, "ms": dms}}}
    fit = bench_gather_scale.fit_coefficients(out, ("k2_thin",))
    assert device_cost.COEF == keep
    got = fit["COEF"]["k2_thin"]
    assert all(abs(got[k] - v) < 1e-3 * v for k, v in truth.items()), got
    assert {k: v for k, v in fit["COEF"].items() if k != "k2_thin"} == \
        {k: v for k, v in keep.items() if k != "k2_thin"}
    assert fit["L2_EFF"] == device_cost.L2_EFF
    assert all(abs(r - 1) < 1e-6 for r in fit["measured_over_model"].values())


@pytest.mark.parametrize("tool", ["bench_gather_scale", "layout_invariance",
                                  "debug_parity"])
def test_tools_refuse_a_missing_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if tool == "bench_gather_scale":
            bench_gather_scale.main(["--device", "cuda", "--shapes", "tiny"])
        elif tool == "layout_invariance":
            layout_invariance.classify_rows(None, "", device="cuda")
        else:
            debug_parity.localize(b"ACGT" * 20, device="cuda")
