"""The port's tooling against the JAX package's, on the CPU twins at small
sizes: the synthetic problems byte for byte, the native baseline, the
four diagnostic kernels' twins against the JAX functions or a numpy
transcription of the TPU tools' kernels, the tools themselves end to end,
the parity gate, ``cli prewarm`` and ``search --profile-trace``.  All of
it is integer or text, so every comparison is exact."""

import filecmp
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import taxor_tpu.native as jax_native
from taxor_tpu.apps import build as jax_build
from taxor_tpu.device.probe import count_xla
from taxor_tpu.hash import device_syncmer as jdsync
from taxor_tpu.io.fastx import read_all as jax_read_all
from taxor_tpu.native.baseline import baseline_search as jax_baseline
from taxor_tpu.search.thresholds import Thresholder as JaxThresholder
from taxor_tpu_torch import cli
from taxor_tpu_torch.apps import build
from taxor_tpu_torch.device import diag, extract, probe
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash.schemes import search_hashes
from taxor_tpu_torch.io.fastx import read_all
from taxor_tpu_torch.native.baseline import baseline_search
from taxor_tpu_torch.search.thresholds import Thresholder
from taxor_tpu_torch.tools import (bench, bench_dsmem, bench_probe,
                                   debug_extract,
                                   debug_min,
                                   probe_bounds, probe_experiments,
                                   profile_phases, synth, time_extract,
                                   time_minimizer, time_sort, time_stages,
                                   timing)

from .test_torch_extract import reads as extract_reads
from .util import make_reads, make_ref_set

M32 = 0xFFFFFFFF


def _tree(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ------------------------------------------------------- synthetic data --
@pytest.mark.parametrize("mutate", [0.0, 0.01])
def test_build_problem_writes_the_jax_files(tmp_path, mutate):
    kw = dict(n_species=8, genome_len=3000, n_reads=32, read_len=500,
              seed=3, mutate_from_first=mutate)
    jtmp, jtsv, jgdir, jreads = jax_bench.build_problem(**kw)
    try:
        _, ptsv, pgdir, preads = synth.build_problem(**kw,
                                                     root=str(tmp_path))
        assert filecmp.cmp(jtsv, ptsv, shallow=False)
        assert filecmp.cmp(jreads, preads, shallow=False)
        assert _tree(jgdir) == _tree(pgdir) and len(_tree(pgdir)) == 8
    finally:
        shutil.rmtree(jtmp)


def test_mixed_length_reads_write_the_jax_files(tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    j = jax_bench._mixed_length_reads(str(jdir))
    p = synth.mixed_length_reads(str(pdir))
    assert _tree(str(jdir)) == _tree(str(pdir))
    assert [os.path.relpath(x, str(pdir)) for x in p] == \
        [os.path.relpath(x, str(jdir)) for x in j]


# ------------------------------------------------------ native baseline --
@pytest.fixture(scope="module", params=["flat", "auto"])
def baseline_problem(request, tmp_path_factory):
    """The same small index built by both packages (flat: 12 species;
    auto: 70 species over 64 technical bins, hierarchical) and reads."""
    tmp = str(tmp_path_factory.mktemp("baseline"))
    rng = np.random.default_rng(11)
    n = 12 if request.param == "flat" else 70
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=n,
                                      genome_len=4000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=2,
                       read_len=900, error_rate=0.03)
    idx = {}
    for name, mod in (("jax", jax_build), ("port", build)):
        idx[name] = mod.run_build(mod.BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=22, syncmer_size=12, use_syncmer=True,
            layout_mode=request.param, tmax=64, layout_file="", threads=2))
    assert (len(idx["port"].hixf.ixfs) > 1) == (request.param == "auto")
    return idx, reads


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's native library, which jax_baseline needs.  That
    package builds it under one temp name that every process shares, so
    on a cold cache a test worker that loses the rename race keeps
    get_lib() None for its life; such a worker builds it once more, into
    a cache of its own.  A library that still does not build fails the
    test."""
    if jax_native.get_lib() is not None:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAXOR_TPU_NATIVE_CACHE",
                  str(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jax_native, "_TRIED", False)
        mp.setattr(jax_native, "_LIB", None)
        assert jax_native.get_lib() is not None, \
            "the JAX package's native library does not build"
        yield


def _host_engine(index, seqs, thresholder):
    """(best user, best count, reads within 0.8 of it) per read from the
    port's host engine: host hashes and the HIXF membership traversal."""
    out = []
    for h in search_hashes(seqs, index.scheme):
        thr = thresholder.get(h.shape[0], 0.0)
        pairs = (index.hixf.membership(h, thr)
                 if h.shape[0] and thr < (1 << 63) else [])
        mx = max((c for _, c in pairs), default=0)
        out.append((next((u for u, c in pairs if c == mx), -1), mx,
                    sum(c >= 0.8 * mx for _, c in pairs) if pairs else 0))
    return [np.array(x, dtype=np.int32) for x in zip(*out)]


@pytest.mark.parametrize("threads", [1, 3])
def test_baseline_equals_jax_baseline_and_host_engine(baseline_problem,
                                                       threads, request):
    idx, reads = baseline_problem
    seqs = [r.seq for r in read_all(reads)]
    assert seqs == [r.seq for r in jax_read_all(reads)]
    sch = idx["port"].scheme
    th = Thresholder.make(sch.kmer_size, sch.window_size, 0.04, -1.0, True)
    jth = JaxThresholder.make(sch.kmer_size, sch.window_size, 0.04, -1.0,
                              True)
    got = baseline_search(idx["port"].hixf, seqs, sch, th, threads=threads)
    for a, c in zip(got, _host_engine(idx["port"], seqs, th)):
        np.testing.assert_array_equal(a, c)
    if threads == 1:
        # the JAX copy reads its counts scratch after a child level may
        # have moved it (fixed in the port's copy): one thread happens to
        # read the old values there, more threads do not
        request.getfixturevalue("jax_native_lib")
        want = jax_baseline(idx["jax"].hixf, seqs, idx["jax"].scheme, jth,
                            threads=1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert (got[0] >= 0).mean() > 0.9


# ------------------------------------------------------- probe bounds --
def _jax_tool_counts(fp_words, posp, bodies, mode, U, RT):
    """Numpy transcription of bench_probe_bounds.make_kernel: int32
    [R, 4, B4] (word w of row j holds bin 4w + j)."""
    R = posp.shape[0]
    B4 = fp_words.shape[1]
    fp = fp_words.view(np.uint32).astype(np.int64)
    out = np.zeros((R, 4, B4), dtype=np.int64)
    for r in range(R):
        rt = r % RT  # the read's index inside the kernel's read tile
        for h in range(bodies[r] * U):
            u = h % U
            if mode == "nosmem":
                p0, p1, p2, f4 = 1 + u, 2 + u, 3 + u, 0x01010101
            elif mode == "lcg":
                z = (h * 40503 + rt * 2057) & 0x7FF
                p0, p1, p2, f4 = z, (z + 7) & 0x7FF, (z + 13) & 0x7FF, \
                    0x01010101
            elif mode == "smem1":
                w0 = int(posp[r, 2 * h]) & M32
                p0, p1, p2, f4 = w0 & 0xFFFF, w0 & 0xFFFF, w0 >> 16, \
                    0x01010101
            else:
                w0, w1 = (int(posp[r, 2 * h + i]) & M32 for i in (0, 1))
                p0, p1, p2 = w0 & 0xFFFF, w0 >> 16, w1 & 0xFFFF
                f4 = ((w1 >> 16) * 0x01010101) & M32
            x = fp[p0] ^ f4 if mode == "load1" else \
                fp[p0] ^ fp[p1] ^ fp[p2] ^ f4
            for j in range(4):
                out[r, j] += ((x >> (8 * j)) & 0xFF) == 0
    return out


def _unpack_words(out4):
    """[R, 4, B4] (4 bins a word) -> [R, B] bin-major."""
    R, _, B4 = out4.shape
    return out4.transpose(0, 2, 1).reshape(R, 4 * B4)


@pytest.fixture(scope="module")
def bounds_inputs():
    rng = np.random.default_rng(21)
    table = probe_bounds.tool_table(rng, B=64)  # [2419, 64]
    words = probe_bounds.make_inputs(rng, 20, 40, table.shape[0])
    bodies = rng.integers(0, 6, 20)  # U = 8 hashes a body, 0..40 a read
    return table, words, bodies


@pytest.mark.parametrize("mode", diag.PROBE_BOUNDS_MODES)
def test_probe_bounds_twin_equals_the_jax_tool(bounds_inputs, mode):
    table, words, bodies = bounds_inputs
    U, RT = 8, 8  # two read tiles of 8 reads (+4): r mod RT in lcg
    got = diag.probe_bounds(torch.from_numpy(table), torch.from_numpy(words),
                            torch.from_numpy((bodies * U).astype(np.int32)),
                            mode, U, RT).numpy()
    fp_words = table.view(np.int32)
    want = _jax_tool_counts(fp_words, words, bodies, mode, U, RT)
    np.testing.assert_array_equal(got, _unpack_words(want))
    if mode == "p16":
        w = words.view(np.uint32).astype(np.int64).reshape(20, 40, 2)
        pos = np.stack([w[..., 0] & 0xFFFF, w[..., 0] >> 16,
                        w[..., 1] & 0xFFFF], axis=-1).astype(np.int32)
        fpr = (w[..., 1] >> 16).astype(np.uint8)
        mask = np.arange(40)[None, :] < (bodies * U)[:, None]
        xla = np.asarray(count_xla(jnp.asarray(table), jnp.asarray(pos),
                                   jnp.asarray(fpr), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, xla)
        assert got.max() > 0


# -------------------------------------------------- probe experiments --
@pytest.fixture(scope="module")
def experiment_inputs():
    rng = np.random.default_rng(22)
    table = probe_bounds.tool_table(rng, B=32)
    w16, w10 = probe_experiments.make_inputs(rng, 9, 512, 2419, 806)
    n_hash = rng.integers(0, 250, 9).astype(np.int32)
    return [torch.from_numpy(x) for x in (table, w16, w10, n_hash)]


@pytest.mark.parametrize("nr", [1, 2, 4])
def test_probe_experiment_p10_equals_p16_equals_probe_bounds(
        experiment_inputs, nr):
    table, w16, w10, n_hash = experiment_inputs
    c16, e16 = diag.probe_experiment(table, w16, n_hash, "p16", nr=nr)
    c10, e10 = diag.probe_experiment(table, w10, n_hash, "p10", nr=nr,
                                     block_length=806)
    assert torch.equal(c16, c10) and int(c16.sum()) > 0
    assert torch.equal(c16, diag.probe_bounds(table, w16, n_hash, "p16"))
    assert not e16.any() and not e10.any()


def _chains_extra(table, words, n_hash, rounds):
    """Numpy transcription of the ALU chains: per read and table word,
    rounds x (d1 = (d1 ^ x) + C1, d2 = (d2 + x) ^ C2) per hash in order;
    extra = sum over the words of (d1 ^ d2) >> 31."""
    fp = table.numpy().view(np.uint32).astype(np.int64)
    w = words.numpy().view(np.uint32).astype(np.int64)
    out = []
    for r in range(w.shape[0]):
        d1 = np.zeros(fp.shape[1], dtype=np.int64)
        d2 = np.zeros_like(d1)
        for h in range(int(n_hash[r])):
            w0, w1 = w[r, 2 * h], w[r, 2 * h + 1]
            x = (fp[w0 & 0xFFFF] ^ fp[w0 >> 16] ^ fp[w1 & 0xFFFF]
                 ^ (((w1 >> 16) * 0x01010101) & M32))
            for _ in range(rounds):
                d1 = ((d1 ^ x) + diag.C1) & M32
                d2 = ((d2 + x) & M32) ^ diag.C2
        out.append(int(((d1 ^ d2) >> 31).sum()))
    return np.array(out, dtype=np.int32)


def test_probe_experiment_alu_rounds_and_smemflood(experiment_inputs):
    table, w16, _, n_hash = experiment_inputs
    counts, extra = diag.probe_experiment(table, w16, n_hash, "p16",
                                          rounds=3)
    assert torch.equal(counts, diag.probe_bounds(table, w16, n_hash, "p16"))
    np.testing.assert_array_equal(extra.numpy(),
                                  _chains_extra(table, w16, n_hash, 3))
    for K in (2, 4, 8):
        counts, extra = diag.probe_experiment(table, w16, n_hash,
                                              flood_k=K)
        w = w16.numpy().view(np.uint32).astype(np.int64)
        want = [sum(int(w[r, (K * h + u) & 1023]) for h in range(int(n))
                    for u in range(K)) & M32 for r, n in enumerate(n_hash)]
        assert not counts.any()
        np.testing.assert_array_equal(
            extra.numpy(), np.array(want, dtype=np.uint32).view(np.int32))


def test_experiment_lists_transcribe_the_jax_runs():
    spec = probe_experiments.experiment
    assert spec("p10x2", 8, "p10", 0, 173) == dict(
        layout="p10", nr=2, rounds=0, flood_k=0, n=176)
    assert spec("vpux4", 8, "p16", 4, 173)["rounds"] == 8
    assert spec("smemflood", 4, "p16", 0, 173) == dict(
        layout="p16", nr=1, rounds=0, flood_k=4, n=173)
    assert [len(v) for v in probe_experiments.LISTS.values()] == [10, 3, 6]


# ----------------------------------------------------- extractor stages --
@pytest.fixture(scope="module", params=[256, 1024])
def stage_reads(request):
    L = request.param
    seqs = extract_reads(L, L, n=6)  # random, homopolymer, N, short
    packed, lengths = dsync.pack_reads(seqs, L)
    return L, packed, lengths


def _stages(packed, lengths, k=22, s=12, t=5):
    return diag.extract_stages_plain(torch.from_numpy(packed),
                                     torch.from_numpy(lengths), k, s, t)


def test_stage_words_equal_the_jax_rolling_words(stage_reads):
    L, packed, lengths = stage_reads
    st = _stages(packed, lengths)
    for m, (f, r) in ((12, ("sf", "sr")), (22, ("kf", "kr"))):
        fhi, flo, rhi, rlo = (np.asarray(x).astype(np.uint64) for x in
                              jdsync._rolling_packed_words(
                                  jnp.asarray(packed), m))
        for name, hi, lo in ((f, fhi, flo), (r, rhi, rlo)):
            want = ((hi << np.uint64(32)) | lo).view(np.int64)
            np.testing.assert_array_equal(st[name].numpy()[:, m - 1:],
                                          want[:, m - 1:])


def test_stage_kmers_and_emit_equal_the_jax_scan(stage_reads):
    L, packed, lengths = stage_reads
    st = _stages(packed, lengths)
    khi, klo, emit = (np.asarray(x) for x in jdsync.syncmer_kmers(
        jnp.asarray(packed), jnp.asarray(lengths), 22, 12, 5))
    np.testing.assert_array_equal(st["chi"].numpy()[:, 21:], khi[:, 21:])
    np.testing.assert_array_equal(st["clo"].numpy()[:, 21:], klo[:, 21:])
    np.testing.assert_array_equal(st["emit"].numpy(), emit)
    assert emit.sum() > 0
    # pre: the emitted k-mers in emission order, all ones after them
    kmer = ((khi.astype(np.uint64) << np.uint64(32))
            | klo.astype(np.uint64)).view(np.int64)
    km, em = extract.syncmer_track(torch.from_numpy(packed),
                                   torch.from_numpy(lengths), 22, 12, 5)
    pre = st["pre"].numpy()
    for r in range(L and packed.shape[0]):
        n = int(emit[r].sum())
        np.testing.assert_array_equal(pre[r, :n], kmer[r][emit[r]])
        np.testing.assert_array_equal(pre[r, :n], km[r][em[r]].numpy())
        assert (pre[r, n:] == -1).all()


def test_stage_ys_and_erm_equal_their_definitions(stage_reads):
    L, packed, lengths = stage_reads
    k, s = 22, 12
    st = _stages(packed, lengths)
    codes = dsync.unpack_codes(torch.from_numpy(packed)).numpy()
    R = codes.shape[0]
    ys = np.full((R, L), M32, dtype=np.int64)
    for i in range(s - 1, L):
        win = codes[:, i - s + 1:i + 1]  # oldest base first
        f = sum(win[:, j] << (2 * (s - 1 - j)) for j in range(s))
        rc = sum((3 - win[:, j]) << (2 * j) for j in range(s))
        ys[:, i] = np.minimum(f, rc)
    np.testing.assert_array_equal(st["ys"].numpy(), ys)
    w = k - s + 1
    erm = np.empty((R, L), dtype=np.int64)
    for i in range(L):
        a = max(0, i - w + 1)
        win = ys[:, a:i + 1]
        # the rightmost position of the window's minimum
        erm[:, i] = i - np.argmin(win[:, ::-1], axis=1)
    np.testing.assert_array_equal(st["erm"].numpy(), erm)


def test_extract_stage_refuses_what_the_kernel_lacks():
    pk = torch.zeros((1, 64), dtype=torch.uint8)
    ln = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        diag.extract_stage(pk, ln, 22, 12, 5, "rolls")
    with pytest.raises(ValueError):
        diag.extract_stage(pk.to("meta"), ln.to("meta"), 22, 12, 5, "ys")


# -------------------------------------------------------- window shift --
def test_window_shift_twin_equals_the_jax_kernel():
    rng = np.random.default_rng(23)
    x = rng.integers(-2**31, 2**31, (8, 64)).astype(np.int32)
    got = diag.window_shift(torch.from_numpy(x)).numpy().view(np.uint32)
    xu = x.view(np.uint32)
    acc = []
    for c in range(16):  # debug_min.kern with pltpu.roll as np.roll
        off = 2 * c - 24 + 2
        jb = off >> 5
        sh = off - 32 * jb
        w1 = np.roll(xu, -(jb + 1), axis=1) if jb + 1 else xu
        acc.append((w1 << np.uint32(32 - sh)) & np.uint32(0xFFFFFF)
                   if sh else w1)
    np.testing.assert_array_equal(got, np.concatenate(acc, axis=1))
    sub = diag.window_shift(torch.from_numpy(x), [3, 0]).numpy()
    np.testing.assert_array_equal(sub.view(np.uint32),
                                  np.concatenate([acc[3], acc[0]], axis=1))


# --------------------------------------------------- the tools, on CPU --
def test_rolled_ms_feeds_rolled_copies():
    seen = []
    x = torch.arange(12).reshape(4, 3)
    ms = timing.rolled_ms(lambda h, c: seen.append((h[0, 0].item(), c)),
                          x, 7, M=4)
    assert ms >= 0 and len(seen) == 1 + 4 * 3
    assert [h for h, _ in seen[1:5]] == [0, 9, 6, 3] and seen[0] == (0, 7)


def test_probe_tools_run_on_the_twins(capsys):
    rows = probe_bounds.run("cpu", R=8, H=256, nvalid=60)
    assert set(rows) == {"K2", *diag.PROBE_BOUNDS_MODES}
    assert all(r["ms"] > 0 for r in rows.values())
    exps = probe_experiments.run("r2", "cpu", R=8, H=256, nvalid=60)
    assert [e["mode"] for e in exps] == ["p10", "p10x2", "p10"]
    assert "p10 == p16 counts" in capsys.readouterr().err


def test_debug_tools_run_on_the_twins(capsys):
    assert debug_extract.main(["--stage", "all", "--device", "cpu"]) == 0
    assert debug_extract.main(["--stage", "kflo", "--device", "cpu"]) == 0
    assert debug_extract.main(["--stage", "w0", "--device", "cpu"]) == 2
    assert debug_min.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("kernel == twin: True") == 11
    assert "total diffs: 0" in out


def test_time_extract_runs_on_the_twins(capsys):
    assert time_extract.main(["--L", "256", "--reads", "3", "--device",
                              "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["L"] == 256
    for k, s in time_extract.SCHEMES:
        for batch in ("random", "all_tied"):
            rec = out[f"{k}/{s}"][batch]
            assert rec["equal"] and rec["reads"] == 3
            assert rec["emissions"] > 0
            assert rec["syncmer_extract_ms"] > 0
            assert rec["syncmer_track_device_ms"] > 0


def test_time_sort_runs_on_the_twins(capsys):
    assert time_sort.main(["--L", "256", "--reads", "3", "--device",
                           "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and (out["L"], out["reads"]) == (256, 3)
    assert out["equal"] == {"dedup": True, "dedup_no_emit": True,
                            "sort_pairs": True}
    assert out["emissions"]["min"] > 0 and out["dedup_width"] == 64
    for name in ("dedup", "dedup_no_emit", "sort_pairs", "torch_sort"):
        assert out[f"{name}_ms"] > 0 and out[f"{name}_device_ms"] > 0


def test_time_minimizer_runs_on_the_twins(capsys):
    assert time_minimizer.main(["--L", "256", "--reads", "3", "--device",
                                "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and (out["L"], out["reads"]) == (256, 3)
    assert out["equal"] == {"w7": True, "w1": True, "w7_scaled": True}
    assert 0 < out["emissions"]["w7_scaled"] < out["emissions"]["w7"]
    for name in ("w7", "w1", "w7_scaled"):
        assert out[f"{name}_ms"] > 0 and out[f"{name}_device_ms"] > 0


def test_time_stages_runs_on_the_twins(capsys):
    assert time_stages.main(["--L", "256", "--reads", "3", "--device",
                             "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and (out["L"], out["reads"]) == (256, 3)
    assert all(out["equal"].values()) and len(out["equal"]) == 8
    assert min(out["emissions"].values()) > 0
    for name in (*time_stages.STAGES, "pre_tied", "pre_one",
                 "window_shift"):
        assert out[f"{name}_ms"] > 0 and f"{name}_device_ms" not in out


def test_profile_phases_on_the_twins():
    ms = profile_phases.profile("cpu", dict(
        n_species=4, genome_len=2000, n_reads=8, read_len=300))
    for p in ("A", "B", "F", "C", "C2", "D"):
        assert ms[p] > 0
    assert ms["unaccounted"] == ms["D"] - ms["F"] - ms["C"] - ms["C2"]
    assert ms["reads"] == 8 and ms["L"] == 512
    assert ms["C_kernel"] == "plain twin"  # no kernel launches on the CPU


def test_profile_phases_names_the_probe_kernel(monkeypatch):
    monkeypatch.setattr(probe.k2n_counts, "LAUNCHES", 3)
    monkeypatch.setattr(probe.k2_counts, "LAUNCHES", 5)
    monkeypatch.setattr(probe.k2_counts, "VARIANTS", {"rows": 1})

    def k2_slab():
        probe.k2_counts.LAUNCHES += 1
        probe.k2_counts.VARIANTS["slab"] = 1

    def k2n():
        probe.k2n_counts.LAUNCHES += 1

    assert profile_phases.probe_kernel(k2_slab) == "K2 (slab)"
    assert profile_phases.probe_kernel(k2n) == "K2n"
    assert profile_phases.probe_kernel(lambda: None) == "plain twin"


@pytest.mark.parametrize("layout", ["flat", "auto"])
def test_bench_config_on_the_twins(tmp_path, layout):
    n = 4 if layout == "flat" else 70
    row = bench.bench_config(
        f"tiny_{layout}", torch.device("cpu"), str(tmp_path), n_species=n,
        genome_len=2500, n_reads=n, read_len=400, layout_mode=layout,
        tmax=64, measure_pipeline=layout == "flat")
    assert (row["n_ixfs"] > 1) == (layout == "auto")
    assert row["device_compute_reads_per_s"] > 0
    assert row["classified_fraction"] > 0.9
    assert row["host_fallback_fraction"] < 0.1
    assert row["baseline_1thread_reads_per_s"] > 0
    if layout == "flat":
        assert row["full_pipeline_reads_per_s"] > 0


def test_parity_gate_on_the_twins(tmp_path):
    assert bench.parity_gate("cpu", n_reads=64, n_mixed=48,
                             root=str(tmp_path)) == {
        f: True for f in bench.FAMILIES}


@pytest.mark.parametrize("family", bench.ROUTED_FAMILIES)
def test_parity_gate_fails_a_family_off_the_fused_step(family, tmp_path,
                                                       monkeypatch):
    """The gate's route check alone: each routed family under the rule
    that kept it off the fused step (s <= 15 for the device extractor;
    the JAX package's L/4 hash capacity) still gives the host's TSV, and
    the gate fails it on its routes."""
    from taxor_tpu_torch.device import hixf_search

    if family == "wide_smer_syncmer":
        monkeypatch.setattr(hixf_search, "supports", lambda sch: (
            dsync.supports(sch) and sch.syncmer_size <= 15))
    else:
        monkeypatch.setattr(hixf_search, "hash_cap",
                            lambda L, k, s, t: jdsync.hash_cap(L))
    monkeypatch.setattr(bench, "PARITY_FAMILIES",
                        {family: bench.PARITY_FAMILIES[family]})
    routes = {}
    assert bench.parity_gate("cpu", n_reads=64, n_mixed=48,
                             root=str(tmp_path), routes=routes) == {
        family: False}
    r = routes[family]
    assert (r["host_hashes"] if family == "wide_smer_syncmer"
            else r["hcap_overflow"]) > 0


def test_bench_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(["--parity-only"])


# ------------------------------------------------ prewarm, profile trace --
@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    rng = np.random.default_rng(31)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=4,
                                      genome_len=3000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=2,
                       read_len=600, error_rate=0.02)
    idx = os.path.join(tmp, "idx.taxor.npz")
    cwd = os.getcwd()
    os.chdir(tmp)  # the build writes its layout file (binning.out) here
    try:
        assert cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                         gdir, "--output-filename", idx, "--kmer-size", "22",
                         "--syncmer-size", "12", "--use-syncmer"]) == 0
    finally:
        os.chdir(cwd)
    return tmp, idx, reads


def test_cli_prewarm_runs_on_the_cpu(small_index, capsys):
    _, idx, _ = small_index
    assert cli.main(["prewarm", "--index-file", idx, "--lengths", "300,1000",
                     "--topk", "16,32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for L in (512, 1024):
        for k in (16, 32):
            assert f"prewarm: L={L} topk={k} in " in out


def test_search_profile_trace_writes_a_trace(small_index):
    tmp, idx, reads = small_index
    trace = os.path.join(tmp, "trace")
    out = os.path.join(tmp, "traced.tsv")
    assert cli.main(["search", "--index-file", idx, "--query-file", reads,
                     "--output-file", out, "--engine", "device",
                     "--device", "cpu", "--profile-trace", trace]) == 0
    with open(os.path.join(trace, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("syncmer" in str(e.get("name", "")) or e.get("ph") == "X"
               for e in events)
    assert open(out).read().count("GCF_") >= 8


@pytest.mark.parametrize("preset", sorted(bench_probe.PRESETS))
def test_bench_probe_runs_on_the_twin(capsys, preset):
    assert bench_probe.main(["--preset", preset, "--reads", "6", "--hashes",
                             "64", "--valid", "20", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    R, H, _, S, bins = bench_probe.PRESETS[preset]
    assert out["device"] == "cpu" and out["table"] == [S, bins]
    assert out["valid_hashes"] == 6 * 20 and out["equal"]
    assert out["row_bytes"] == 3 * 6 * 20 * bins
    assert list(out["routes"]) == ["twin"] and out["routes"]["twin"]["ms"] > 0


def dsmem_thread(mode, C, rows_log2, iters, gid):
    """One thread of csrc/diag/dsmem.cu, scalar: its block's rank, its
    xorshift32 stream and the four words it XORs from the cluster's rows
    (word i of rank q's rows ((q + 1) 0x9E3779B1) ^ (i 0x85EBCA77))."""
    M = 0xFFFFFFFF
    T = diag.DSMEM_THREADS
    rows, rank, tid = 1 << rows_log2, (gid // T) % C, gid % T

    def word(q, i):
        return (((q + 1) * 0x9E3779B1) ^ (i * 0x85EBCA77)) & M

    s = ((gid * 0x9E3779B9) & M) | 1
    acc = [0, 0, 0, 0]
    for it in range(iters):
        s ^= (s << 13) & M
        s ^= s >> 17
        s ^= (s << 5) & M
        if mode == "word":
            acc[0] ^= word(rank, s & (4 * rows - 1))
            continue
        q, row = (rank + 1) % C, s & (rows - 1)
        if mode == "local":
            q = rank
        elif mode == "spread":
            g = s & (C * rows - 1)
            q, row = g >> rows_log2, g & (rows - 1)
        elif mode == "stream":
            row = (it * T + tid) & (rows - 1)
        acc = [a ^ word(q, 4 * row + j) for j, a in enumerate(acc)]
    return [a - (1 << 32) if a >= 1 << 31 else a for a in acc]


@pytest.mark.parametrize("mode", diag.DSMEM_MODES)
def test_dsmem_twin_matches_a_scalar_model(mode):
    C, clusters, rows_log2, iters = 4, 2, 5, 40
    got = diag.dsmem_rows(mode, C, clusters, rows_log2, iters, "cpu")
    assert got.shape == (clusters * C, diag.DSMEM_THREADS, 4)
    flat = got.view(-1, 4)
    for gid in (0, 1, 31, 1023, 1024, 4097, 8191):
        assert flat[gid].tolist() == dsmem_thread(mode, C, rows_log2, iters,
                                                  gid), gid


def test_bench_dsmem_runs_on_the_twin(capsys):
    assert bench_dsmem.main(["--device", "cpu", "--clusters", "2,16",
                             "--rows-log2", "6"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["equal"]
    assert set(out["rates"]) == {f"{C}/{m}" for C in (2, 16)
                                 for m in diag.DSMEM_MODES}
