"""The CUDA kernels K1, K2 and K2n and the fused steps on the card, held
bit-exact to their plain twins.  Needs a CUDA GPU and nvcc; skips
elsewhere.  This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from taxor_tpu_torch.device import extract, probe
from taxor_tpu_torch.device.e2e import fused_e2e_step
from taxor_tpu_torch.hash import device_syncmer as dsync

pytestmark = pytest.mark.gpu

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def reads(rng, L, n=12):
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(L // 2, L + 1)))]
            .tobytes() for _ in range(n)]
    arr = ACGT[rng.integers(0, 4, L)].copy()
    arr[10:60] = ord("A")
    arr[rng.integers(0, L, L // 40)] = ord("N")
    return seqs + [arr.tobytes(), (b"ACGTTG" * L)[:L], b"", b"ACGT" * 5]


@pytest.mark.parametrize("L,k,s,t", [(256, 22, 12, 5), (4096, 22, 12, 5),
                                     (32768, 22, 12, 5), (2048, 16, 8, 4),
                                     (32768, 14, 12, 1)])
def test_k1_matches_twin(cuda, L, k, s, t):
    rng = np.random.default_rng(L + k)
    packed, lengths = dsync.pack_reads(reads(rng, L), L)
    pk = torch.from_numpy(packed).to(cuda)
    ln = torch.from_numpy(lengths).to(cuda)
    hcap = dsync.hash_cap(L)
    before = extract.syncmer_hashes.LAUNCHES
    got = extract.syncmer_hashes(pk, ln, k, s, t, hcap)
    want = extract.syncmer_hashes_plain(pk, ln, k, s, t, hcap)
    torch.cuda.synchronize()
    assert extract.syncmer_hashes.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.parametrize("bl,bins", [(1000, 1000), (5000, 2000),
                                     (2000, 5000), (30000, 64)])
def test_k2_matches_twin(cuda, bl, bins):
    rng = np.random.default_rng(bl)
    Bp = probe.pad_bins(bins)
    table = rng.integers(0, 256, (3 * bl, Bp), dtype=np.uint8)
    table[:, ::3] = 0
    hi = rng.integers(-2**31, 2**31, (6, 1500), dtype=np.int32)
    lo = rng.integers(-2**31, 2**31, (6, 1500), dtype=np.int32)
    valid = rng.random((6, 1500)) < 0.6
    args = [torch.from_numpy(x).to(cuda) for x in (hi, lo, valid)]
    tbl = torch.from_numpy(table).to(cuda)
    seed = int(rng.integers(0, 2**63))
    got = probe.probe_counts(*args, tbl, seed, bl)
    want = probe.probe_counts_plain(*args, tbl, seed, bl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("bins", [16, 64, 100, 512, 4096])
def test_grouped_probe_matches_twin(cuda, bins, G):
    """K2n (bins <= 512) and K2 over G stacked tables with a mixed
    activity mask, fingerprint-0 columns, and an all-inactive read."""
    rng = np.random.default_rng(bins * G)
    bl, R, H = 700, 9, 1300
    Bp = probe.pad_bins(bins)
    tables = rng.integers(0, 256, (G, 3 * bl, Bp), dtype=np.uint8)
    tables[:, :, ::3] = 0
    hi = rng.integers(-2**31, 2**31, (R, H), dtype=np.int32)
    lo = rng.integers(-2**31, 2**31, (R, H), dtype=np.int32)
    valid = rng.random((R, H)) < 0.7
    active = rng.random((G, R)) < 0.5
    active[:, 0] = True
    active[:, R - 1] = False
    args = [torch.from_numpy(x).to(cuda) for x in (hi, lo, valid, tables,
                                                   active)]
    seed = int(rng.integers(0, 2**63))
    kernel = probe.k2n_counts if Bp <= probe.NARROW_MAX_BINS \
        else probe.k2_counts
    before = kernel.LAUNCHES
    got = probe.probe_counts_grouped(*args, seed, bl)
    want = probe.probe_counts_grouped_plain(*args, seed, bl)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    assert torch.equal(got, want)
    assert int(got[:, R - 1].abs().sum()) == 0
    if Bp <= probe.NARROW_MAX_BINS:  # K2 computes the same counts
        assert torch.equal(probe.k2_counts(*args, seed, bl), want)


def test_fused_step_matches_cpu_twins(cuda):
    rng = np.random.default_rng(5)
    L, k, s, t, topk = 2048, 22, 12, 5, 16
    packed, lengths = dsync.pack_reads(reads(rng, L, n=40), L)
    bins, bl = 300, 1500
    table = rng.integers(0, 256, (3 * bl, probe.pad_bins(bins)),
                         dtype=np.uint8)
    table[:, 7] = 0  # a bin every read hits often
    offsets = np.array([0, 3, 4, 10, 100, 250, 300])
    users = np.array([0, -1, 1, 2, 3, 4], dtype=np.int32)
    args = [torch.from_numpy(x) for x in (table, packed, lengths, offsets,
                                          users)]
    kw = dict(k=k, s=s, t=t, hcap=dsync.hash_cap(L), topk=topk)
    want = fused_e2e_step(*args, 77, bl, **kw)
    got = fused_e2e_step(*[a.to(cuda) for a in args], 77, bl, **kw)
    assert torch.equal(got.cpu(), want)


def test_hier_grouped_step_matches_cpu_twins(cuda, tmp_path):
    """The hierarchical grouped step on the card (K1, K2n over stacked
    subgroups) and the per-IXF traversal of host hashes equal the same
    on the CPU twins."""
    from taxor_tpu.apps.build import BuildConfig, run_build
    from taxor_tpu.hash.schemes import search_hashes
    from taxor_tpu.search.thresholds import Thresholder
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF

    from .util import make_ref_set

    rng = np.random.default_rng(21)
    tsv, gdir, genomes = make_ref_set(str(tmp_path), rng, n_species=100,
                                      genome_len=3000)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=22, syncmer_size=12, use_syncmer=True, layout_mode="auto",
        tmax=64, layout_file=str(tmp_path / "b.out")))
    seqs = [g[o:o + 900] for g in genomes.values() for o in (0, 1500)]
    packed, lengths = dsync.pack_reads(seqs, 1024)
    th = Thresholder.make(22, 22, 0.04, -1.0, True)
    dhs = [DeviceHIXF.from_hixf(index.hixf, dev) for dev in ("cpu", cuda)]
    out = [dh.e2e_async(packed, lengths, index.scheme, th)() for dh in dhs]
    assert len(index.hixf.ixfs) > 1
    for a, b in zip(out[0][:4], out[1][:4]):
        np.testing.assert_array_equal(a, b)
    assert (out[1][0][:, 0] > 0).all()
    hl = search_hashes(seqs[:40], index.scheme)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    hi, lo, valid = probe.pack_hash_lists(hl, 256)
    before = probe.k2n_counts.ROUTES.get("host_hashes", 0)
    dense = [dh.counts(hi, lo, valid, thr) for dh in dhs]
    assert probe.k2n_counts.ROUTES["host_hashes"] > before + 1  # descended
    for a, b in zip(*dense):
        np.testing.assert_array_equal(a, b)
    assert dense[1][1].any(axis=1).all()


def test_wrappers_check_inputs(cuda):
    pk = torch.zeros((2, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="lengths"):
        extract.syncmer_hashes(pk, torch.zeros(2, dtype=torch.int64,
                                               device=cuda), 22, 12, 5, 128)
    z = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    table = torch.zeros((30, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        probe.probe_counts(z, z, z.bool(), table, 1, 11)
    wide = torch.zeros((1, 30, 1024), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        probe.k2n_counts(z, z, z.bool(), wide, None, 1, 10)
