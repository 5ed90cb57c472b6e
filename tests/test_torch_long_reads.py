"""Syncmer reads longer than L_CAP on the port's device engine: cut into
pieces of L_CAP bases (K1 on each piece), the pieces' hashes joined by
the union (K4 sorts, K6 keeps first occurrences), then the fused step.
On the CPU the plain twins run.  Held to the JAX package and the host
scanner with inputs made from a seed with numpy:

  - the twin of K1's tracker (``syncmer_emissions``, K1's own
    decomposition) against a serial tracker and the host scanner's
    emissions in position order, on random reads and reads tied in
    homopolymers, repeats, N runs and two-letter alphabets;
  - the piece plan: every window of a read is owned by one piece;
  - the union of the piece hashes, n_unique and n_emit equal the JAX
    package's ``search_hashes`` and the host scanner's emission count, on
    reads of L_CAP + 1 (its last piece adds fewer than k bases), 40,000,
    70,000 and 100,000 bases with a homopolymer, a dinucleotide repeat or
    Ns across every cut, and on tied stretches longer than a piece
    (``tools/synth.reads_across_cuts``), for three schemes and a
    FracMinHash scaling;
  - the union's twin on rows holding an all-ones hash, and a piece that
    overflows its hash capacity;
  - the TSV of the port's device engine (K1 and the split engine) equals
    the JAX package's device engine (on the CPU its XLA engine, which
    hashes reads past L_CAP on the host) and
    ``--engine host``, flat and hierarchical, every read past L_CAP
    counted in ``ROUTES['long_fused']``; under reads x bins meshes of
    gloo ranks (tests/torch_world.py) the same.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from taxor_tpu.hash import schemes as jax_schemes
from taxor_tpu.search import pipeline as jax_pipeline
from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device import e2e, sort
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash import schemes
from taxor_tpu_torch.hash.encode import encode_dna4
from taxor_tpu_torch.native import get_lib
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.tools import synth
from taxor_tpu_torch.utils.u64 import join32, wyhash64

from .torch_world import agreed, run_world
from .util import make_ref_set

# name -> (k, s, scaling); t is the reference's default (k - s + 1) // 2
SCHEMES = {"k22_s12": (22, 12, 1), "k16_s8": (16, 8, 1),
           "k32_s15": (32, 15, 1), "k22_s12_scaling3": (22, 12, 3)}
MESHES = [(1, 2), (2, 1), (2, 2)]
MESH_IDS = [f"{a}x{b}" for a, b in MESHES]


@pytest.fixture(scope="module")
def cut_reads():
    """(reads across cuts, tied stretches past a piece) at k = 22."""
    seqs = synth.reads_across_cuts(np.random.default_rng(19))
    n = len(synth.LONG_LENGTHS) * len(synth.CUT_KINDS)
    return {"cuts": seqs[:n], "tied": seqs[n:]}


@pytest.mark.parametrize("n", [1, 255, dsync.L_CAP, dsync.L_CAP + 1,
                               dsync.L_CAP + 21, 40000, 65504, 65505,
                               100000, 1_000_000])
def test_piece_plan_owns_every_window_once(n):
    """bucket_len holds the read in a power-of-two count of pieces, and
    the pieces' owned windows, mapped back to the read, are [k-1, n)
    each once."""
    k = 22
    L = dsync.bucket_len(n)
    P = dsync.bucket_pieces(L)
    assert L >= n and P & (P - 1) == 0 and P >= dsync.piece_count(n)
    assert dsync.hash_cap(L, k, 12, 5) == P * dsync.hash_cap(
        min(L, dsync.L_CAP), k, 12, 5)
    if P == 1:
        assert L == dsync.pad_len_bucket(n)
        return
    owned = dsync.piece_owned(torch.tensor([n], dtype=torch.int32), P, k)
    piece, pos = torch.nonzero(owned, as_tuple=True)
    ends = (piece * dsync.PIECE_STRIDE + pos).sort().values
    assert torch.equal(ends, torch.arange(k - 1, n))


def host_emissions(seq: bytes, k: int, s: int, t: int) -> int:
    """Emissions of the host scanner (native/syncmer_scan.cpp) on the
    whole read, before its np.unique."""
    codes = np.ascontiguousarray(encode_dna4(seq))
    out = np.empty(max(1, codes.shape[0]), dtype=np.uint64)
    return int(get_lib().syncmer_scan(
        codes.ctypes.data_as(ctypes.c_void_p), codes.shape[0], k, s, t,
        out.ctypes.data_as(ctypes.c_void_p)))


@pytest.mark.parametrize("group", ["cuts", "tied"])
@pytest.mark.parametrize("name", list(SCHEMES))
def test_union_equals_host_scanner(cut_reads, name, group):
    """The piece-and-union hashes of each read are the JAX package's
    search_hashes (the host scanner's set, np.unique'd), n_unique their
    count and n_emit the host scanner's emissions on the whole read."""
    if get_lib() is None:
        pytest.skip("needs g++ for the host scanner")
    k, s, scaling = SCHEMES[name]
    scheme = schemes.HashScheme.make(k, s, None, True, scaling)
    seqs = cut_reads[group]
    L = dsync.bucket_len(max(len(q) for q in seqs))
    assert dsync.bucket_pieces(L) == 4
    packed, lengths = dsync.pack_reads(seqs, L)
    hi, lo, valid, n_unique, n_emit = e2e._hashes(
        torch.from_numpy(packed), torch.from_numpy(lengths), "syncmer", k, s,
        scheme.t_syncmer, 0, dsync.hash_cap(L, k, s, scheme.t_syncmer),
        schemes.scaling_threshold_u64(scaling) if scaling > 1 else 0)
    want = jax_schemes.search_hashes(seqs, jax_schemes.HashScheme.make(
        k, s, None, True, scaling))
    for r, w in enumerate(want):
        got = np.sort(join32(hi[r], lo[r])[valid[r]].numpy().astype(
            np.uint64))
        np.testing.assert_array_equal(got, w)
        assert int(n_unique[r]) == w.shape[0]
        assert int(n_emit[r]) == host_emissions(seqs[r], k, s,
                                                scheme.t_syncmer)


@pytest.mark.parametrize("group", ["cuts", "tied"])
def test_pieces_own_the_whole_reads_emissions(cut_reads, group):
    """K1's piece rows (their twin): the owned emissions, mapped back to
    the read, are the whole read's, and each owned k-mer is the read's
    k-mer at that end."""
    k, s, t = 22, 12, 5
    seqs = cut_reads[group]
    L = dsync.bucket_len(max(len(q) for q in seqs))
    P = dsync.bucket_pieces(L)
    packed, lengths = (torch.from_numpy(x)
                       for x in dsync.pack_reads(seqs, L))
    kmer, emit = dsync.syncmer_kmers_pieces(packed, lengths, k, s, t, P)
    whole_kmer, whole_emit = dsync.syncmer_kmers(packed, lengths, k, s, t)
    R = len(seqs)
    idx = (torch.arange(P)[:, None] * dsync.PIECE_STRIDE
           + torch.arange(dsync.L_CAP)[None, :])
    back = torch.zeros_like(whole_emit)
    for r in range(R):
        e = emit[r * P:(r + 1) * P]
        back[r, idx[e]] = True
        assert torch.equal(kmer[r * P:(r + 1) * P][e], whole_kmer[r, idx[e]])
    assert torch.equal(back, whole_emit)
    assert emit.sum() == whole_emit.sum()


def serial_emissions(packed, lengths, k: int, s: int, t: int):
    """emit bool [R, L] of the reference's tracker stepped one base at a
    time over every read (the twin's form before it classified windows
    in parallel): leftmost minimum on the first full window, the
    rightmost minimum of the new window when the held one slides out,
    else only a strictly smaller newcomer takes over."""
    w = k - s + 1
    codes = dsync.unpack_codes(packed)
    R, L = codes.shape
    sf, sr = dsync._rolling(codes, s)
    ys = torch.minimum(sf, sr)
    ends = torch.arange(L).expand(R, L)
    rm_val, rm_end = ys, ends
    for d in range(1, w):
        cand = dsync._shift_right(ys, d, fill=1 << 62)
        take = cand < rm_val
        rm_val = torch.where(take, cand, rm_val)
        rm_end = torch.where(take, ends - d, rm_end)
    emit = torch.zeros((R, L), dtype=torch.bool)
    qv = ys[:, s - 1].clone()
    qp = torch.zeros(R, dtype=torch.int64)
    for j in range(1, w):
        take = ys[:, s - 1 + j] < qv
        qv = torch.where(take, ys[:, s - 1 + j], qv)
        qp = torch.where(take, torch.full_like(qp, j), qp)
    emit[:, k - 1] = qp == t - 1
    for i in range(k, L):
        popped = qp == i - k
        newer = ~popped & (ys[:, i] < qv)
        qv = torch.where(popped, rm_val[:, i],
                         torch.where(newer, ys[:, i], qv))
        qp = torch.where(popped, rm_end[:, i] - (s - 1),
                         torch.where(newer, torch.full_like(qp, i - s + 1),
                                     qp))
        emit[:, i] = qp == i - k + t
    return emit & (torch.arange(L)[None, :] < lengths.to(torch.int64)[:, None])


def tied_reads(rng, kind: str) -> list[bytes]:
    """Four reads of 1,000-4,096 bases of one kind: random bases, or
    random with homopolymers, dinucleotide or longer tandem repeats or N
    runs (read as A) at the start and inside, or reads of one or two
    letters."""
    lens = [4096, *rng.integers(1000, 4096, 3).tolist()]
    out = []
    for j, n in enumerate(lens):
        a = synth.BASES[rng.integers(0, 4, n)].copy()
        if kind == "two_letters":
            a = np.frombuffer(b"AT", np.uint8)[rng.integers(0, 2, n)].copy()
            if j == 0:
                a[:] = ord("C")
        elif kind != "random":
            unit = {"homopolymer": b"G", "dinucleotide": b"AC",
                    "tandem": b"ACGTTG", "n_runs": b"N"}[kind]
            for at, span in ((0, 40), (n // 3, 37 + 200 * j), (n // 2, 23)):
                seg = a[at:at + span]
                seg[:] = np.frombuffer(unit * span, np.uint8)[:seg.size]
        out.append(a.tobytes())
    return out


@pytest.mark.parametrize("kind", ["random", "homopolymer", "dinucleotide",
                                  "tandem", "n_runs", "two_letters"])
@pytest.mark.parametrize("k,s,t", [(22, 12, 5), (16, 8, 4), (14, 12, 1)])
def test_twin_emissions_equal_a_serial_tracker(k, s, t, kind):
    """The twin of K1 (syncmer_emissions: windows classified in parallel,
    tied runs replayed) marks the positions a serial tracker marks, and
    its k-mers there, in position order, hash to the host scanner's
    emissions (native/syncmer_scan.cpp), tied windows included."""
    seqs = tied_reads(np.random.default_rng(k * 100 + len(kind)), kind)
    packed, lengths = (torch.from_numpy(x)
                       for x in dsync.pack_reads(seqs, 4096))
    kmer, emit = dsync.syncmer_kmers(packed, lengths, k, s, t)
    assert torch.equal(emit, serial_emissions(packed, lengths, k, s, t))
    if get_lib() is None:
        return
    for r, q in enumerate(seqs):
        codes = np.ascontiguousarray(encode_dna4(q))
        out = np.empty(codes.shape[0], dtype=np.uint64)
        n = get_lib().syncmer_scan(
            codes.ctypes.data_as(ctypes.c_void_p), codes.shape[0], k, s, t,
            out.ctypes.data_as(ctypes.c_void_p))
        got = wyhash64(kmer[r][emit[r]]).numpy().view(np.uint64)
        np.testing.assert_array_equal(got, out[:n])


ONES = 2**64 - 1


@pytest.mark.parametrize("where", ["alone", "in_two_pieces", "row_full"])
def test_union_twin_keeps_an_all_ones_hash(where):
    """A real hash equal to K4's all-ones padding: union_pieces keeps it
    once, counts it, and keeps the rows' other hashes."""
    hcap, P = 8, 2
    pieces = [[[5, 3], [3, 9, 1]], [[7], []]]  # [read][piece] -> hashes
    if where == "alone":
        pieces[0][0].append(ONES)
    elif where == "in_two_pieces":
        pieces[1][0].append(ONES)
        pieces[1][1] += [ONES, 7]
    else:
        pieces[0][1] = list(range(10, 10 + hcap - 1)) + [ONES]
    keys = torch.zeros((2 * P, hcap), dtype=torch.int64)
    valid = torch.zeros((2 * P, hcap), dtype=torch.bool)
    for r, read in enumerate(pieces):
        for j, hashes in enumerate(read):
            for q, h in enumerate(hashes):
                keys[r * P + j, q] = h - 2**64 if h >= 2**63 else h
                valid[r * P + j, q] = True
    hi, lo = (torch.where(valid, x, 0) for x in
              (keys >> 32, keys & 0xFFFFFFFF))
    n_emit = valid.sum(dim=1, dtype=torch.int32)
    out_hi, out_lo, out_valid, n_unique, ne = sort.union_pieces(
        hi.to(torch.int32), lo.to(torch.int32), valid, n_emit, P)
    for r, read in enumerate(pieces):
        want = sorted({h for hashes in read for h in hashes})
        got = [v & ONES for v in
               join32(out_hi[r], out_lo[r])[out_valid[r]].tolist()]
        assert got == want and int(n_unique[r]) == len(want)
        assert int(ne[r]) == sum(len(h) for h in read)


def test_piece_overflow_sends_the_read_to_the_host():
    """A gap-1 scheme (k = 14, s = 12, t = 1) emits more than a piece's
    hash capacity (here the k = 22, s = 12 scheme's L/4, below its ~1/3
    density): the read's n_emit is OVERFLOW, above its hcap, so the
    pipeline's decode sends it to the host oracle."""
    rng = np.random.default_rng(3)
    seqs = [synth.random_genome(rng, 40000), synth.random_genome(rng, 300)]
    L = dsync.bucket_len(40000)
    hcap = dsync.hash_cap(L, 22, 12, 5)
    packed, lengths = dsync.pack_reads(seqs, L)
    out = e2e._hashes(torch.from_numpy(packed), torch.from_numpy(lengths),
                      "syncmer", 14, 12, 1, 0, hcap, 0)
    assert int(out[4][0]) == sort.OVERFLOW > hcap
    assert int(out[4][1]) == host_emissions(seqs[1], 14, 12, 1)


# ------------------------------------------------------------ searches --
def long_read_set(root: str):
    """72 genomes of 36 kb (more user bins than --tmax 64: a hierarchy)
    and reads past L_CAP from 8 of them, taken as circular, 1%
    substitutions, two tied reads past a piece and two short reads."""
    rng = np.random.default_rng(23)
    tsv, gdir, genomes = make_ref_set(root, rng, n_species=72,
                                      genome_len=36000)
    accs = sorted(genomes)
    recs = []
    for j, n in enumerate((32769, 33500, 36000, 40000, 50000, 70000)):
        acc = accs[5 * j]
        seq = genomes[acc] * 2
        off = int(rng.integers(0, 36000))
        recs.append((f"long{j}_{acc}",
                     synth.mutate(rng, seq[off:off + n], 0.01)))
    tied = synth.reads_across_cuts(rng)[-2:]
    recs += [("tied0", tied[0]), ("tied1", tied[1])]
    for j in range(2):
        acc = accs[40 + j]
        recs.append((f"short{j}_{acc}",
                     synth.mutate(rng, genomes[acc][1000:2200], 0.01)))
    reads = os.path.join(root, "reads.fasta")
    synth.write_fasta(reads, recs)
    return tsv, gdir, reads, sum(len(q) > dsync.L_CAP for _, q in recs)


@pytest.fixture(scope="module")
def long_searches(tmp_path_factory):
    """The flat and the hierarchical index of long_read_set, and each
    one's JAX device-engine and JAX host-engine TSVs."""
    root = str(tmp_path_factory.mktemp("torch_long_reads"))
    tsv, gdir, reads, n_long = long_read_set(root)
    out = {"reads": reads, "n_long": n_long, "root": root}
    for layout in ("flat", "auto"):
        idx = os.path.join(root, f"{layout}.taxor.npz")
        run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename=idx,
            kmer_size=22, syncmer_size=12, use_syncmer=True,
            layout_mode=layout, tmax=64 if layout == "auto" else 0,
            layout_file=os.path.join(root, f"{layout}.out")))
        texts = {}
        for engine in ("device", "host"):
            path = os.path.join(root, f"{layout}_jax_{engine}.tsv")
            jax_pipeline.run_search(jax_pipeline.SearchConfig(
                index_file=idx, query_file=reads, report_file=path,
                engine=engine))
            with open(path, "rb") as fh:
                texts[engine] = fh.read()
        out[layout] = (idx, texts)
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["k1", "split"])
@pytest.mark.parametrize("layout", ["flat", "auto"])
def test_search_equals_jax_device_and_host(long_searches, layout, fused,
                                           monkeypatch):
    """The port's device TSV (its twins) == the JAX device engine's ==
    --engine host, every read past L_CAP on the fused step in pieces."""
    idx, jax_texts = long_searches[layout]
    monkeypatch.setattr(e2e, "USE_FUSED_EXTRACT", fused)
    root, reads = long_searches["root"], long_searches["reads"]
    texts = {}
    for engine in ("device", "host"):
        path = os.path.join(root, f"{layout}_{fused}_{engine}.tsv")
        pipeline.ROUTES.reset()
        pipeline.run_search(pipeline.SearchConfig(
            index_file=idx, query_file=reads, report_file=path,
            engine=engine), device="cpu")
        if engine == "device":
            routes = dict(pipeline.ROUTES.counts)
        with open(path, "rb") as fh:
            texts[engine] = fh.read()
    assert texts["device"] == texts["host"] == jax_texts["device"] \
        == jax_texts["host"]
    assert routes["long_fused"] == long_searches["n_long"]
    assert routes["host_hashes"] == 0 and routes["fused"] == 10
    rows = texts["host"].decode().splitlines()[1:]
    hits = {r.split("\t")[0] for r in rows if r.split("\t")[1] != "-"}
    assert {f"long{j}" for j in range(6)} <= {h.split("_")[0] for h in hits}


@pytest.fixture(scope="module")
def long_world(long_searches):
    """One gloo world of 4 ranks: the sharded engine's search of the long
    reads on both indexes, on every mesh."""
    cases = [{"kind": "search", "name": f"{layout}_long",
              "index": long_searches[layout][0],
              "query": long_searches["reads"]} for layout in ("flat", "auto")]
    out = os.path.join(long_searches["root"], "world")
    run_world(4, cases, MESHES, out)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("layout", ["flat", "auto"])
def test_sharded_search_takes_the_pieces(long_searches, long_world, layout,
                                         mesh):
    """Under a reads x bins mesh a long read's pieces stay on one reads
    row: every read past L_CAP takes the fused step, and the TSV is the
    JAX host engine's."""
    got = agreed(long_world, f"{layout}_long", mesh)
    assert int(got["route_long_fused"]) == long_searches["n_long"]
    assert int(got["route_host_hashes"]) == 0
    want = long_searches[layout][1]["host"].decode()
    assert pipeline.HEADER + str(got["tsv"]) == want
