"""Synthetic reference sets and reads for the tools and the benchmark.

The port's copy of the JAX package's test helpers (tests/util.py:
``mutate``, ``simulate_read``, ``make_ref_set``, ``make_reads``) and of
the benchmark's problems (bench.py: ``build_problem``,
``_mixed_length_reads``).  The random draws come in the same order, so
one seed writes the same taxonomy TSV, genome FASTAs and reads, byte for
byte (tests/test_torch_tools.py holds them equal).  Beside them,
``write_wide_root_layout`` writes a hierarchical layout whose root is
wider than 512 bins, which the layout's own search does not give at a
size the tests can build, and ``reads_across_cuts`` reads past L_CAP
whose cuts into pieces are the tracker's hard cases.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng, length: int) -> bytes:
    return BASES[rng.integers(0, 4, length)].tobytes()


def mutate(rng, seq: bytes, error_rate: float) -> bytes:
    """Substitution-only read errors."""
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    n_err = rng.binomial(arr.shape[0], error_rate)
    pos = rng.choice(arr.shape[0], size=n_err, replace=False)
    arr[pos] = BASES[rng.integers(0, 4, n_err)]
    return arr.tobytes()


def simulate_read(rng, genome: bytes, read_len: int,
                  error_rate: float) -> bytes:
    start = int(rng.integers(0, max(1, len(genome) - read_len)))
    return mutate(rng, genome[start:start + read_len], error_rate)


def write_fasta(path: str, records: list[tuple[str, bytes]]) -> None:
    with open(path, "w") as fh:
        for rid, seq in records:
            fh.write(f">{rid}\n{seq.decode()}\n")


def make_ref_set(tmpdir: str, rng, n_species: int = 6,
                 genome_len: int = 20000):
    """Genome FASTAs + a 6-column taxonomy TSV under tmpdir.  Returns
    (taxonomy_tsv_path, genome_dir, genomes dict acc -> seq)."""
    gdir = os.path.join(tmpdir, "genomes")
    os.makedirs(gdir, exist_ok=True)
    rows = []
    genomes = {}
    for i in range(n_species):
        acc = f"GCF_{i:06d}.1"
        seq = random_genome(rng, genome_len)
        genomes[acc] = seq
        write_fasta(os.path.join(gdir, f"{acc}_genomic.fna"),
                    [(f"{acc} chromosome", seq)])
        names = (
            f"k__Viruses;p__Phylum{i % 2};c__Class{i % 2};o__Order{i % 2};"
            f"f__Family{i % 3};g__Genus{i};s__Species {i}"
        )
        taxids = (
            f"10239;{2000 + i % 2};{3000 + i % 2};{4000 + i % 2};"
            f"{5000 + i % 3};{6000 + i};{1000 + i}"
        )
        rows.append(f"{acc}\t{1000 + i}\tftp://x/{acc}_genomic.fna\t"
                    f"Organism {i}\t{names}\t{taxids}")
    tsv = os.path.join(tmpdir, "taxonomy.tsv")
    with open(tsv, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return tsv, gdir, genomes


def make_reads(tmpdir: str, rng, genomes: dict, n_reads_per_genome: int = 5,
               read_len: int = 2000, error_rate: float = 0.02) -> str:
    """Simulated reads FASTA; read ids encode the source accession."""
    records = []
    c = 0
    for acc, seq in genomes.items():
        for _ in range(n_reads_per_genome):
            records.append((f"read{c}_{acc}",
                            simulate_read(rng, seq, read_len, error_rate)))
            c += 1
    path = os.path.join(tmpdir, "reads.fasta")
    write_fasta(path, records)
    return path


def build_problem(n_species=256, genome_len=20000, n_reads=8192,
                  read_len=2000, error_rate=0.02, seed=0,
                  mutate_from_first=0.0, root: str | None = None):
    """(tmp, tsv, genome_dir, reads_fasta) of the benchmark problem under
    a new directory in ``root`` (the system's temp directory when None).
    mutate_from_first > 0: every genome is the first one with that share
    of point mutations, so reads hit many genomes with equal counts (the
    top-k truncation stress)."""
    tmp = tempfile.mkdtemp(prefix="taxor_bench_", dir=root)
    rng = np.random.default_rng(seed)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=n_species,
                                      genome_len=genome_len)
    if mutate_from_first > 0.0:
        base = genomes[sorted(genomes)[0]]
        arr0 = np.frombuffer(base, dtype=np.uint8).copy()
        for acc in sorted(genomes):
            arr = arr0.copy()
            nmut = int(len(arr) * mutate_from_first)
            idx = rng.choice(len(arr), size=nmut, replace=False)
            arr[idx] = BASES[rng.integers(0, 4, nmut)]
            genomes[acc] = arr.tobytes()
            with open(os.path.join(gdir, f"{acc}_genomic.fna"), "wb") as fh:
                fh.write(b">" + acc.encode() + b"\n" + genomes[acc] + b"\n")
    reads = make_reads(tmp, rng, genomes,
                       n_reads_per_genome=max(1, n_reads // n_species),
                       read_len=read_len, error_rate=error_rate)
    return tmp, tsv, gdir, reads


def mixed_length_reads(tmp: str, seed: int = 17, n_reads: int = 192):
    """(tsv, genome_dir, reads_fastq) of 96 genomes of 9 kb under tmp and
    n_reads reads of 500 b .. 4 kb drawn from them, 2% substitutions: a
    reference set the layout makes hierarchical at --tmax 64, read across
    several length buckets."""
    rng = np.random.default_rng(seed)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=96,
                                      genome_len=9000)
    out = os.path.join(tmp, "mixed.fastq")
    with open(out, "w") as fh:
        accs = sorted(genomes)
        for i in range(n_reads):
            acc = accs[int(rng.integers(0, len(accs)))]
            g = genomes[acc]
            ln = int(rng.choice([500, 900, 1700, 3100, 4000]))
            ln = min(ln, len(g) - 1)
            off = int(rng.integers(0, len(g) - ln))
            seq = bytearray(g[off:off + ln])
            for p in rng.integers(0, ln, int(ln * 0.02)):
                seq[p] = b"ACGT"[int(rng.integers(0, 4))]
            fh.write(f"@r{i}_{acc}\n{seq.decode()}\n+\n{'I' * ln}\n")
    return tsv, gdir, out


# what reads_across_cuts puts at each cut
CUT_KINDS = ("homopolymer", "dinucleotide", "n")
LONG_LENGTHS = (32769, 40000, 70000, 100000)


def reads_across_cuts(rng, k: int = 22,
                      lengths=LONG_LENGTHS) -> list[bytes]:
    """Syncmer reads past L_CAP whose cuts into pieces are the tracker's
    hard cases: for each length and each of CUT_KINDS, random bases with,
    across every piece's first window (hash/device_syncmer.piece_owned),
    a homopolymer of 240 bases, a dinucleotide repeat of 300 (both longer
    than the pieces' overlap), or Ns at the window's first and last base
    (dna4 reads N as A); then tied stretches longer than a piece: a
    homopolymer and a dinucleotide repeat of 40,000 bases in random
    sequence, a read of one letter and a period-6 tandem repeat.  A
    read of L_CAP + 1 bases has a last piece that adds fewer than k
    bases."""
    from ..hash.device_syncmer import PIECE_STRIDE, piece_count

    out = []
    for n in lengths:
        for kind in CUT_KINDS:
            a = BASES[rng.integers(0, 4, n)].copy()
            for j in range(1, piece_count(n)):
                c = j * PIECE_STRIDE + k - 1  # the piece's first window
                if kind == "homopolymer":
                    a[c - 120:c + 120] = ord("A")
                elif kind == "dinucleotide":  # clipped at the read's end
                    seg = a[c - 150:c + 150]
                    seg[:] = np.frombuffer(b"AC" * 150, np.uint8)[:seg.size]
                else:
                    a[[c - k + 1, c]] = ord("N")
            out.append(a.tobytes())
    for unit in (b"A", b"AC"):
        a = BASES[rng.integers(0, 4, 70000)].copy()
        a[5000:45000] = np.frombuffer(unit * (40000 // len(unit)), np.uint8)
        out.append(a.tobytes())
    return out + [b"G" * 70000, (b"ACGTTG" * 12000)[:70000]]


def write_wide_root_layout(files: list[str], path: str, split: int = 8,
                           child: int = 10) -> int:
    """Write a layout file (the build's binning.out format, for
    ``BuildConfig(resume=True, layout_file=path)``) whose root is wider
    than most: files[0] split over ``split`` technical bins, then one bin
    for each file but the last 2 * ``child``, which fill two merged bins
    of ``child`` bins each.  Returns the root's technical bins: past 512
    (544 bins padded) at 540 files, so that its descent group is a
    single IXF wider than K2n's domain."""
    from ..hixf.layout import LayoutNode, LayoutRecord, write_layout

    n_root = len(files) - 2 * child
    if n_root < 1 or child < 1:
        raise ValueError("write_wide_root_layout: too few files")
    root = LayoutNode(max_bin_index=0)
    root.records.append(LayoutRecord([files[0]], 0, split))
    for i, f in enumerate(files[1:n_root]):
        root.records.append(LayoutRecord([f], split + i, 1))
    nb = split + n_root - 1
    for m in range(2):
        kid = LayoutNode(max_bin_index=0, num_technical_bins=child)
        for j in range(child):
            kid.records.append(
                LayoutRecord([files[n_root + m * child + j]], j, 1))
        root.children[nb + m] = kid
    root.num_technical_bins = nb + 2
    write_layout(root, path)
    return root.num_technical_bins


def big_table_problem(device, G: int, S: int, Bpad: int, R: int = 256,
                      H: int = 256, seed: int = 0) -> dict:
    """Inputs of the probe kernels on a stack of G random uint8 [S,
    Bpad] tables made on ``device`` (3 x 2^24 slots of 64 bins, or 2 x 3
    x 2^20 of 512, hold more than 2^31 bytes, every hash's third row past
    byte 2^31): keys hi/lo int32 [R, H], valid bool [R, H] (70%), active
    bool [G, R] (read 0 active everywhere, read 1 nowhere), a CSR of runs
    over each table's bins (widths 1, 3, 16, 5, ...), and half of the
    valid hashes planted in every bin of every table (the third row set
    to the XOR of the other two and the fingerprint), so that counts run
    up to the hashes a read holds.  Block length S // 3."""
    import torch

    from ..utils.u64 import join32, probe_positions_and_fprint4

    rng = np.random.default_rng(seed)
    bl = S // 3
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = torch.randint(0, 256, (G, S, Bpad), dtype=torch.uint8,
                           device=device, generator=gen)
    keys = rng.integers(-2**31, 2**31, (2, R, H), dtype=np.int32)
    valid = rng.random((R, H)) < 0.7
    active = rng.random((G, R)) < 0.6
    active[:, 0], active[:, 1] = True, False
    hi, lo = (torch.from_numpy(x).to(device) for x in keys)
    key_seed = int(rng.integers(0, 2**63))
    pos, f4 = probe_positions_and_fprint4(join32(hi, lo), key_seed, bl)
    plant = torch.from_numpy(valid & (rng.random((R, H)) < 0.5)).to(device)
    p = pos[plant].long()
    fp = (f4[plant] & 0xFF).to(torch.uint8)[:, None]
    for g in range(G):
        t = tables[g]
        t[p[:, 2]] = t[p[:, 0]] ^ t[p[:, 1]] ^ fp
    offs, starts, ends = [0], [], []
    widths = (1, 3, 16, 5, 60, 2)
    for g in range(G):
        col, i = 0, g
        while col < Bpad:
            e = min(Bpad, col + widths[i % len(widths)])
            starts.append(col)
            ends.append(e)
            col, i = e, i + 1
        offs.append(len(starts))
    runs = [torch.tensor(x, dtype=torch.int64, device=device)
            for x in (offs, starts, ends)]
    return dict(hi=hi, lo=lo, valid=torch.from_numpy(valid).to(device),
                tables=tables, active=torch.from_numpy(active).to(device),
                runs=runs, seed=key_seed, block_length=bl)
