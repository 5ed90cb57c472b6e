"""Synthetic reference sets and reads for the tools and the benchmark.

The port's copy of the JAX package's test helpers (tests/util.py:
``mutate``, ``simulate_read``, ``make_ref_set``, ``make_reads``) and of
the benchmark's problems (bench.py: ``build_problem``,
``_mixed_length_reads``).  The random draws come in the same order, so
one seed writes the same taxonomy TSV, genome FASTAs and reads, byte for
byte (tests/test_torch_tools.py holds them equal).  Beside them,
``write_wide_root_layout`` writes a hierarchical layout whose root is
wider than 512 bins, which the layout's own search does not give at a
size the tests can build.
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
