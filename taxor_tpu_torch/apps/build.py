"""taxor build — construct a TaxorIndex from reference FASTAs + taxonomy.

Replicates src/main/taxor_build.cpp:545-597:
  1. parse the 6-column taxonomy TSV(s),
  2. map each accession to its genome file by scanning the input
     sequence dirs (file stem's first two '_'-separated parts form the
     accession, taxor_build.cpp:238-266),
  3. compute a layout (HLL counting + hierarchical DP, or flat),
  4. hierarchical HIXF build, record per-species user_bin + seq_len
     (taxor_build.cpp:516-527),
  5. serialize the index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..hash.schemes import HashScheme
from ..hixf.build import build_hixf_from_layout
from ..hixf.index import TaxorIndex, save_index
from ..hixf.layout import LayoutNode, flat_layout, write_layout
from ..io.fastx import iter_fastx
from ..io.taxonomy import Species, parse_refseq_taxonomy_file


@dataclass
class BuildConfig:
    input_file: str = ""
    input_sequence_dir: str = ""
    output_filename: str = ""
    kmer_size: int = 20
    syncmer_size: int = 10
    window_size: int = 0  # hidden flag; 0/“<k” means plain k-mer
    scaling: int = 1
    threads: int = 1
    use_syncmer: bool = False
    layout_mode: str = "auto"  # 'auto' (DP) | 'flat'
    # layout scoring: 'cpu' = reference-style expected-HIBF-query-cost;
    # 'device' = the port's probe kernels on the H100 (hixf/device_cost.py
    # via binning._expected_query_cost_device), which also considers a
    # flat layout
    layout_cost: str = "cpu"
    layout_file: str = "binning.out"
    tmax: int = 4096
    spill_dir: str = ""  # bound peak RSS via on-disk hash files
    verbose_stats: bool = False  # --output-verbose-statistics
    # counting-stage artifacts: <prefix>.count + <prefix>_sketches/
    # (the reference always leaves chopper.count + sketch dir behind,
    # taxor_build.cpp:437-442); empty = don't emit
    count_output_prefix: str = ""
    # resume: reuse an existing layout_file (skips counting + DP — the
    # analog of restarting the reference after the binning.out stage)
    resume: bool = False


def sanity_checks(config: BuildConfig) -> None:
    if config.use_syncmer and config.kmer_size > 30:
        raise ValueError(
            "The chosen k-mer size is too large for the syncmer scheme. "
            "Please choose a k-mer size <= 30 or use the minimizer scheme"
        )


def file_list(input_folders: list[str]) -> dict[str, str]:
    """accession -> genome file path (taxor_build.cpp:238-266)."""
    result: dict[str, str] = {}
    for folder in input_folders:
        for name in sorted(os.listdir(folder)):
            path = os.path.join(folder, name)
            if not os.path.isfile(path):
                continue
            stem = os.path.splitext(name)[0]
            parts = stem.split("_")
            if len(parts) > 1:
                accession = parts[0] + "_" + parts[1]
                result.setdefault(accession, path)
    return result


def create_filename_clusters(
    config: BuildConfig, orgs: list[Species]
) -> tuple[dict[str, list[str]], dict[str, int]]:
    """accession -> [files]; file path -> species index
    (taxor_build.cpp:268-293)."""
    folders = config.input_sequence_dir.split(",")
    files = file_list(folders)
    clusters: dict[str, list[str]] = {}
    user_bin_map: dict[str, int] = {}
    for org_index, org in enumerate(orgs):
        if org.accession_id not in files:
            raise ValueError(
                f"Could not find a genome file for {org.accession_id}"
            )
        filepath = files[org.accession_id]
        clusters.setdefault(org.accession_id, []).append(filepath)
        user_bin_map[filepath] = org_index
    return clusters, user_bin_map


def make_layout(
    config: BuildConfig,
    clusters: dict[str, list[str]],
    scheme: HashScheme,
    file_hashes: dict | None = None,
) -> LayoutNode:
    ordered_files = [clusters[acc][0] for acc in clusters]
    if config.layout_mode == "flat":
        return flat_layout(ordered_files)
    from ..hixf.binning import compute_layout_from_hashes

    return compute_layout_from_hashes(
        file_hashes, clusters, tmax=config.tmax,
        verbose=config.verbose_stats,
        artifacts_prefix=config.count_output_prefix,
        cost_model=config.layout_cost, scaling=scheme.scaling)


def run_build(config: BuildConfig) -> TaxorIndex:
    sanity_checks(config)
    from ..hash import schemes as _schemes

    _schemes.NUM_THREADS = max(1, int(config.threads))

    orgs: list[Species] = []
    for f in config.input_file.split(","):
        orgs.extend(parse_refseq_taxonomy_file(f))

    clusters, user_bin_map = create_filename_clusters(config, orgs)

    scheme = HashScheme.make(
        kmer_size=config.kmer_size,
        syncmer_size=config.syncmer_size,
        window_size=config.window_size or config.kmer_size,
        use_syncmer=config.use_syncmer,
        scaling=config.scaling,
    )

    # hash every genome once; layout sketches and the HIXF build share it
    import time as _time

    from ..hixf.build import precompute_file_hashes

    timings: dict[str, float] = {}
    t0 = _time.perf_counter()
    all_files = [f for files in clusters.values() for f in files]
    file_hashes = precompute_file_hashes(
        all_files, scheme, spill_dir=config.spill_dir or None
    )
    timings["count_s"] = _time.perf_counter() - t0

    t0 = _time.perf_counter()
    if config.resume and config.layout_file and \
            os.path.exists(config.layout_file):
        from ..hixf.layout import parse_layout

        layout = parse_layout(config.layout_file)
    else:
        layout = make_layout(config, clusters, scheme, file_hashes)
        if config.layout_file:
            write_layout(layout, config.layout_file)
    timings["layout_s"] = _time.perf_counter() - t0

    def hash_fn(filenames: list[str]):
        parts = [file_hashes.get(f) for f in filenames]
        if len(parts) == 1:
            return parts[0]
        return np.unique(np.concatenate(parts))

    hixf, _ = build_hixf_from_layout(layout, scheme, hash_fn=hash_fn,
                                     spill_dir=config.spill_dir or None,
                                     threads=config.threads,
                                     timings=timings)

    # per-species bookkeeping (taxor_build.cpp:516-527)
    for ub, joined in enumerate(hixf.user_bin_filenames):
        first_file = joined.split(";")[0]
        org_index = user_bin_map[first_file]
        orgs[org_index].user_bin = ub
        orgs[org_index].seq_len = sum(
            len(rec.seq) for f in joined.split(";") for rec in iter_fastx(f)
        )

    index = TaxorIndex(scheme=scheme, species=orgs, hixf=hixf,
                       suggested_topk=_suggest_topk(clusters, hash_fn))
    t0 = _time.perf_counter()
    if config.output_filename:
        save_index(config.output_filename, index)
    timings["serialize_s"] = _time.perf_counter() - t0
    index.build_timings = timings
    return index


def _suggest_topk(clusters, hash_fn, m: int = 16) -> int:
    """Pre-seed the search top-k ladder from build-time homology.

    Near-identical references (e.g. strains of one species) produce
    co-equal per-bin counts at search time; a 16-wide top-k then
    truncates and the pipeline escalates 16->64->256 with a recompile
    per rung on the first batches.  The index can predict this: the
    bottom-m (smallest) hash values of each user bin form a MinHash
    signature, and a bottom hash shared by g bins means ~g bins contain
    that k-mer — for near-duplicate groups most bottom hashes are
    shared by the whole group, so the max share count estimates the
    largest homology group.  Distinct genomes share essentially no
    bottom hashes (a lone collision leaves g = 2, far under the first
    rung).  Cost: O(bins * m) on the already-computed sorted hash sets.
    """
    from collections import Counter

    share: Counter = Counter()
    for files in clusters.values():
        h = hash_fn(files)
        for v in h[:m]:
            share[int(v)] += 1
    g = max(share.values(), default=1)
    if g <= 4:
        topk = 16
    elif g <= 16:
        topk = 64
    else:
        topk = 256
    # wide indexes truncate from FILTER NOISE, not homology: with B user
    # bins, ~B * P(fp-count >= tau) bins clear the threshold on pure
    # false positives, and at >= ~10k bins that regularly fills 16 slots
    # (measured: every 24.5k-bin at-scale batch escalated 16 -> 64 and
    # paid a mid-run recompile).  Floor the rung by bin count so the
    # first batch already runs at the rung it would escalate to.
    if len(clusters) > 8192:
        topk = max(topk, 64)
    return topk
