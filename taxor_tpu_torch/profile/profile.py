"""taxor profile — filtering, EM read reassignment, CAMI output.

A pure TSV -> TSV host transform, replicated statement-for-statement from
src/main/taxor_profile.cpp (including its quirks — the goal is output
parity).  Everywhere the reference iterates a ``std::map<std::string, _>``
we iterate keys in sorted order.

Replicated quirks (with reference lines):
  - parse keeps a leading '-' row even when real matches follow
    (taxor_profile.cpp:149-159),
  - round 2 uses min 3 unique reads and min 1% unique fraction — the
    comment says 10% but the code says 0.01 (":816-818"),
  - "explained-by" association filtering keeps the FIRST explanation
    inserted per ref (std::map::insert semantics, ":366,379"); the 95%
    co-mapping test is evaluated on the STRONGER-or-equal ref's read set
    and replaces that stronger ref (":349-383" — inverted from the
    MegaPath intent, but it is what the code does), and the 5% slack
    truncates to zero below 20 reads (nothing is ever explained there),
  - EM: ``min_post`` is never updated, so the *last* scored entry of a
    read is erased each iteration (":709-711,718-719"); reassigned
    entries keep their original tax_id (":442-444" only changes
    accession/ref_len),
  - EM convergence compares ΔlogL against +abs(log(1e-4)) (":725-726"),
    which usually stops after the 2nd iteration,
  - 0/0 and log(0) follow IEEE semantics (NaN/-inf propagate through
    likelihoods exactly as the C++ doubles do).

Divergences (documented):
  - the transitive-closure loop is capped at 10,000 passes (the reference
    can livelock on explanation cycles, ":385-399"),
  - if a read's every entry is skipped in an EM iteration the reference
    erases via an uninitialized iterator (UB); we skip the erase.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..io.cami import (
    ProfileOutput,
    write_biobox_binning_file,
    write_biobox_profiling_file,
    write_sequence_abundance_file,
)


@dataclass
class SearchResult:
    read_id: str = ""
    accession_id: str = ""
    tax_id: str = ""
    ref_len: int = 0
    query_len: int = 0
    query_hash_count: int = 0
    query_hash_match: int = 0


@dataclass
class ProfileConfig:
    search_file: str = ""
    report_file: str = ""
    sequence_abundance_file: str = ""
    binning_file: str = ""
    sample_id: str = ""
    threshold: float = 0.001
    em_steps: int = 100
    threads: int = 1


def _fdiv(a: float, b: float) -> float:
    """C++ double division (0/0 -> nan, x/0 -> inf)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(a) / np.float64(b))


def _flog(x: float) -> float:
    """C++ log (log(0) -> -inf, log(<0) -> nan)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.log(np.float64(x)))


def parse_search_results(path: str):
    """(results: read_id -> [SearchResult], taxpath: accession ->
    (taxid_string, taxnames_string)) — taxor_profile.cpp:93-163."""
    results: dict[str, list[SearchResult]] = {}
    taxpath: dict[str, tuple[str, str]] = {}
    with open(path) as fh:
        for idx, raw in enumerate(fh):
            if idx == 0:
                continue  # header
            line = raw.rstrip("\n").split("\t")
            read_id = line[0]
            sp = read_id.find(" ")
            if sp != -1:
                read_id = read_id[:sp]
            res = SearchResult(read_id=read_id)
            if line[1] == "-":
                res.accession_id = "-"
                res.query_len = int(line[5])
            else:
                res.accession_id = line[1]
                res.tax_id = line[3]
                res.ref_len = int(line[4])
                res.query_len = int(line[5])
                res.query_hash_count = int(line[6])
                res.query_hash_match = int(line[7])
                if res.accession_id not in taxpath:
                    taxpath[res.accession_id] = (line[9], line[8])
            if read_id not in results:
                results[read_id] = []
            if len(results[read_id]) > 0 and res.accession_id == "-":
                continue
            results[read_id].append(res)
    return results, taxpath


def get_refs_with_uniquely_mapping_reads(results) -> set[str]:
    out = set()
    for read_id in results:
        entries = results[read_id]
        if len(entries) == 1 and entries[0].accession_id != "-":
            out.add(entries[0].accession_id)
    return out


def remove_matches_to_nonunique_refs(results, ref_unique: set[str]) -> None:
    """taxor_profile.cpp:186-229."""
    for read_id in results:
        entries = results[read_id]
        if len(entries) <= 1:
            continue
        query_len = 0
        unique = False
        for e in entries:
            query_len = e.query_len
            if e.accession_id in ref_unique:
                unique = True
                break
        if unique:
            kept = [e for e in entries if e.accession_id in ref_unique]
            results[read_id] = kept
            entries = kept
        if len(entries) == 0:
            results[read_id] = [
                SearchResult(read_id=read_id, accession_id="-",
                             query_len=query_len)
            ]


def count_unique_ambiguous_mappings_per_reference(results):
    """accession -> [unique, ambiguous] (taxor_profile.cpp:232-264)."""
    counts: dict[str, list[int]] = {}
    for read_id in results:
        entries = results[read_id]
        if len(entries) == 1:
            if entries[0].accession_id != "-":
                counts.setdefault(entries[0].accession_id, [0, 0])[0] += 1
        else:
            for e in entries:
                counts.setdefault(e.accession_id, [0, 0])[1] += 1
    return counts


def remove_low_confidence_references(results, counts,
                                     min_unique_mappings: int,
                                     min_fraction_unique: float) -> None:
    accepted = set()
    for acc in counts:
        u, a = counts[acc]
        # float32 arithmetic like the C++ static_cast<float> compare
        if u >= min_unique_mappings and (
            np.float32(u) / np.float32(u + a) >= np.float32(min_fraction_unique)
        ):
            accepted.add(acc)
    remove_matches_to_nonunique_refs(results, accepted)


@dataclass
class _RefMapInfo:
    """Ref_Map_Info (taxor_profile.hpp)."""

    unique_assign_reads: int = 0
    all_assigned_reads: int = 0
    associated_species: dict[str, int] = field(default_factory=dict)


def filter_ref_associations(results) -> dict[str, int]:
    """MegaPath-style association filtering (taxor_profile.cpp:286-465).
    Returns surviving {accession: ref_len}."""
    taxa_lengths: dict[str, int] = {}
    assoc: dict[str, _RefMapInfo] = {}

    for read_id in sorted(results):
        entries = results[read_id]
        if len(entries) == 0:
            continue
        if len(entries) == 1:
            e = entries[0]
            if e.accession_id != "-":
                info = assoc.setdefault(e.accession_id, _RefMapInfo())
                info.unique_assign_reads += 1
                info.all_assigned_reads += 1
                if e.accession_id not in taxa_lengths:
                    taxa_lengths[e.accession_id] = e.ref_len
        else:
            acc_ids = []
            for e in entries:
                assoc.setdefault(e.accession_id, _RefMapInfo())
                acc_ids.append(e.accession_id)
                assoc[e.accession_id].all_assigned_reads += 1
                if e.accession_id not in taxa_lengths:
                    taxa_lengths[e.accession_id] = e.ref_len
            for a1 in acc_ids:
                for a2 in acc_ids:
                    if a1 == a2:
                        continue
                    assoc[a1].associated_species.setdefault(a2, 0)
                    assoc[a1].associated_species[a2] += 1

    # "A explained by B": first explanation inserted wins (map::insert)
    explained: dict[str, str] = {}
    for ref in sorted(assoc):
        info = assoc[ref]
        for ar in sorted(info.associated_species):
            shared = info.associated_species[ar]
            other = assoc[ar]
            if (info.unique_assign_reads > other.unique_assign_reads
                    or info.all_assigned_reads > other.all_assigned_reads):
                # >=95% of ref's reads co-map to ar
                if info.all_assigned_reads - shared < int(
                    0.05 * float(info.all_assigned_reads)
                ):
                    explained.setdefault(ref, ar)
            else:
                if other.all_assigned_reads - other.associated_species[
                    ref
                ] < int(0.05 * float(other.all_assigned_reads)):
                    explained.setdefault(ar, ref)

    # transitive closure (taxor_profile.cpp:385-399); capped to avoid the
    # reference's potential livelock on cycles
    for _ in range(10000):
        found = False
        for a in sorted(explained):
            b = explained[a]
            if b in explained and a != explained[b]:
                explained[a] = explained[b]
                found = True
        if not found:
            break

    # rewrite ambiguous mappings (taxor_profile.cpp:405-451)
    for read_id in sorted(results):
        entries = results[read_id]
        if len(entries) <= 1:
            continue
        acc_ids = {e.accession_id for e in entries}
        kept = []
        for e in entries:
            if e.accession_id in explained:
                target = explained[e.accession_id]
                if target in acc_ids:
                    continue  # erase this match
                e.accession_id = target
                e.ref_len = taxa_lengths[target]
            kept.append(e)
        results[read_id] = kept

    for acc in list(taxa_lengths):
        if acc in explained:
            del taxa_lengths[acc]
    return taxa_lengths


def calculate_log_likelihoods(results):
    """taxor_profile.cpp:477-513."""
    ll: dict[str, dict[str, float]] = {}
    for read_id in sorted(results):
        entries = results[read_id]
        if len(entries) == 0:
            continue
        read_ll: dict[str, float] = {}
        if len(entries) > 1:
            sum_ratio = 0.0
            for e in entries:
                sum_ratio += _fdiv(e.query_hash_match, e.query_hash_count)
            for e in entries:
                like = (
                    _flog(e.query_hash_match) - _flog(e.query_hash_count)
                ) - _flog(sum_ratio)
                if e.accession_id not in read_ll:
                    read_ll[e.accession_id] = like
        else:
            if entries[0].accession_id != "-":
                read_ll[entries[0].accession_id] = 0.0
        ll[read_id] = read_ll
    return ll


def update_log_prior_probabilities(log_priors, taxa, profile_results):
    """taxor_profile.cpp:515-566; returns the unclassified log prior."""
    ref_nts = {t: 0 for t in taxa}
    all_nts = 0
    unclassified_nts = 0
    for read_id in sorted(profile_results):
        entries = profile_results[read_id]
        if len(entries) == 0:
            continue
        all_nts += entries[0].query_len
        if entries[0].accession_id == "-":
            unclassified_nts += entries[0].query_len
            continue
        for e in entries:
            ref_nts[e.accession_id] += e.query_len
    for t in sorted(log_priors):
        log_priors[t] = _flog(ref_nts[t] + 1e-12) - _flog(all_nts)
    return _flog(unclassified_nts + 1e-12) - _flog(all_nts)


def expectation_maximization(iterations, taxa, results):
    """taxor_profile.cpp:638-741.  Mutates ``results``; returns
    (abundances, profile_results)."""
    log_priors = {t: _flog(1.0 / len(taxa)) if taxa else 0.0 for t in taxa}
    cond_ll = -np.finfo(np.float64).max
    iter_step = 0
    unclassified_abundance = 0.0
    profile_results: dict[str, list[SearchResult]] = {}
    while iter_step < iterations:
        ll = calculate_log_likelihoods(results)
        new_cond_ll = 0.0
        profile_results = {}
        for read_id in sorted(results):
            entries = results[read_id]
            if len(entries) == 0:
                continue
            max_post = -np.finfo(np.float64).max
            min_post = np.finfo(np.float64).max  # never updated (quirk)
            best: list[SearchResult] = []
            worst_idx: int | None = None
            i = 0
            while i < len(entries):
                e = entries[i]
                if e.accession_id == "-":
                    if len(entries) == 1:
                        best.append(e)
                        break
                    worst_idx = i
                    i += 1
                    if i >= len(entries):
                        break  # reference would deref end() here (UB)
                    e = entries[i]
                if (read_id in ll and e.accession_id in ll[read_id]
                        and e.accession_id in log_priors):
                    post = ll[read_id][e.accession_id] + log_priors[
                        e.accession_id
                    ]
                else:
                    i += 1
                    continue
                new_cond_ll += post
                if post >= max_post:
                    if post > max_post:
                        max_post = post
                        best = []
                    best.append(e)
                if post < min_post:
                    worst_idx = i
                i += 1
            profile_results[read_id] = list(best)
            if len(entries) > 1 and worst_idx is not None:
                del entries[worst_idx]
        unclassified_abundance = update_log_prior_probabilities(
            log_priors, taxa, profile_results
        )
        diff = new_cond_ll - cond_ll
        if diff < abs(math.log(0.0001)):
            break
        cond_ll = new_cond_ll
        iter_step += 1

    log_priors["unclassified"] = unclassified_abundance
    return {t: math.exp(v) for t, v in log_priors.items()}, profile_results


def calculate_relative_genomic_abundances(taxa, profile_results):
    """taxor_profile.cpp:743-794; coverage-normalized abundances."""
    ref_nts = {t: 0 for t in taxa}
    abundances = {t: 0.0 for t in taxa}
    for read_id in sorted(profile_results):
        entries = profile_results[read_id]
        if len(entries) == 0:
            continue
        if entries[0].accession_id == "-":
            continue
        for e in entries:
            if e.accession_id in ref_nts:
                ref_nts[e.accession_id] += e.query_len
    sum_avg_cov = 0.0
    for t in sorted(ref_nts):
        abundances[t] = _fdiv(ref_nts[t], taxa[t])
        sum_avg_cov += abundances[t]
    for t in sorted(abundances):
        abundances[t] = math.exp(
            _flog(abundances[t] + 1e-12) - _flog(sum_avg_cov)
        )
    return abundances


_RANK_OF_PREFIX = {
    "s": "species", "g": "genus", "f": "family", "o": "order",
    "c": "class", "p": "phylum", "k": "superkingdom",
}


def _cpp_split(s: str, delim: str) -> list[str]:
    """std::getline-based split: trailing empty segment dropped."""
    parts = s.split(delim)
    if parts and parts[-1] == "":
        parts.pop()
    return parts


def calculate_higher_rank_abundances(species_abundances, taxpath):
    """taxor_profile.cpp:568-636."""
    rank_profiles: dict[str, ProfileOutput] = {}
    for sp in sorted(species_abundances):
        a = species_abundances[sp]
        if a == 0:
            continue
        if sp == "unclassified":
            rank_profiles[sp] = ProfileOutput(taxid=sp, percentage=a)
            continue
        taxid_path = _cpp_split(taxpath[sp][0], ";")
        taxname_path = _cpp_split(taxpath[sp][1], ";")
        for index, tid in enumerate(taxid_path):
            if len(tid) < 1:
                continue
            if tid not in rank_profiles:
                p = ProfileOutput(taxid=tid)
                p.taxid_string = taxid_path[0]
                p.taxname_string = taxname_path[0][3:]
                for i2 in range(1, index + 1):
                    p.taxid_string += "|" + taxid_path[i2]
                    p.taxname_string += "|"
                    if len(taxname_path[i2]) > 1:
                        p.taxname_string += taxname_path[i2][3:]
                p.percentage = 0.0
                p.rank = _RANK_OF_PREFIX.get(taxname_path[index][:1], "")
                rank_profiles[tid] = p
            rank_profiles[tid].percentage += species_abundances[sp]
    return rank_profiles


def tax_profile(config: ProfileConfig) -> None:
    """taxor_profile.cpp:796-858."""
    results, taxpath = parse_search_results(config.search_file)

    # round 1
    ref_unique = get_refs_with_uniquely_mapping_reads(results)
    remove_matches_to_nonunique_refs(results, ref_unique)

    # round 2: >=3 unique reads, >=1% unique fraction
    counts = count_unique_ambiguous_mappings_per_reference(results)
    remove_low_confidence_references(results, counts, 3, 0.01)

    # round 3
    found_taxa = filter_ref_associations(results)

    tax_abundances, profile_results = expectation_maximization(
        config.em_steps, found_taxa, results
    )

    rank_profiles = calculate_higher_rank_abundances(tax_abundances, taxpath)
    if config.sequence_abundance_file:
        write_sequence_abundance_file(
            config.sequence_abundance_file, rank_profiles, config.sample_id,
            config.threshold,
        )

    tax_abundances = calculate_relative_genomic_abundances(
        found_taxa, profile_results
    )
    rank_profiles = calculate_higher_rank_abundances(tax_abundances, taxpath)

    write_biobox_profiling_file(config.report_file, rank_profiles,
                                config.sample_id, config.threshold)
    write_biobox_binning_file(config.binning_file, profile_results,
                              config.sample_id)


def run_profile(config: ProfileConfig) -> None:
    tax_profile(config)
