"""CAMI BioBox output writers — byte-compatible with the reference
(src/taxonomy/profile_output.hpp:25-98).
"""

from __future__ import annotations

from dataclasses import dataclass

_TAX_RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus",
              "species"]


@dataclass
class ProfileOutput:
    rank: str = ""
    taxid: str = ""
    taxid_string: str = ""
    taxname_string: str = ""
    percentage: float = 0.0


def format_percentage(f: float, digits: int = 6) -> str:
    """C++ ostringstream with precision(digits): %.6g formatting
    (profile_output.hpp:18-23).  The reference passes the double through a
    float parameter first."""
    import numpy as np

    return f"{float(np.float32(f)):.{digits}g}"


def write_biobox_profiling_file(path: str,
                                rank_profiles: dict[str, ProfileOutput],
                                sample_id: str, threshold: float) -> None:
    with open(path, "w") as fout:
        fout.write(f"@SampleID:{sample_id}\n")
        fout.write("@Version:0.10.0\n")
        fout.write("@Ranks:superkingdom|phylum|class|order|family|genus|species\n")
        fout.write("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\n")
        for tr in _TAX_RANKS:
            for key in sorted(rank_profiles):  # std::map order
                p = rank_profiles[key]
                if p.rank == tr and p.percentage > threshold:
                    fout.write(
                        f"{p.taxid}\t{p.rank}\t{p.taxid_string}\t"
                        f"{p.taxname_string}\t"
                        f"{format_percentage(p.percentage * 100)}\n"
                    )


def write_sequence_abundance_file(path: str,
                                  rank_profiles: dict[str, ProfileOutput],
                                  sample_id: str, threshold: float) -> None:
    with open(path, "w") as fout:
        fout.write(f"@SampleID:{sample_id}\n")
        fout.write("@Version:0.10.0\n")
        fout.write("@Ranks:superkingdom|phylum|class|order|family|genus|species\n")
        fout.write("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\n")
        if "unclassified" in rank_profiles:
            pct = rank_profiles["unclassified"].percentage
            fout.write(
                f"unclassified\tno rank\t-\t-\t{format_percentage(pct * 100)}\n"
            )
        for tr in _TAX_RANKS:
            for key in sorted(rank_profiles):
                p = rank_profiles[key]
                if p.rank == tr and p.percentage > threshold:
                    fout.write(
                        f"{p.taxid}\t{p.rank}\t{p.taxid_string}\t"
                        f"{p.taxname_string}\t"
                        f"{format_percentage(p.percentage * 100)}\n"
                    )


def write_biobox_binning_file(path: str, binning_results: dict[str, list],
                              sample_id: str) -> None:
    """binning_results: read_id -> list of Search_Result-like objects with a
    ``tax_id`` attribute (profile_output.hpp:79-98)."""
    with open(path, "w") as fout:
        fout.write(f"@SampleID:{sample_id}\n")
        fout.write("@Version:0.10.0\n")
        fout.write("@@SEQUENCEID\tTAXID\n")
        for read_id in sorted(binning_results):  # std::map order
            results = binning_results[read_id]
            if len(results) == 0:
                fout.write(f"{read_id}\t-\n")
            else:
                fout.write(f"{read_id}\t{results[0].tax_id}\n")
