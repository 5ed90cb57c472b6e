"""Taxonomy input parsing and the Species record.

Mirrors src/taxonomy/Species.hpp:10-52, parse_ncbi_taxonomy.cpp:7-41 and
taxutil.cpp:9-26.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Species:
    accession_id: str = ""
    taxid: str = ""
    organism_name: str = ""
    file_stem: str = ""
    taxnames_string: str = ""
    taxid_string: str = ""
    user_bin: int = 0
    seq_len: int = 0


def read_tsv(path: str) -> list[list[str]]:
    lines: list[list[str]] = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if line == "":
                continue
            lines.append(line.split("\t"))
    return lines


def parse_gtdb_taxonomy_file(path: str) -> list[Species]:
    """GTDB-style taxonomy input.  The reference ships only an empty
    placeholder (src/taxonomy/parse_gtdb_taxonomy.cpp); GTDB metadata
    exports use the same 6-column layout with GTDB lineage strings
    (d__/p__/c__/o__/f__/g__/s__), which parse_refseq_taxonomy_file
    already handles, so this is an alias kept for API parity."""
    return parse_refseq_taxonomy_file(path)


def parse_refseq_taxonomy_file(path: str) -> list[Species]:
    """6-column input TSV: accession, taxid, ftp-path, organism name,
    taxnames string, taxid string (parse_ncbi_taxonomy.cpp:14-39)."""
    out: list[Species] = []
    for line in read_tsv(path):
        sp = Species()
        sp.accession_id = line[0]
        sp.taxid = line[1]
        sp.organism_name = line[3] if len(line) > 3 else ""
        sp.taxnames_string = line[4] if len(line) > 4 else ""
        sp.taxid_string = line[5] if len(line) > 5 else ""
        # file stem = final path component of the FTP path column
        ftp = line[2]
        cut = max(ftp.rfind("/"), ftp.rfind("\\"))
        if cut != -1:
            sp.file_stem = ftp[cut + 1 :]
        if sp.file_stem in ("", " "):
            raise ValueError(f"No file name found for {sp.accession_id} !!!")
        out.append(sp)
    return out
