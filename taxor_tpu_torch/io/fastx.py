"""FASTA/FASTQ streaming with gzip/bzip2 support.

Replaces the seqan3 sequence_file_input used throughout the reference
(e.g. src/main/taxor_search.cpp:181, src/hixf/build/compute_hashes.cpp:53).
Record ids follow seqan3 field::id semantics: the full header line after
'>'/'@' (the profile stage later truncates at the first space, exactly like
taxor_profile.cpp:124-125).
"""

from __future__ import annotations

import bz2
import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    id: str
    seq: bytes


def _open_maybe_compressed(path: str | os.PathLike) -> io.BufferedReader:
    path = os.fspath(path)
    with open(path, "rb") as probe:
        magic = probe.read(3)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, "rb")  # type: ignore[return-value]
    if magic == b"BZh":
        return bz2.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def iter_fastx(path: str | os.PathLike) -> Iterator[SeqRecord]:
    """Yield records from FASTA or FASTQ (auto-detected, compressed ok)."""
    fh = _open_maybe_compressed(path)
    try:
        first = fh.read(1)
        if not first:
            return
        if first == b">":
            yield from _iter_fasta(fh)
        elif first == b"@":
            yield from _iter_fastq(fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")
    finally:
        fh.close()


def _iter_fasta(fh) -> Iterator[SeqRecord]:
    # fh positioned just after the first '>'
    header = fh.readline().rstrip(b"\r\n")
    chunks: list[bytes] = []
    for line in fh:
        if line.startswith(b">"):
            yield SeqRecord(header.decode(), b"".join(chunks))
            header = line[1:].rstrip(b"\r\n")
            chunks = []
        else:
            chunks.append(line.strip())
    yield SeqRecord(header.decode(), b"".join(chunks))


def _iter_fastq(fh) -> Iterator[SeqRecord]:
    # fh positioned just after the first '@'.  Multi-line (wrapped)
    # sequence and quality blocks are supported, like seqan3's reader:
    # sequence lines run until the '+' separator, quality lines until
    # their accumulated length matches the sequence (quality lines may
    # legitimately START with '@' or '+', so they are counted by length,
    # never by marker).
    while True:
        header = fh.readline()
        if not header:
            return
        chunks: list[bytes] = []
        line = fh.readline()
        while line and not line.startswith(b"+"):
            chunks.append(line.strip())
            line = fh.readline()
        if not line:
            raise ValueError("malformed FASTQ: missing '+' line")
        seq = b"".join(chunks)
        qlen = 0
        while qlen < len(seq):
            qline = fh.readline()
            if not qline:
                raise ValueError("malformed FASTQ: truncated qualities")
            qlen += len(qline.strip())
        yield SeqRecord(header.rstrip(b"\r\n").decode(), seq)
        nxt = fh.read(1)
        if not nxt:
            return
        if nxt != b"@":
            raise ValueError("malformed FASTQ record separator")


def read_all(path: str | os.PathLike) -> list[SeqRecord]:
    return list(iter_fastx(path))


def iter_fastx_chunks(path: str | os.PathLike,
                      chunk_size: int = 1024) -> Iterator[list[SeqRecord]]:
    """Chunked reading, the reference's 1024-record batching
    (taxor_search.cpp:315)."""
    batch: list[SeqRecord] = []
    for rec in iter_fastx(path):
        batch.append(rec)
        if len(batch) == chunk_size:
            yield batch
            batch = []
    if batch:
        yield batch
