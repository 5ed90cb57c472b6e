"""TaxorIndex: scheme params + species table + HIXF, with an npz-based
on-disk format (replaces the reference's cereal archive,
src/main/index.hpp:26-244, store_index.hpp, load_index.hpp).

Layout of the ``.taxor.npz`` file:
  meta.json  (stored as a uint8 array) — params, filenames, species table
  ixf{i}_fp  uint8 [slots, bins] fingerprint array of IXF i
  next{i}    int64 [bins]
  b2u{i}     int64 [bins]
Scheme parameters travel inside the index and override CLI values at
search time (taxor_search.cpp:164-171).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np

from ..hash.schemes import HashScheme
from ..io.taxonomy import Species
from ..ixf.xor_filter import IXF
from .container import HIXF

INDEX_VERSION = 1


@dataclass
class TaxorIndex:
    scheme: HashScheme
    species: list[Species]
    hixf: HIXF
    parts: int = 1
    compressed: bool = False
    # search-time hint: starting top-k candidate width for the device
    # emission compaction, pre-seeded at build time from reference
    # homology (near-identical user bins produce co-equal counts that
    # overflow a 16-wide top-k and force per-batch escalation
    # recompiles; the index knows its own homology from the bottom-m
    # hash sketches — apps/build._suggest_topk)
    suggested_topk: int = 16

    def user_bin_to_species(self) -> dict[int, int]:
        """user bin id -> index into species list
        (taxor_search.cpp:172-178)."""
        return {sp.user_bin: i for i, sp in enumerate(self.species)}


def save_index(path: str, index: TaxorIndex) -> None:
    meta = {
        "version": INDEX_VERSION,
        "scheme": asdict(index.scheme),
        "parts": index.parts,
        "compressed": index.compressed,
        "species": [asdict(sp) for sp in index.species],
        "user_bin_filenames": index.hixf.user_bin_filenames,
        "ixf_seeds": [ixf.seed for ixf in index.hixf.ixfs],
        "ixf_block_lengths": [ixf.block_length for ixf in index.hixf.ixfs],
        "suggested_topk": index.suggested_topk,
    }
    arrays: dict[str, np.ndarray] = {
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    }
    for i, ixf in enumerate(index.hixf.ixfs):
        arrays[f"ixf{i}_fp"] = ixf.fingerprints
        arrays[f"next{i}"] = index.hixf.next_ixf_id[i]
        arrays[f"b2u{i}"] = index.hixf.bin_to_user[i]
    # uncompressed: XOR-filter fingerprints are high-entropy, so zlib
    # saves little space and multiplies the load time.  np.load reads
    # either container, so old compressed indexes keep working.
    np.savez(path, **arrays)


def load_index(path: str) -> TaxorIndex:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    if meta["version"] != INDEX_VERSION:
        raise ValueError(
            f"Unsupported index version {meta['version']} "
            f"(expected {INDEX_VERSION})"
        )
    n_ixfs = len(meta["ixf_seeds"])
    ixfs = []
    next_ixf_id = []
    bin_to_user = []
    for i in range(n_ixfs):
        ixfs.append(
            IXF(
                fingerprints=data[f"ixf{i}_fp"],
                block_length=int(meta["ixf_block_lengths"][i]),
                seed=int(meta["ixf_seeds"][i]),
            )
        )
        next_ixf_id.append(data[f"next{i}"])
        bin_to_user.append(data[f"b2u{i}"])
    hixf = HIXF(
        ixfs=ixfs,
        next_ixf_id=next_ixf_id,
        bin_to_user=bin_to_user,
        user_bin_filenames=list(meta["user_bin_filenames"]),
    )
    species = [Species(**sp) for sp in meta["species"]]
    return TaxorIndex(
        scheme=HashScheme(**meta["scheme"]),
        species=species,
        hixf=hixf,
        parts=int(meta["parts"]),
        compressed=bool(meta["compressed"]),
        suggested_topk=int(meta.get("suggested_topk", 16)),
    )
