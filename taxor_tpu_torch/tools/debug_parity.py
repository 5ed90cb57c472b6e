"""Repros of a device-vs-host divergence of the fused search.

    python -m taxor_tpu_torch.tools.debug_parity [diff|localize]
        [--read R] [--reads N] [--device cuda|cpu]

The port of the JAX package's tools/debug_parity.py and
tools/debug_parity2.py, the repros of the QHASH_MATCH off-by-one its
bench parity gate once found (read_len 1,000, syncmers): both build the
bench's problem (``tools/synth.build_problem``: 32 species of 8 kb, 256
reads of 1 kb, seed 7) under k = 22, s = 12 syncmers on a flat index.

  diff      ``diff_hashes`` (debug_parity.py): each read's best count
            from the fused step (``DeviceHIXF.e2e_async``) against the
            host oracle's (``HIXF.membership``), then one read's hash
            set from the device against the host's (``search_hashes``)
            under both extraction engines (``device/e2e.USE_FUSED_EXTRACT``
            True: K1; False: syncmer_track, K3, wyhash as tensor ops);
  localize  ``localize`` (debug_parity2.py): one read's emissions from
            the device's tracker (``extract.syncmer_track``) against the
            host's scalar scan (``hash/syncmer.syncmer_emissions_scalar``),
            the first position where they differ and the canonical s-mers
            of its window, with the ends of the window's minimum.

Each prints one JSON line; exit code 1 when it finds a difference.  On
the CPU the device functions are their plain twins.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

K, S = 22, 12  # the scheme of the JAX repros


def problem(root: str | None = None):
    """(index, read sequences) of the repros' flat index and reads."""
    from ..apps.build import BuildConfig, run_build
    from ..io.fastx import read_all
    from . import synth

    _, tsv, gdir, reads = synth.build_problem(
        n_species=32, genome_len=8000, n_reads=256, read_len=1000, seed=7,
        root=root)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=K, syncmer_size=S, use_syncmer=True, layout_mode="flat",
        layout_file="", threads=8))
    return index, [r.seq for r in read_all(reads)]


def _device(device: str):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return dev


def diff_hashes(index, seqs: list[bytes], device: str = "cuda",
                n_reads: int = 8, read: int = 1) -> dict:
    """Per read of the first n_reads: host and device best counts and
    unique hashes, and the reads whose best counts differ; then read
    ``read``'s device hash set against the host's under both extraction
    engines (hashes only on one side, as hex, at most 5 each)."""
    import torch

    from ..device import e2e
    from ..device.hixf_search import DeviceHIXF
    from ..hash import device_syncmer as dsync
    from ..hash.schemes import search_hashes
    from ..search.thresholds import Thresholder

    dev = _device(device)
    scheme = index.scheme
    th = Thresholder.make(scheme.kmer_size, scheme.window_size, 0.04, -1.0,
                          scheme.use_syncmer)
    seqs = seqs[:n_reads]
    L = dsync.pad_len_bucket(max(len(s) for s in seqs))
    packed, lengths = dsync.pack_reads(seqs, L)
    hcap = dsync.hash_cap(L, scheme.kmer_size, scheme.syncmer_size,
                          scheme.t_syncmer)
    dh = DeviceHIXF.from_hixf(index.hixf, dev)
    vals, _, counts, n_emit, _, _ = dh.e2e_async(packed, lengths, scheme,
                                                th, k=16)()
    reads = []
    for r, seq in enumerate(seqs):
        hl = search_hashes([seq], scheme)[0]
        host_best = max((c for _, c in index.hixf.membership(hl, 1)),
                        default=0)
        reads.append(dict(read=r, host_unique=int(hl.shape[0]),
                          dev_unique=int(counts[r]), n_emit=int(n_emit[r]),
                          host_best=int(host_best),
                          dev_best=int(vals[r, 0])))
    out = dict(L=L, hcap=hcap, reads=reads, mismatch=[
        x["read"] for x in reads
        if (x["host_best"], x["host_unique"])
        != (x["dev_best"], x["dev_unique"])], engines={})
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    host_h = np.unique(search_hashes([seqs[read]], scheme)[0])
    saved = e2e.USE_FUSED_EXTRACT
    try:
        for fused in (True, False):
            e2e.USE_FUSED_EXTRACT = fused
            hi, lo, valid, _, _ = e2e._syncmer_hashes(
                pk, ln, scheme.kmer_size, scheme.syncmer_size,
                scheme.t_syncmer, hcap)
            v = valid[read].cpu().numpy()
            whi = hi[read].cpu().numpy().view(np.uint32).astype(np.uint64)
            wlo = lo[read].cpu().numpy().view(np.uint32).astype(np.uint64)
            dev_h = np.unique(((whi << np.uint64(32)) | wlo)[v])
            out["engines"]["K1" if fused else "split"] = dict(
                host=int(host_h.shape[0]), device=int(dev_h.shape[0]),
                only_host=[hex(int(x)) for x in
                           np.setdiff1d(host_h, dev_h)[:5]],
                only_dev=[hex(int(x)) for x in
                          np.setdiff1d(dev_h, host_h)[:5]])
    finally:
        e2e.USE_FUSED_EXTRACT = saved
    out["equal"] = not out["mismatch"] and not any(
        e["only_host"] or e["only_dev"] for e in out["engines"].values())
    return out


def _codes(seq: bytes) -> np.ndarray:
    table = np.full(256, 4, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        table[b] = table[b + 32] = i
    return table[np.frombuffer(seq, dtype=np.uint8)]


def smer_window(codes: np.ndarray, end: int, k: int, s: int) -> dict:
    """The canonical s-mers (min of both strands' 2-bit values) ending at
    end - k + s .. end, the window of the k-mer ending at ``end``, and
    the ends of its minimum (None where an s-mer holds an N)."""
    vals = {}
    for e in range(end - k + s, end + 1):
        c = codes[e - s + 1:e + 1].astype(np.int64)
        if (c > 3).any():
            vals[e] = None
            continue
        fwd = rev = 0
        for j, x in enumerate(c):
            fwd = fwd << 2 | int(x)
            rev |= (3 - int(x)) << (2 * j)
        vals[e] = min(fwd, rev)
    known = [v for v in vals.values() if v is not None]
    mn = min(known) if known else None
    return dict(smers={str(e): v for e, v in vals.items()},
                min_ends=[e for e, v in vals.items() if v == mn])


def localize(seq: bytes, device: str = "cuda", k: int = K,
             s: int = S) -> dict:
    """The device tracker's emissions of one read against the host's
    scalar scan: their counts, the first end position where they differ
    (emission or k-mer) and its s-mer window; ``first`` None when none
    differs."""
    import torch

    from ..device import extract
    from ..hash import device_syncmer as dsync
    from ..hash.syncmer import syncmer_emissions_scalar, t_syncmer_default

    dev = _device(device)
    t = t_syncmer_default(k, s)
    codes = _codes(seq)
    host = dict(syncmer_emissions_scalar(codes, k, s, t))
    L = dsync.pad_len_bucket(len(seq))
    packed, lengths = dsync.pack_reads([seq], L)
    kmer, emit = extract.syncmer_track(
        torch.from_numpy(packed).to(dev),
        torch.from_numpy(lengths.astype(np.int32)).to(dev), k, s, t)
    kmer, emit = kmer[0].cpu().numpy(), emit[0].cpu().numpy()
    device_em = {int(i): int(kmer[i]) for i in np.flatnonzero(emit)}
    diff = sorted(i for i in set(host) | set(device_em)
                  if host.get(i) != device_em.get(i))
    out = dict(length=len(seq), host_emissions=len(host),
               device_emissions=len(device_em), differing=len(diff),
               first=None)
    if diff:
        i = diff[0]
        out["first"] = dict(end=i, host=host.get(i), device=device_em.get(i),
                            t_end=i - k + t + s - 1,
                            **smer_window(codes, i, k, s))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", nargs="?", default="diff",
                    choices=("diff", "localize"))
    ap.add_argument("--read", type=int, default=1,
                    help="the read looked into (default 1, as the JAX "
                         "repros)")
    ap.add_argument("--reads", type=int, default=8,
                    help="reads compared by diff (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    index, seqs = problem()
    if args.what == "diff":
        out = diff_hashes(index, seqs, args.device, args.reads, args.read)
        ok = out["equal"]
    else:
        out = localize(seqs[args.read], args.device)
        ok = out["first"] is None
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
