"""What one read longer than L_CAP costs on each device route, stage by
stage, on a flat and a hierarchical index, for a syncmer, a minimiser and
a plain k-mer scheme.

    python -m taxor_tpu_torch.tools.time_long_reads [--error-rate 0.04]

The data is ``chip_smoke.py``'s main-path recipe: GENOMES random genomes
of 30 kb (``synth.make_ref_set``), ``--layout flat`` (phase 4) and
``--layout auto --tmax 64`` (phase 7), and READS reads of each length of
READ_LENS (40 kb, and 750 kb for the reads of 0.5-1 Mb) cut from a genome
taken as circular, with ``--error-rate`` substitutions (at 4% about half
of such reads reach the syncmer model's threshold, so a hierarchy's
traversal may stop at the root; at 1% they descend).  Each scheme of
SCHEMES builds both indexes: k=22/s=12/t=5 syncmers (phases 4 and 7),
k = 20 minimisers of window 26 with ``--scaling 3`` (phase 13a's) and
k = 20 plain k-mers (phase 13b's).

Two routes, each called directly, the batch of reads at once:

  - ``host``: the host-hash route, the one reads past L_CAP took before
    the device took them whole (syncmers since the pieces came,
    minimisers and plain k-mers since K5 took rows of any length), and
    that reads of length 0 still take: ``schemes.search_hashes`` on one
    thread (``hash_s``), the thresholds, ``pack_hash_lists``
    (``pack_s``), the upload of hi/lo/valid (``upload_s``), then the probe
    through ``pipeline._device_dispatch`` and its collector: top-k on a
    flat index, the per-IXF ``counts`` traversal on a hierarchy
    (``probe_s``: the dispatch less its pack and upload, with the
    traversal's probe launches and host round trips, ``launches``);
  - ``fused``: the packing of the reads into their bucket (``pack_s``)
    and ``DeviceHIXF.e2e_async`` with its collector (``step_s``): K1 on
    the pieces of a syncmer read, K5 on a minimiser or plain k-mer read's
    whole bucket.

Each stage is the best of REPS passes (``time.perf_counter``; the device
is synchronised at each stage's end), in seconds for the batch and in
milliseconds a read.  One JSON line goes to stdout with nvidia-smi's
name and power limit.  ``chip_smoke.py`` phases 4b, 7c, 18b and 19 call
``host_route`` and ``fused_route`` on their own indexes.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from taxor_tpu_torch.apps.build import BuildConfig, run_build
from taxor_tpu_torch.device import launches as launch_counts
from taxor_tpu_torch.device.hixf_search import DeviceHIXF
from taxor_tpu_torch.device.probe import pack_hash_lists
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.hash import schemes
from taxor_tpu_torch.search import pipeline
from taxor_tpu_torch.search.thresholds import Thresholder, _scaling_ratio
from taxor_tpu_torch.tools import synth
from taxor_tpu_torch.tools.bench import card_line, log

GENOMES, GENOME_LEN = 4096, 30000
READS, READ_LENS = 16, (40000, 750000)
LAYOUTS = ("flat", "auto")
# scheme -> the build's scheme flags
SCHEMES = {"syncmer": dict(kmer_size=22, syncmer_size=12, use_syncmer=True),
           "minimizer": dict(kmer_size=20, window_size=26, scaling=3),
           "kmer": dict(kmer_size=20, window_size=20)}
REPS = 3
SEED = 20261018


def long_reads(rng, genomes: dict, n: int, read_len: int,
               error_rate: float) -> list[bytes]:
    """n reads of read_len bases from random genomes taken as circular,
    with error_rate substitutions."""
    accs = sorted(genomes)
    out = []
    for _ in range(n):
        seq = genomes[accs[int(rng.integers(0, len(accs)))]]
        full = seq * (read_len // len(seq) + 2)
        off = int(rng.integers(0, len(seq)))
        out.append(synth.mutate(rng, full[off:off + read_len], error_rate))
    return out


def host_route(dh, index, seqs, thresholder, dev) -> dict:
    """One pass of the host-hash route, stage by stage (seconds)."""
    scheme = index.scheme
    t0 = time.perf_counter()
    hash_lists = schemes.search_hashes(seqs, scheme)
    t1 = time.perf_counter()
    hcs = [h.shape[0] for h in hash_lists]
    thresholds = np.array(
        [min(thresholder.get(hc, _scaling_ratio(hc, len(s),
                                                scheme.kmer_size)), 2**62)
         for hc, s in zip(hcs, seqs)], dtype=np.int64)
    t2 = time.perf_counter()
    H = max(1, max(hcs))
    hi, lo, valid = pack_hash_lists(hash_lists, 1 << (H - 1).bit_length())
    t3 = time.perf_counter()
    for x in (hi, lo, valid):
        torch.from_numpy(x).to(dev)
    torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    before = launch_counts.read()
    kind, collect = pipeline._device_dispatch(dh, hash_lists, thresholds)
    res = collect()
    torch.cuda.synchronize(dev)
    t5 = time.perf_counter()
    ran = launch_counts.since(before)
    hits = ((res[0] >= 0).any(axis=1) if kind == "topk"
            else res[1].any(axis=1))
    return {"hash_s": t1 - t0, "threshold_s": t2 - t1, "pack_s": t3 - t2,
            "upload_s": t4 - t3,
            "probe_s": max(0.0, (t5 - t4) - (t3 - t2) - (t4 - t3)),
            "kind": kind, "launches": ran["K2"] + ran["K2n"],
            "hash_slots": int(H), "classified": int(hits.sum())}


def fused_route(dh, index, seqs, thresholder, dev) -> dict:
    """One pass of the fused route on the reads' bucket."""
    t0 = time.perf_counter()
    L = dsync.bucket_len(max(len(s) for s in seqs))
    packed, lengths = dsync.pack_reads(seqs, L)
    t1 = time.perf_counter()
    collect = dh.e2e_async(packed, lengths, index.scheme, thresholder)
    out = collect()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return {"pack_s": t1 - t0, "step_s": t2 - t1, "bucket_len": int(L),
            "hcap": int(out[4])}


def best(passes: list[dict]) -> dict:
    """Per key the least of the passes' seconds; other keys as the
    first pass has them."""
    out = dict(passes[0])
    for key in out:
        if key.endswith("_s"):
            out[key] = min(p[key] for p in passes)
    return out


def per_read_ms(rec: dict, n: int) -> dict:
    return {key[:-2] + "_ms_a_read": rec[key] * 1e3 / n
            for key in rec if key.endswith("_s")}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--error-rate", type=float, default=0.04)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    schemes.NUM_THREADS = 1  # host hashing: one core's time
    out = {"card": card_line(), "genomes": GENOMES, "reads": READS,
           "read_lens": list(READ_LENS), "error_rate": args.error_rate,
           "schemes": {}}
    with tempfile.TemporaryDirectory(prefix="time_long_reads_") as tmp:
        tsv, gdir, genomes = synth.make_ref_set(tmp, rng, GENOMES,
                                                GENOME_LEN)
        reads = {n: long_reads(rng, genomes, READS, n, args.error_rate)
                 for n in READ_LENS}
        for scheme, flags in SCHEMES.items():
            out["schemes"][scheme] = {}
            for layout in LAYOUTS:
                t0 = time.perf_counter()
                index = run_build(BuildConfig(
                    input_file=tsv, input_sequence_dir=gdir,
                    output_filename="", layout_mode=layout,
                    tmax=64 if layout == "auto" else 0, layout_file="",
                    threads=os.cpu_count() or 1, **flags))
                build_s = time.perf_counter() - t0
                sch = index.scheme
                thresholder = Thresholder.make(
                    kmer_size=sch.kmer_size, window_size=sch.window_size,
                    error_rate=0.04, percentage=-1.0,
                    use_syncmer=sch.use_syncmer)
                dh = DeviceHIXF.from_hixf(index.hixf, dev)
                rec = {"ixfs": len(index.hixf.ixfs), "build_s": build_s}
                for n, seqs in reads.items():
                    for name, route in (("host", host_route),
                                        ("fused", fused_route)):
                        r = best([route(dh, index, seqs, thresholder, dev)
                                  for _ in range(REPS)])
                        rec[f"{name}_{n}"] = {**r, **per_read_ms(r, READS)}
                log(f"{scheme} {layout}: {json.dumps(rec)}")
                out["schemes"][scheme][layout] = rec
                del dh, index
                torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
