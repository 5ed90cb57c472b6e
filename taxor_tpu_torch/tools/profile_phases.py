"""Phase breakdown of the flat fused search step on one CUDA GPU.

    python -m taxor_tpu_torch.tools.profile_phases [--device cuda]

The port of the JAX package's profile_phases.py, on the same problem
(``synth.build_problem()`` defaults: 256 genomes of 20 kb, 8,192 reads of
2 kb, a flat k=22/s=12 syncmer index), with the port's own phases, each
timed by ``tools/timing.rolled_ms`` on device-resident inputs:

  A   syncmer_track (the split engine's tracker kernel)
  B   syncmer_track + K3 dedup_fused
  F   K1 syncmer_hashes (extraction, dedup and wyhash: the production
      extraction)
  C   the probe (probe_counts) on K1's hashes: K2n for a table of at
      most 512 bins (this problem's [2418, 256]), K2 for a wider one;
      ``C_kernel`` names the kernel that launched (and K2's variant), read
      from the wrappers' launch counts, "plain twin" on the CPU
  C2  wyhash + probe positions of the sorted k-mers as tensor ops
  D   the full flat fused step (device/e2e.fused_e2e_step)

and unaccounted = D - F - C - C2.  K1 hashes and K2 computes the probe
positions inside the kernels, so C2 is work that F and C already hold:
the line D - F - C beside it is what the step spends outside its two
kernels (run sums, top-k, launches).  One line per phase goes to stderr,
then one JSON object of the milliseconds (and ``C_kernel``) to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from ..device import extract, probe, sort
from ..device.e2e import fused_e2e_step
from ..device.hixf_search import DeviceHIXF
from ..hash import device_syncmer as dsync
from ..io.fastx import read_all
from ..utils.u64 import probe_positions_and_fprint4, wyhash64
from . import synth
from .bench import build_index, log
from .timing import rolled_ms


def probe_kernel(fn) -> str:
    """Call fn() and name the probe kernel it launched, from the launch
    counts of k2_counts and k2n_counts before and after."""
    k2, k2n = probe.k2_counts, probe.k2n_counts
    before = k2.LAUNCHES, k2n.LAUNCHES, dict(k2.VARIANTS)
    fn()
    if k2n.LAUNCHES > before[1]:
        return "K2n"
    if k2.LAUNCHES > before[0]:
        grew = [v for v, n in k2.VARIANTS.items() if n > before[2].get(v, 0)]
        return f"K2 ({'+'.join(sorted(grew))})"
    return "plain twin"


def profile(device="cuda", problem: dict | None = None) -> dict:
    """{phase: ms per pass} on the build_problem(**problem) reads."""
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="taxor_phases_") as tmp:
        _, tsv, gdir, reads_file = synth.build_problem(**(problem or {}),
                                                       root=tmp)
        index = build_index(tsv, gdir)
        seqs = [r.seq for r in read_all(reads_file)]
    sch = index.scheme
    k, s, t = sch.kmer_size, sch.syncmer_size, sch.t_syncmer
    L = dsync.pad_len_bucket(max(len(x) for x in seqs))
    packed, lengths = dsync.pack_reads(seqs, L)
    pr = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    hcap = dsync.hash_cap(L, k, s, t)
    gap = dsync.emission_min_gap(k, s, t)
    R = packed.shape[0]
    dh = DeviceHIXF.from_hixf(index.hixf, dev)
    log(f"R={R} L={L} hcap={hcap} table {tuple(dh.table.shape)} on {dev}")
    ms = {}
    ms["A"] = rolled_ms(lambda p, l: extract.syncmer_track(p, l, k, s, t),
                        pr, ln)
    log(f"A syncmer_track          {ms['A']:9.4f} ms/pass")
    ms["B"] = rolled_ms(lambda p, l: sort.dedup_fused(
        *extract.syncmer_track(p, l, k, s, t), hcap, gap), pr, ln)
    log(f"B track + K3 dedup       {ms['B']:9.4f} ms/pass "
        f"(K3 ~{ms['B'] - ms['A']:.4f})")
    ms["F"] = rolled_ms(lambda p, l: extract.syncmer_hashes(
        p, l, k, s, t, hcap), pr, ln)
    log(f"F K1 extract+dedup+hash  {ms['F']:9.4f} ms/pass (production)")

    hi, lo, valid, _, _ = extract.syncmer_hashes(pr, ln, k, s, t, hcap)
    nvalid = int(valid.sum())
    ms["C_kernel"] = probe_kernel(lambda: probe.probe_counts(
        hi, lo, valid, dh.table, dh.seed, dh.block_length))
    ms["C"] = rolled_ms(lambda h, l, v: probe.probe_counts(
        h, l, v, dh.table, dh.seed, dh.block_length), hi, lo, valid)
    row_bytes = nvalid * 3 * dh.table.shape[1]
    log(f"C {ms['C_kernel']:22s}{ms['C']:9.4f} ms/pass ({nvalid} valid "
        f"hashes, {nvalid / R:.0f}/read; {row_bytes / ms['C'] / 1e6:.1f} "
        f"GB/s of table rows)")
    srt, _, _, _ = sort.dedup_fused(*extract.syncmer_track(pr, ln, k, s, t),
                                    hcap, gap)
    ms["C2"] = rolled_ms(lambda x: probe_positions_and_fprint4(
        wyhash64(x), dh.seed, dh.block_length), srt)
    log(f"C2 wyhash + positions    {ms['C2']:9.4f} ms/pass (tensor ops)")
    ms["D"] = rolled_ms(lambda p, l: fused_e2e_step(
        dh.table, p, l, dh.run_offsets, dh.run_users, dh.seed,
        dh.block_length, k=k, s=s, t=t, hcap=hcap, topk=16,
        prefix_runs=dh.prefix_runs), pr, ln)
    log(f"D full fused step        {ms['D']:9.4f} ms/pass "
        f"({R / ms['D'] * 1e3:.0f} reads/s)")
    ms["unaccounted"] = ms["D"] - ms["F"] - ms["C"] - ms["C2"]
    ms["outside_kernels"] = ms["D"] - ms["F"] - ms["C"]
    log(f"unaccounted (D-F-C-C2)   {ms['unaccounted']:9.4f} ms")
    log(f"outside K1, K2 (D-F-C)   {ms['outside_kernels']:9.4f} ms")
    ms["reads"], ms["L"], ms["valid_hashes"] = R, L, nvalid
    return ms


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    print(json.dumps(profile(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
