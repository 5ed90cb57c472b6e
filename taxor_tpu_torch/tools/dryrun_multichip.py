"""One sharded count step and one sharded fused step on tiny shapes over a
world of n ranks, each held equal to the single-device step.

    python -m taxor_tpu_torch.tools.dryrun_multichip [--ranks 4]
        [--device cuda|cpu]

The port of ``__graft_entry__.dryrun_multichip``: a reads x bins mesh
over the ranks (2 reads rows and n/2 bins shards from 4 ranks up, else
one row), then

  - the count step (``sharding.sharded_search_step_fn``): random hashes
    against a random uint8 table of 600 bins a shard, probed shard by
    shard, the columns gathered over the row, the run sums and the
    threshold compare, against ``probe.probe_counts`` on the whole table;
  - the flat fused step (``sharding.sharded_e2e_fn``): extraction (K1),
    the row gather, the shard probe, the run sums added over the row and
    the top-k, against ``e2e.fused_e2e_step`` on the whole table.

This process starts the n ranks on this host (``--rank`` is the rank's
own entry), with a tcp rendezvous on a free local port.  On the card
every rank takes ``cuda:(rank % device count)``: ranks that share a card
run their collectives on gloo (``distributed.collective_backend``).  One
JSON line goes to stdout: the world, the mesh, the backend and each
step's equality; exit code 1 when a rank fails or a step differs.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

SEED = 116


def tiny_problem(nb: int, R: int, L: int = 256):
    """A random table [S, 600 nb] (a few zero bytes a column), R packed
    random reads of up to L bases, random (hi, lo, valid) [R, 64], run
    offsets of runs of 1-3 bins and thresholds."""
    from ..hash import device_syncmer as dsync

    rng = np.random.default_rng(SEED)
    B, bl = 600 * nb, 128
    table = rng.integers(0, 256, (3 * bl, B), dtype=np.uint8)
    table[rng.random(table.shape) < 0.3] = 0
    hi, lo = (rng.integers(-2**31, 2**31, (R, 64), dtype=np.int64).astype(
        np.int32) for _ in range(2))
    valid = rng.random((R, 64)) < 0.8
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [acgt[rng.integers(0, 4, int(n))].tobytes()
            for n in rng.integers(L // 2, L + 1, R)]
    packed, lengths = dsync.pack_reads(seqs, L)
    widths = rng.integers(1, 4, B)
    offsets = np.concatenate([[0], np.cumsum(widths)])
    offsets = offsets[offsets < B]
    offsets = np.append(offsets, B)
    thresholds = rng.integers(0, 8, R).astype(np.int32)
    return dict(table=table, bl=bl, seed=int(rng.integers(0, 2**63)), hi=hi,
                lo=lo, valid=valid, packed=packed, lengths=lengths,
                offsets=offsets.astype(np.int64), thresholds=thresholds,
                L=L)


def mesh_shape(n: int) -> tuple[int, int]:
    """(reads rows, bins shards) of the dry run over n ranks."""
    return (2, n // 2) if n >= 4 else (1, n)


def run_rank(mesh) -> dict:
    """Both steps on this rank of ``mesh``; {step: equal to the single
    device}.  Every rank of the mesh must call it."""
    import torch

    from ..device import sharding
    from ..device.e2e import fused_e2e_step, run_sums
    from ..device.probe import pad_fingerprints, probe_counts
    from ..hash import device_syncmer as dsync

    dev = mesh.device
    p = tiny_problem(mesh.nb, R=8 * mesh.nr * mesh.nb)
    full = torch.from_numpy(pad_fingerprints(p["table"])).to(dev)
    table = sharding.shard_ixf(mesh, p["table"])
    hi, lo, valid, thr = (torch.from_numpy(p[x]).to(dev)
                          for x in ("hi", "lo", "valid", "thresholds"))
    offsets = torch.from_numpy(p["offsets"]).to(dev)
    B = p["table"].shape[1]

    sums, emitted = sharding.sharded_search_step_fn(mesh)(
        table, hi, lo, valid, p["seed"], p["bl"], offsets, thr)
    sums, emitted = (sharding.host_view(x, mesh) for x in (sums, emitted))
    want = run_sums(probe_counts(hi, lo, valid, full, p["seed"], p["bl"])
                    [:, :B], offsets).cpu().numpy()
    count_ok = (np.array_equal(sums, want)
                and np.array_equal(emitted, want >= p["thresholds"][:, None]))

    k, s, t, topk = 16, 8, 4, 8
    hcap = dsync.hash_cap(p["L"])
    n_runs = p["offsets"].shape[0] - 1
    users = torch.arange(n_runs, dtype=torch.int32, device=dev)
    packed = torch.from_numpy(p["packed"]).to(dev)
    lengths = torch.from_numpy(p["lengths"]).to(dev)
    local = torch.from_numpy(sharding.shard_runs(
        mesh, table.shape[1], p["offsets"])[0]).to(dev)
    got = sharding.host_view(sharding.sharded_e2e_fn(
        mesh, k=k, s=s, t=t, hcap=hcap, topk=topk)(
        table, packed, lengths, local, users, p["seed"], p["bl"]), mesh)
    want = fused_e2e_step(full, packed, lengths, offsets, users, p["seed"],
                          p["bl"], k=k, s=s, t=t, hcap=hcap,
                          topk=topk).cpu().numpy()
    fused_ok = got.shape == (packed.shape[0], 2 * topk + 2) and \
        np.array_equal(got, want) and bool((got[:, 0] > 0).any())
    return {"count_step": bool(count_ok), "fused_step": bool(fused_ok)}


def _rank_main(rank: int, n: int, port: int, device: str) -> int:
    import torch

    from ..device.distributed import initialize, make_mesh, shutdown

    torch.set_num_threads(1)
    dev = initialize(f"127.0.0.1:{port}", n, rank, device)
    try:
        mesh = make_mesh(*mesh_shape(n), dev)
        out = run_rank(mesh) if mesh.member else {}
        if rank == 0:
            print(json.dumps({"mesh": mesh.describe(), **out}), flush=True)
        return 0 if all(out.values()) else 1
    finally:
        shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # a rank's own entry
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.ranks, args.port, args.device)
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("dryrun_multichip: no CUDA device (--device cpu runs the "
                  "plain twins)", file=sys.stderr)
            return 2
    port = free_port()
    # the ranks import this checkout's package wherever they start
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "taxor_tpu_torch.tools.dryrun_multichip",
         "--ranks", str(args.ranks), "--device", args.device, "--rank",
         str(r), "--port", str(port)], stdout=subprocess.PIPE, text=True,
        env=env) for r in range(args.ranks)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    res = json.loads(outs[0].strip().splitlines()[-1]) if rcs[0] == 0 \
        and outs[0].strip() else {}
    print(json.dumps({"ranks": args.ranks, "device": args.device,
                      "rcs": rcs, **res,
                      "seconds": time.perf_counter() - t0}))
    return 0 if not any(rcs) and res else 1


if __name__ == "__main__":
    sys.exit(main())
