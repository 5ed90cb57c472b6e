"""A world of gloo ranks on the CPU for the port's sharded tests.

``run_world(n, cases, meshes, out)`` starts n rank processes of this
module (one torch thread each), which join one world, build each reads
x bins mesh of ``meshes`` in turn (every rank creates every group) and
run every case on it; each rank of a mesh writes a case's result to
``out/<case>-<nr>x<nb>-rank<k>.npz``.  A case is a dict: its ``kind``
names the function of ``KINDS`` that runs it, ``name`` its files, the
rest are its arguments (paths to an index, to an .npz of inputs, ...);
``meshes`` restricts it to some meshes.  One world serves a whole test
module: a 4-rank world starts in a few seconds here, a test needs only
read the files.

The ranks import neither JAX nor the JAX package: the tests compare
their files with the JAX package in the pytest process.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

from taxor_tpu_torch.tools.dryrun_multichip import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(n: int, cases: list, meshes, out: str,
              timeout: float = 600) -> None:
    """Run ``cases`` on every mesh of ``meshes`` in a world of n ranks;
    raises with the rank's output when one fails."""
    os.makedirs(out, exist_ok=True)
    job = os.path.join(out, "job.json")
    with open(job, "w") as fh:
        json.dump({"world": n, "cases": cases,
                   "meshes": [list(m) for m in meshes], "out": out}, fh)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_world", job, str(r), str(port)],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    text = []
    for r, fh in enumerate(logs):
        fh.seek(0)
        text.append(f"--- rank {r} (rc {procs[r].returncode})\n"
                    + fh.read()[-4000:])
        fh.close()
    if bad:
        raise AssertionError("ranks failed: " + "\n".join(text))


def results(out: str, name: str, mesh) -> list[dict]:
    """The case's result files of every rank of ``mesh``, rank order."""
    nr, nb = mesh
    pre = f"{name}-{nr}x{nb}-rank"
    files = sorted((f for f in os.listdir(out) if f.startswith(pre)),
                   key=lambda f: int(f[len(pre):-4]))
    assert len(files) == nr * nb, (name, mesh, files)
    return [dict(np.load(os.path.join(out, f))) for f in files]


def agreed(out: str, name: str, mesh) -> dict:
    """The case's result, checked equal on every rank of ``mesh`` (each
    holds the whole batch)."""
    res = results(out, name, mesh)
    for other in res[1:]:
        assert other.keys() == res[0].keys()
        for key in res[0]:
            np.testing.assert_array_equal(other[key], res[0][key],
                                          err_msg=f"{name} {mesh} {key}")
    return res[0]


# ------------------------------------------------------------ the ranks --
_INDEXES: dict = {}


def _index(path: str):
    from taxor_tpu_torch.hixf.index import load_index

    if path not in _INDEXES:
        _INDEXES[path] = load_index(path)
    return _INDEXES[path]


def _thresholder(index, percentage):
    from taxor_tpu_torch.search.thresholds import Thresholder

    if percentage is None:
        return None
    s = index.scheme
    return Thresholder.make(s.kmer_size, s.window_size, 0.04, percentage,
                            s.use_syncmer)


def kind_e2e(mesh, case) -> dict:
    """DeviceHIXF.e2e_async under the mesh on the packed reads."""
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF

    index = _index(case["index"])
    inp = np.load(case["reads"])
    dh = DeviceHIXF(index.hixf, mesh.device, mesh)
    vals, users, counts, n_emit, hcap, sums = dh.e2e_async(
        inp["packed"], inp["lengths"], index.scheme,
        _thresholder(index, case.get("percentage")), k=case.get("topk", 16))()
    out = dict(vals=vals, users=users, counts=counts, n_emit=n_emit,
               hcap=np.int64(hcap))
    if sums is not None:
        out["sums"] = sums
    return out


def kind_flat_step(mesh, case) -> dict:
    """sharding.sharded_e2e_fn on the shard of a flat index, as the
    JAX test drives ``sharded_e2e_fn``: the whole batch padded to the
    mesh."""
    import torch

    from taxor_tpu_torch.device import sharding
    from taxor_tpu_torch.device.hixf_search import _scale_thresh
    from taxor_tpu_torch.device.probe import pad_fingerprints
    from taxor_tpu_torch.hash import device_syncmer as dsync

    index = _index(case["index"])
    scheme, ixf = index.scheme, index.hixf.ixfs[0]
    inp = np.load(case["reads"])
    packed, lengths = inp["packed"], inp["lengths"]
    rpad = -packed.shape[0] % (mesh.nr * mesh.nb)
    packed = np.pad(packed, ((0, rpad), (0, 0)))
    lengths = np.pad(lengths, (0, rpad))
    table = sharding.shard_ixf(mesh, pad_fingerprints(ixf.fingerprints))
    starts, ends, users = index.hixf.runs_of_ixf(0)
    offsets = sharding.shard_runs(mesh, table.shape[1],
                                  np.append(starts, ends[-1]))[0]
    L = packed.shape[1] * 4
    step = sharding.sharded_e2e_fn(
        mesh, k=scheme.kmer_size, s=scheme.syncmer_size, t=scheme.t_syncmer,
        hcap=dsync.hash_cap(L) if scheme.use_syncmer else L, topk=16,
        scheme_kind="syncmer" if scheme.use_syncmer else "minimizer",
        window=scheme.window_size, scale_thresh=_scale_thresh(scheme))
    dev = mesh.device
    got = step(table, torch.from_numpy(packed).to(dev),
               torch.from_numpy(lengths).to(dev),
               torch.from_numpy(offsets).to(dev),
               torch.from_numpy(users.astype(np.int32)).to(dev),
               int(ixf.seed), int(ixf.block_length))
    return {"packed": sharding.host_view(got, mesh)}


def kind_counts(mesh, case) -> dict:
    """DeviceHIXF.counts under the mesh on host-extracted hashes."""
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF

    index = _index(case["index"])
    inp = np.load(case["hashes"])
    dh = DeviceHIXF(index.hixf, mesh.device, mesh)
    counts, emitted = dh.counts(inp["hi"], inp["lo"], inp["valid"],
                                inp["thresholds"])
    return dict(counts=counts, emitted=emitted)


def kind_search(mesh, case) -> dict:
    """search_single with the sharded engine's DeviceHIXF: the TSV text
    and the routes its reads took."""
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.search import pipeline

    index = _index(case["index"])
    config = pipeline.SearchConfig(
        index_file=case["index"], query_file=case["query"],
        engine="sharded", percentage=case.get("percentage", -1.0))
    dh = DeviceHIXF(index.hixf, mesh.device, mesh)
    buf = io.StringIO()
    pipeline.ROUTES.reset()
    pipeline.search_single(index, case["query"], buf, config, dh)
    routes = dict(pipeline.ROUTES.counts)
    return {"tsv": np.array(buf.getvalue()),
            **{f"route_{k}": np.int64(v) for k, v in routes.items()}}


def kind_search_step(mesh, case) -> dict:
    """sharding.sharded_count_fn and sharded_search_step_fn on a shard
    of the problem's table."""
    import torch

    from taxor_tpu_torch.device import sharding

    p = np.load(case["problem"])
    dev = mesh.device
    table = sharding.shard_ixf(mesh, p["table"])
    hi, lo, valid, thr, offsets = (torch.from_numpy(p[x]).to(dev) for x in (
        "hi", "lo", "valid", "thresholds", "run_offsets"))
    seed, bl = int(p["seed"]), int(p["block_length"])
    counts = sharding.sharded_count_fn(mesh)(table, hi, lo, valid, seed, bl)
    sums, emitted = sharding.sharded_search_step_fn(mesh)(
        table, hi, lo, valid, seed, bl, offsets, thr)
    return {"counts": sharding.host_view(counts, mesh),
            "sums": sharding.host_view(sums, mesh),
            "emitted": sharding.host_view(emitted, mesh)}


def kind_dryrun(mesh, case) -> dict:
    """The port of ``__graft_entry__.dryrun_multichip`` on this mesh."""
    from taxor_tpu_torch.tools.dryrun_multichip import run_rank

    return {k: np.bool_(v) for k, v in run_rank(mesh).items()}


def kind_layout(mesh, case) -> dict:
    """This rank's cell in global_mesh(2, 2), make_mesh(2, 2) and the
    default global_mesh (every rank of the world must run it)."""
    from taxor_tpu_torch.device.distributed import global_mesh, make_mesh

    g = global_mesh(2, 2, mesh.device)
    m = make_mesh(2, 2, mesh.device)
    d = global_mesh(device=mesh.device)
    return {"global": np.array([g.r, g.b]), "make": np.array([m.r, m.b]),
            "global_default": np.array([d.nr, d.nb, d.r, d.b])}


KINDS = {"e2e": kind_e2e, "flat_step": kind_flat_step,
         "counts": kind_counts, "search": kind_search,
         "search_step": kind_search_step, "dryrun": kind_dryrun,
         "layout": kind_layout}


def main(job_file: str, rank: int, port: int) -> int:
    import torch

    from taxor_tpu_torch.device.distributed import (initialize, make_mesh,
                                                    shutdown)

    torch.set_num_threads(1)
    with open(job_file) as fh:
        job = json.load(fh)
    dev = initialize(f"127.0.0.1:{port}", job["world"], rank, "cpu")
    try:
        for nr, nb in job["meshes"]:
            mesh = make_mesh(nr, nb, dev)
            for case in job["cases"]:
                if not mesh.member or [nr, nb] not in case.get(
                        "meshes", job["meshes"]):
                    continue
                res = KINDS[case["kind"]](mesh, case)
                np.savez(os.path.join(
                    job["out"], f"{case['name']}-{nr}x{nb}-rank{rank}.npz"),
                    **res)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
    except Exception:  # the parent reads the log and stops the others
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
