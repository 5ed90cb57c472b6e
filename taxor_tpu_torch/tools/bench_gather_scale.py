"""The probe routes timed at the shapes the layout cost model needs, each
held to its plain twin first; the fit of ``hixf/device_cost.py``.

    python -m taxor_tpu_torch.tools.bench_gather_scale [--shapes a,b|all|
        sweep|thin|tiny] [--device cuda]

The port of the JAX package's bench_gather_scale.py, which timed the XLA
gather probe at root-class tables (R = 2,048 reads of H = 192 hashes,
[2^20, 64], [2^23, 64] and [2^23, 256] uint8 tables with positions in
the three blocks of the filter) to give the TPU layout model its ns/hash.
Here each shape goes through the port's own routes: K2's rows route
(``probe.k2_counts(variant="rows")``) and slab route (its slabs of 16
bins or more, ``k2_slab``, and its thin slabs, ``k2_thin``), K2n's rows
and smem modes (``probe.k2n_counts`` / ``k2n_run_sums`` with ``mode=``), the
probe of an empty descent group as the descent calls it, and one step of
``device/e2e.descend`` over an empty group.  Keys are uniform random, so
the kernels' positions fall in the three blocks as the JAX tool drew
them; the first ``nvalid`` slots of a read are valid.

Default shapes (``DEFAULT``): the JAX tool's [2^20, 64] and [2^23, 64]
(the [2^23, 256] table, 2 GiB, is ``jax_2^23x256``), the flat cell's
[3,606, 4,096] table (K2's slab route and its rows route), chip_smoke
phase 13b's [39,621, 1,024] plain k-mer table with its batch's 5,712
valid hashes a read of H = 8,192 (a thin slab of 4 bins), the widest
syncmer descent group's stack [474, 216, 512] (K2n smem run sums) with a
descent's sparse mask (293 active pairs) and with every pair active (the
descend-all mode), the [8, 10,524, 512] level (K2n rows run sums, each
read active in one subgroup), and an empty [8, 216, 512] group: its
probe a call and its whole descent step.  ``sweep`` adds the shapes the
coefficients were fitted on (widths 16-16,384, tables in and past the L2,
sparse and full masks); ``all`` is every named shape; ``thin`` the
thin slabs' default shape and their fit's shapes.

Each route is held bit-exact to ``probe_counts_grouped_plain`` /
``probe_run_sums_grouped_plain`` (the descent step to ``descend`` on the
CPU), then timed with ``tools/timing.rolled_ms`` (a call) and
``tools/time_sort.device_ms`` (the device alone).  One JSON line goes to
stdout: nvidia-smi's name and power limit, and per shape and route the
ms, device ms, ns a valid hash of an active pair, GB/s of rows (3 rows x
Bpad bytes a hash), and the model's prediction of the call
(``device_cost``: the larger of the modelled device time and the
host's floor, ``host_bound`` where the floor is larger, such calls
timed as means of 200) with the measured-over-model ratio; exit
code 1 when a route differs from its twin.  ``--fit`` adds the least
squares fit of device_cost's coefficients to the run's device times
(``fit_coefficients``: how the frozen ones were made, from ``--shapes
all``; ``--fit-only k2_thin`` fits that route's alone, the others held
as they are, from ``--shapes thin``).  With ``--device cpu`` every
route is the twin (a check of the tool, no device time); there is no
fallback to the CPU when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from taxor_tpu_torch.device import e2e, probe
from taxor_tpu_torch.hixf import device_cost
from taxor_tpu_torch.tools.bench import card_line, log
from taxor_tpu_torch.tools.timing import rolled_ms

JAX_R, JAX_H = 2048, 192  # bench_gather_scale.py :31


@dataclass(frozen=True)
class Shape:
    """A probe launch to time: tables [G, S, bins (padded to 16)], R reads
    of H slots with nvalid valid; active "all", "none", "one" (each read
    in one subgroup, the descent's) or a count of random active pairs;
    runs: K2n and the probe call take the descent's run sums (runs of 4
    bins) instead of dense counts (K2 always writes dense counts)."""

    routes: tuple
    G: int
    S: int
    bins: int
    R: int = 512
    H: int = 1024
    nvalid: int = 500
    active: object = "all"
    runs: bool = False


SHAPES = {
    "jax_2^20x64": Shape(("k2_rows", "k2n_rows"), 1, 1 << 20, 64, JAX_R,
                         JAX_H, JAX_H),
    "jax_2^23x64": Shape(("k2_rows", "k2n_rows"), 1, 1 << 23, 64, JAX_R,
                         JAX_H, JAX_H),
    "jax_2^23x256": Shape(("k2_rows", "k2n_rows"), 1, 1 << 23, 256, JAX_R,
                          JAX_H, JAX_H),
    "slab_3606x4096": Shape(("k2_slab", "k2_rows"), 1, 3606, 4096),
    "thin_39621x1024": Shape(("k2_thin",), 1, 39621, 1024, H=8192,
                             nvalid=5712),
    "smem_474x216x512_sparse": Shape(("k2n_smem",), 474, 216, 512,
                                     active=293, runs=True),
    "smem_474x216x512_all": Shape(("k2n_smem",), 474, 216, 512, runs=True),
    "rows_8x10524x512": Shape(("k2n_rows",), 8, 10524, 512, active="one",
                              runs=True),
    "empty_group": Shape(("call", "descent"), 8, 216, 512, active="none",
                         runs=True),
    "tiny": Shape(("k2_rows", "k2n_rows", "call", "descent"), 2, 300, 64, 8,
                  32, 20, active="one", runs=True),
}
DEFAULT = ("jax_2^20x64", "jax_2^23x64", "slab_3606x4096",
           "thin_39621x1024",
           "smem_474x216x512_sparse", "smem_474x216x512_all",
           "rows_8x10524x512", "empty_group")


def _sweep() -> dict:
    """The fit's shapes: K2n rows at 16-512 bins in and past the L2, its
    pair cost on sparse and empty stacks; K2n smem at 64-512 bins, full
    and sparse; K2 rows at 1,024-8,192 bins in and past the L2; K2's slab
    route at slabs of 16-128 bins and 1,024-16,384 bins."""
    out = {}
    for b in (16, 64, 128, 256, 512):
        out[f"fit_k2n_rows_l2_{b}"] = Shape(("k2n_rows",), 1, 20001, b,
                                            runs=True)
        s = 3 * -(-(256 << 20) // (3 * b))  # 256 MiB
        out[f"fit_k2n_rows_hbm_{b}"] = Shape(("k2n_rows",), 1, s, b,
                                             runs=True)
    for G in (8, 64):
        out[f"fit_k2n_rows_one_{G}"] = Shape(("k2n_rows",), G, 10524, 512,
                                             active="one", runs=True)
    out["fit_k2n_rows_none_64"] = Shape(("k2n_rows",), 64, 10524, 512,
                                        active="none", runs=True)
    for b, s in ((64, 3000), (256, 800), (512, 216)):
        for act in ("all", 64):
            out[f"fit_k2n_smem_{b}_{act}"] = Shape(("k2n_smem",), 64, s, b,
                                                   active=act, runs=True)
    for b in (1024, 2048, 4096, 8192):
        out[f"fit_k2_rows_l2_{b}"] = Shape(
            ("k2_rows",), 1, 3 * -(-(24 << 20) // (3 * b)), b)
        out[f"fit_k2_rows_hbm_{b}"] = Shape(
            ("k2_rows",), 1, 3 * -(-(512 << 20) // (3 * b)), b)
    for s, b in ((1800, 1024), (3606, 1024), (7000, 1024), (14000, 1024),
                 (3606, 2048), (3606, 8192), (1800, 16384)):
        out[f"fit_k2_slab_{s}x{b}"] = Shape(("k2_slab",), 1, s, b)
    out.update(_thin_sweep())
    return out


def _thin_sweep() -> dict:
    """The thin slabs' fit: slabs of 8 and 4 bins at 1,024 to 4,096 bins,
    the batch as phase 13b's or the fit's default one; each beside the
    rows route on the same inputs."""
    return {f"fit_k2_thin_{s}x{b}{tag}": Shape(("k2_thin", "k2_rows"),
                                               1, s, b, **kw)
            for s, b, tag, kw in (
                (15000, 4096, "", {}), (20000, 1024, "", {}),
                (28000, 2048, "", {}), (39621, 2048, "", {}),
                (50000, 1024, "", {}),
                (20000, 1024, "_long", dict(H=8192, nvalid=5712)))}


def shape_names(spec: str) -> list[str]:
    if spec == "all":
        return list(SHAPES) + list(_sweep())
    if spec == "sweep":
        return list(DEFAULT) + list(_sweep())
    if spec == "default":
        return list(DEFAULT)
    if spec == "thin":
        return ["thin_39621x1024"] + list(_thin_sweep())
    return spec.split(",")


def inputs(rng, sh: Shape, dev: torch.device) -> dict:
    """The launch's inputs on ``dev``: keys, the valid mask, the tables
    (random bytes made on the device), the activity, the runs' CSR."""
    G, S, R, H = sh.G, sh.S, sh.R, sh.H
    Bp = probe.pad_bins(sh.bins)
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    valid = np.zeros((R, H), dtype=bool)
    valid[:, :sh.nvalid] = True
    if sh.active == "all":
        act = np.ones((G, R), dtype=bool)
    elif sh.active == "none":
        act = np.zeros((G, R), dtype=bool)
    elif sh.active == "one":
        act = np.zeros((G, R), dtype=bool)
        act[rng.integers(0, G, R), np.arange(R)] = True
    else:
        act = np.zeros(G * R, dtype=bool)
        act[rng.choice(G * R, int(sh.active), replace=False)] = True
        act = act.reshape(G, R)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    tables = torch.randint(0, 256, (G, S, Bp), dtype=torch.uint8,
                           device=dev, generator=gen)
    starts = np.arange(0, Bp, 4)
    n = starts.shape[0]
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return dict(hi=t(hi), lo=t(lo), valid=t(valid), tables=tables,
                active=t(act), run_off=t(np.arange(G + 1) * n),
                run_s=t(np.tile(starts, G)), run_e=t(np.tile(starts + 4, G)),
                seed=int(rng.integers(0, 2**63)), bl=S // 3)


def descent_groups(x: dict) -> tuple[list[dict], int]:
    """One descent group over x's stack, no member reachable from the
    root (BFS position 0 is in no group), so no read is active: each
    subgroup holds one member (BFS 1..G) whose first run is merged (a
    child at BFS G + 1) and whose other runs are leaves, as
    DeviceHIXF.upload_groups lays a group out."""
    dev = x["tables"].device
    G = x["tables"].shape[0]
    n = int(x["run_off"][1])
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa
    g = dict(tables=x["tables"], seed=x["seed"], bl=x["bl"],
             run_off=x["run_off"], run_s=x["run_s"], run_e=x["run_e"],
             member_bfs=t(range(1, G + 1)), member_sub=t(range(G)),
             child_bfs=t([G + 1]), child_parent=t([1]), child_run=t([0]),
             leaf_bfs=t([1 + i // (n - 1) for i in range(G * (n - 1))]),
             leaf_run=t([i * n + j for i in range(G) for j in range(1, n)]),
             members=[])
    return [g], G + 2


def _args(x: dict, h: torch.Tensor) -> tuple:
    """(hi, lo, valid, tables, active) of x with hi = h."""
    return h, x["lo"], x["valid"], x["tables"], x["active"]


def _descent(x: dict, sh: Shape):
    """fn(hi): the leaf values of e2e.descend over descent_groups(x)."""
    groups, n_nodes = descent_groups(x)
    thr = torch.zeros(sh.R, dtype=torch.int32, device=x["hi"].device)

    def f(h):
        vals, _ = e2e.descend(groups, n_nodes, h, x["lo"], x["valid"], thr)
        return torch.cat(vals)
    return f


def _dense(rt: str, sh: Shape) -> bool:
    """K2 writes dense counts; K2n and the probe call the shape's run
    sums where it has them."""
    return rt.startswith("k2_") or not sh.runs


def plain_of(rt: str, x: dict, sh: Shape):
    """The route's twin: fn(hi) on x's tensors (the descent on the
    CPU)."""
    if rt == "descent":
        cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
               for k, v in x.items()}
        f = _descent(cpu, sh)
        return lambda h: f(h.cpu())
    sk = (x["seed"], x["bl"])
    if _dense(rt, sh):
        return lambda h: probe.probe_counts_grouped_plain(*_args(x, h), *sk)
    return lambda h: probe.probe_run_sums_grouped_plain(
        *_args(x, h), x["run_off"], x["run_s"], x["run_e"], *sk)


def route_fn(rt: str, x: dict, sh: Shape, cuda: bool):
    """fn(hi): the route on x's tensors (on the CPU, the twin)."""
    if rt == "descent":
        return _descent(x, sh)
    runs = (x["run_off"], x["run_s"], x["run_e"])
    sk = (x["seed"], x["bl"])
    if rt == "call" or not cuda:
        if _dense(rt, sh):
            return lambda h: probe.probe_counts_grouped(*_args(x, h), *sk)
        return lambda h: probe.probe_run_sums_grouped(*_args(x, h), *runs,
                                                      *sk)
    if rt.startswith("k2_"):  # a thin slab: the widest slab that fits
        variant = "rows" if rt == "k2_rows" else "slab"
        return lambda h: probe.k2_counts(*_args(x, h), *sk, variant=variant)
    mode = rt[4:]
    if sh.runs:
        return lambda h: probe.k2n_run_sums(*_args(x, h), *runs, *sk,
                                            mode=mode)
    return lambda h: probe.k2n_counts(*_args(x, h), *sk, mode=mode)


def model_ms(rt: str, x: dict, sh: Shape) -> tuple[float, float]:
    """device_cost's prediction of the route's call on x, and the device
    part of it (the call is the larger of that and the host floor)."""
    G, S, Bp = x["tables"].shape
    floor = device_cost.GROUP_MS if rt == "descent" else device_cost.CALL_MS
    if rt == "descent":  # no read is active (descent_groups)
        pairs = hashes = loaded = 0.0
    else:
        act = x["active"]
        pairs = float(act.sum())
        hashes = float((act.long() * x["valid"].sum(1)[None]).sum())
        loaded = float(act.any(1).sum())
    if rt in ("call", "descent"):
        rt = device_cost.route(S, Bp)
    out = G * sh.R * Bp if _dense(rt, sh) else x["run_s"].shape[0] * sh.R
    dev = device_cost.device_ms(rt, G, S, Bp, sh.R, pairs, hashes, out,
                                loaded)
    return max(floor, dev), dev


def _fit_rows(out: dict) -> list[tuple]:
    """(name, route, G, S, Bpad, R, pairs, hashes, outputs, subgroups
    loaded, device ms) of out's probe launches (no call, no descent, not
    the tool's own check "tiny")."""
    rows = []
    for name, rec in out["shapes"].items():
        if name == "tiny":
            continue
        G, S, Bp = rec["tables"]
        R, p = rec["R"], rec["active_pairs"]
        loaded = G if p >= G * R else G * (1 - (1 - 1 / G) ** p)
        for rt, r in rec["routes"].items():
            if rt in ("call", "descent") or not r["device_ms"]:
                continue
            runs = rec["runs"] and rt.startswith("k2n")
            rows.append((name, rt, G, S, Bp, R, p, rec["valid_hashes"],
                         G * R * (Bp // 4 if runs else Bp), loaded,
                         r["device_ms"]))
    return rows


# fit_coefficients' parameter vector: each route's places in it (15 and 16
# are L2_EFF and WRITE_BPS, which every route shares)
_PARAMS = {"k2_slab": (0, 1, 2), "k2_rows": (3, 4, 5, 6),
           "k2n_rows": (7, 8, 9, 10, 11), "k2n_smem": (12, 13, 14),
           "k2_thin": (17, 18, 19)}


def fit_coefficients(out: dict, only: tuple = ()) -> dict:
    """device_cost's fitted coefficients (COEF, L2_EFF, WRITE_BPS) from a
    run's device times: least squares of log(model / measured), the
    DEFAULT shapes weighted twice; device_cost is left as it was.
    ``only``: the routes whose coefficients to fit, from their launches
    alone, every other value held as device_cost has it.  With each
    fitted value its measured-over-model ratio a launch, and the medians
    of the run's host calls (CALL_MS) and descent steps (GROUP_MS)."""
    import math

    from scipy.optimize import least_squares

    rows = [r for r in _fit_rows(out) if not only or r[1] in only]
    keep = (dict(device_cost.COEF), device_cost.L2_EFF,
            device_cost.WRITE_BPS)
    c = device_cost.COEF
    x0 = [c["k2_slab"]["a"], c["k2_slab"]["c0"], c["k2_slab"]["c1"],
          *c["k2_rows"]["l2"], *c["k2_rows"]["hbm"], *c["k2n_rows"]["l2"],
          *c["k2n_rows"]["hbm"], c["k2n_rows"]["pair"], c["k2n_smem"]["a"],
          c["k2n_smem"]["b"], c["k2n_smem"]["block"],
          device_cost.L2_EFF / 2**20, device_cost.WRITE_BPS / 1e12,
          c["k2_thin"]["c0"], c["k2_thin"]["c1"], c["k2_thin"]["read"]]
    free = (sorted(i for rt in only for i in _PARAMS[rt]) if only
            else list(range(len(x0))))

    def setp(xf):
        x = list(x0)
        for i, v in zip(free, xf):
            x[i] = abs(v)
        device_cost.COEF = {
            "k2_slab": {"a": x[0], "c0": x[1], "c1": x[2]},
            "k2_rows": {"l2": (x[3], x[4]), "hbm": (x[5], x[6])},
            "k2n_rows": {"l2": (x[7], x[8]), "hbm": (x[9], x[10]),
                         "pair": x[11]},
            "k2n_smem": {"a": x[12], "b": x[13], "block": x[14]},
            "k2_thin": {"c0": x[17], "c1": x[18], "read": x[19]}}
        device_cost.L2_EFF = x[15] * 2**20
        device_cost.WRITE_BPS = x[16] * 1e12

    def logs(xf):
        setp(xf)
        return [math.log(device_cost.device_ms(*r[1:10]) / r[10])
                for r in rows]

    weight = [1.0 if r[0] in _sweep() else 2.0 for r in rows]
    try:
        fit = least_squares(lambda xf: [w * e for w, e in
                                        zip(weight, logs(xf))],
                            [x0[i] for i in free],
                            x_scale=[abs(x0[i]) for i in free])
        ratios = {f"{r[0]} {r[1]}": math.exp(-e)
                  for r, e in zip(rows, logs(fit.x))}
        got = dict(COEF=device_cost.COEF, L2_EFF=device_cost.L2_EFF,
                   WRITE_BPS=device_cost.WRITE_BPS)
    finally:
        device_cost.COEF, device_cost.L2_EFF, device_cost.WRITE_BPS = keep

    def median(rt):
        v = sorted(r["routes"][rt]["ms"] for n, r in out["shapes"].items()
                   if rt in r["routes"] and n != "tiny")
        return v[len(v) // 2] if v else None

    return dict(got, measured_over_model=ratios, CALL_MS=median("call"),
                GROUP_MS=median("descent"))


def run(args) -> dict:
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    from taxor_tpu_torch.tools.time_sort import device_ms

    rng = np.random.default_rng(args.seed)
    out = {"device": card_line() if cuda else "cpu",
           "model_card": device_cost.FIT_CARD, "equal": True, "shapes": {}}
    for name in shape_names(args.shapes):
        sh = SHAPES.get(name) or _sweep()[name]
        x = inputs(rng, sh, dev)
        G, S, Bp = x["tables"].shape
        n = float((x["active"].long() * x["valid"].sum(1)[None]).sum())
        rec = {"tables": [G, S, Bp], "R": sh.R, "H": sh.H,
               "active_pairs": int(x["active"].sum()), "valid_hashes": n,
               "runs": sh.runs, "routes": {}}
        for rt in sh.routes:
            fn = route_fn(rt, x, sh, cuda)
            equal = torch.equal(fn(x["hi"]).cpu(),
                                plain_of(rt, x, sh)(x["hi"]).cpu())
            pred, pred_dev = model_ms(rt, x, sh)
            # a call the host's launch path bounds is timed over 200 calls
            # a mean: the host's speed switches between runs of calls
            ms = rolled_ms(fn, x["hi"], M=200 if pred > pred_dev else 10)
            dms = device_ms(lambda: fn(x["hi"])) if cuda else None
            r = {"ms": ms, "device_ms": dms, "equal": equal,
                 "ns_per_hash": ms * 1e6 / n if n else None,
                 "rows_gbps": 3 * n * Bp / ms / 1e6, "model_ms": pred,
                 "model_device_ms": pred_dev, "host_bound": pred > pred_dev,
                 "measured_over_model": ms / pred}
            rec["routes"][rt] = r
            out["equal"] &= equal
            log(f"bench_gather_scale {name} {rt}: {ms:.4f} ms a call"
                + (f", {dms:.4f} on the device" if cuda else "")
                + f", model {pred:.4f} ({ms / pred:.2f}x); == twin: {equal}")
        out["shapes"][name] = rec
        del x
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="default",
                    help="comma-separated names of SHAPES, or default, "
                         "sweep (default + the fit's shapes), all")
    ap.add_argument("--fit", action="store_true",
                    help="also fit device_cost's coefficients to the run's "
                         "device times (scipy; with --shapes sweep or all)")
    ap.add_argument("--fit-only", default="",
                    help="comma-separated routes whose coefficients --fit "
                         "fits, the others held (e.g. k2_thin, with "
                         "--shapes thin)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    out = run(args)
    if args.fit:
        out["fit"] = fit_coefficients(
            out, tuple(filter(None, args.fit_only.split(","))))
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
