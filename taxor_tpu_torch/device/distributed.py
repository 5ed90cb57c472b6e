"""Multi-process setup of the sharded engine on ``torch.distributed``.

Counterpart of ``taxor_tpu/device/distributed.py``.  One JAX process
drives every TPU core of its host; a port process drives one device.  So
every rank runs the same ``search --engine sharded --distributed``
command, one process a card (or, where ranks share a card, several on
it), and:

  - ``initialize`` joins the world: ``init_process_group`` on gloo (the
    rendezvous and the host-side exchanges), then every rank's (host,
    device) pair is exchanged and the collectives' backend picked from
    them (``collective_backend``): NCCL where every rank holds a card of
    its own, gloo where two ranks share a card (NCCL refuses that) or
    the device is the CPU.  The choice is made from the pairs alone,
    never by trying NCCL, and rank 0 logs it once;
  - ``global_mesh`` and ``make_mesh`` lay a reads x bins grid over the
    ranks: the fingerprint columns shard over 'bins', the read batches
    over 'reads'.  Each rank keeps its cell (r, b), the process group of
    its reads row (the ranks that share r, over which the bins shards'
    run sums add) and that of its bins column (one rank of each reads
    row, over which ``sharding.host_view`` gathers the rows' results).

Failure semantics: fail-fast, as in the JAX package.  A rank that raises
exits non-zero; the others fail once a collective waits longer than
``TIMEOUT``.
"""

from __future__ import annotations

import datetime
import socket
import sys
from dataclasses import dataclass

import torch

# how long a collective (and the rendezvous) waits for the other ranks
TIMEOUT = datetime.timedelta(minutes=10)

# the world this process joined through ``initialize``: its collectives'
# backend and this rank's device
_WORLD: dict = {}


def collective_backend(pairs, nccl_available: bool) -> str:
    """The collectives' backend of ranks with (host, device type, device
    index) ``pairs``: "nccl" where every rank holds a CUDA device no
    other rank holds, else "gloo"."""
    on_cards = all(kind == "cuda" for _, kind, _ in pairs)
    distinct = len(set(pairs)) == len(pairs)
    return "nccl" if on_cards and distinct and nccl_available else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str = "cuda") -> torch.device:
    """Join the world of ranks and return this rank's device.

    coordinator_address: host:port of rank 0 (``tcp://`` rendezvous);
    without it the ``env://`` variables that ``torchrun`` sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  device: "cpu", or a
    CUDA device, which becomes ``cuda:(rank % device_count)``; a rank
    with no card fails, it never carries on on the CPU."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu to run the plain twins)")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init, timeout=TIMEOUT, **kw)
    rank, world = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    pairs = [None] * world
    dist.all_gather_object(pairs, (socket.gethostname(), dev.type,
                                   dev.index))
    backend = collective_backend([tuple(p) for p in pairs],
                                 dist.is_nccl_available())
    _WORLD.update(backend=backend, device=dev)
    if rank == 0:
        shared = len(set(pairs)) < len(pairs)
        print(f"[taxor] {world} rank(s); collectives on {backend} ("
              + ("ranks share a device" if shared and dev.type == "cuda"
                 else "on the CPU" if dev.type == "cpu"
                 else "one card a rank") + ")", file=sys.stderr, flush=True)
    return dev


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.clear()


@dataclass
class Mesh:
    """A reads x bins grid of ranks, seen from one rank.

    r, b: this rank's cell, None where the grid leaves the rank out.
    row_group: the process group of the ranks (r, 0..nb-1), in b order;
    col_group: that of the ranks (0..nr-1, b), in r order; both None on
    a one-process 1 x 1 mesh, whose collectives are identities.
    backend: the collectives' backend, None without a process group."""

    nr: int
    nb: int
    r: int | None
    b: int | None
    device: torch.device
    backend: str | None = None
    row_group: object = None
    col_group: object = None

    @property
    def member(self) -> bool:
        return self.r is not None

    def describe(self) -> str:
        return (f"mesh {self.nr} reads x {self.nb} bins, cell (r={self.r}, "
                f"b={self.b}), collectives on {self.backend or 'none'}")


def _mesh(nr: int, nb: int, rank_of, device) -> Mesh:
    """The mesh whose cell (r, b) is rank ``rank_of(r, b)``.  Every rank
    of the world must call this, in the same order: each creates every
    row and column group."""
    import torch.distributed as dist

    if nr < 1 or nb < 1:
        raise ValueError(f"mesh {nr} x {nb}: both axes need a shard")
    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if nr * nb > world:
        raise ValueError(f"need {nr * nb} ranks, have {world} (one process "
                         "a device: start reads x bins processes with "
                         "--distributed)")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, device)
    backend = _WORLD.get("backend") or dist.get_backend()
    me = dist.get_rank()
    mesh = Mesh(nr, nb, None, None, device, backend)
    for r in range(nr):
        ranks = [rank_of(r, b) for b in range(nb)]
        group = dist.new_group(ranks, backend=backend)
        if me in ranks:
            mesh.r, mesh.b, mesh.row_group = r, ranks.index(me), group
    for b in range(nb):
        ranks = [rank_of(r, b) for r in range(nr)]
        group = dist.new_group(ranks, backend=backend)
        if me in ranks:
            mesh.col_group = group
    # connect the groups now, rows first on every rank (NCCL connects at
    # its first collective, which would otherwise time as a batch's)
    for group in (mesh.row_group, mesh.col_group):
        if group is not None:
            dist.all_reduce(torch.zeros(1, device=device), group=group)
    return mesh


def make_mesh(n_reads_shards: int, n_bin_shards: int, device) -> Mesh:
    """reads x bins mesh over the first n_reads_shards * n_bin_shards
    ranks, laid out as the JAX ``make_mesh`` lays out its devices (rank
    r * nb + b); the other ranks are left out (``Mesh.member``).  Outside
    a process group only the 1 x 1 mesh exists."""
    return _mesh(n_reads_shards, n_bin_shards,
                 lambda r, b: r * n_bin_shards + b, device)


def global_mesh(reads_shards: int | None = None,
                bin_shards: int | None = None, device=None) -> Mesh:
    """reads x bins mesh over the whole world, in the JAX ``global_mesh``
    order: the rank grid laid out (bins, reads) and transposed, so cell
    (r, b) is rank b * nr + r.  Defaults: bins over every rank (index
    parallel: each rank's device holds a slice of the fingerprints) and
    reads over what is left.  Every rank must hold a cell: a grid smaller
    or larger than the world raises."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    nb = bin_shards or world
    nr = reads_shards or max(1, world // nb)
    if nr * nb < world:
        raise ValueError(f"mesh {nr} x {nb} leaves {world - nr * nb} of "
                         f"{world} ranks without a shard")
    return _mesh(nr, nb, lambda r, b: b * nr + r,
                 _WORLD.get("device") if device is None else device)
