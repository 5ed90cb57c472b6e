"""At-scale demo of the port: build a RefSeq-class hierarchical index
(the regime of the reference's published 9.9 GB index) and search it end
to end on one CUDA GPU, from skewed synthetic inputs:

  * log-normal genome lengths of 30 kb - 5 Mb, drawn in blocks of 1,024
    (viral to bacterial scale),
  * homology clusters of 1-16 taxa, each member a 1-10 %-mutated copy of
    its cluster's base sequence,
  * ONT-like reads of mixed lengths (500 b - 8 kb, 2% substitutions)
    streamed from FASTQ.gz through the whole search pipeline.

The port of the JAX package's ``tools/at_scale_demo.py``, with the same
recipe from the same seed: its genomes, ``taxonomy.tsv``, reads and
``parity_reads.fna`` are byte-equal to those of the JAX demo (the reads
compared decompressed).  Stages, each one process, each checkpointing
its record into the result JSON:

  gen       genomes, taxonomy, reads                              (CPU)
  build     ``apps/build.run_build`` (k 22, s 12, syncmers, auto layout,
            tmax 4096, spill dir, every host core), its phase timings,
            the host, its peak RSS and the disk the spill took        (CPU)
  baseline  the native single-thread proxies, scaled to a modelled
            32-thread reference build                                 (CPU)
  search    on the card: index load, upload (``DeviceHIXF``), the cold
            first search (the kernels' build included), two warm searches
            of every read, the device burst rate of ``e2e_async``, the
            routes of the uploaded groups, launches a batch, device and
            host memory, accuracy from the read ids
  parity    ``--engine host`` on the parity reads must equal the device
            TSV of ``search`` byte for byte; exits 1 where it does not

    python -m taxor_tpu_torch.tools.at_scale_demo <stage> [--device cuda|cpu]

The whole demo is the five in turn, each in a process of its own (its
peak RSS its own):

    sh -c 'for s in gen build baseline search parity; do
        python -m taxor_tpu_torch.tools.at_scale_demo $s || exit 1; done'

Environment (the JAX demo's names): ATSCALE_DIR (work directory, default
``.atscale_torch/`` at the repo root), ATSCALE_RESULT (the result JSON,
default ``ATSCALE_torch.json`` at the repo root; never the JAX demo's
``ATSCALE_r0*.json``), ATSCALE_SEQ_GB (sequence to generate, default 18:
the JAX demo's final recipe of 44,032 genomes; 0.001 gives one block of
1,024 genomes, 0.40 GB), ATSCALE_READS (100,000), ATSCALE_PARITY_READS
(512), ATSCALE_BATCH (the search batch, 1,024).  The stage functions take
the same values as a ``Demo``.

``--device cpu`` runs the search on the plain twins; it exists for the
tests.  ``--device cuda`` without a card fails: no stage falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import gzip
import itertools
import json
import os
import resource
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 20250821
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# the JAX demo's records: this demo never writes them
JAX_RESULTS = ("ATSCALE_r04.json", "ATSCALE_r05.json")
BURST_READS = 2048  # reads of 2 kb in the device burst batch


@dataclass
class Demo:
    """Where the demo works and at what scale."""

    work: str
    result: str
    seq_gb: float = 18.0
    n_reads: int = 100_000
    parity_reads: int = 512
    batch: int = 1024
    device: str = "cuda"

    def __post_init__(self):
        if os.path.basename(self.result) in JAX_RESULTS:
            raise ValueError(f"{self.result} is the JAX demo's record")

    @classmethod
    def from_env(cls, device: str = "cuda") -> "Demo":
        env = os.environ.get
        return cls(
            work=env("ATSCALE_DIR", os.path.join(ROOT, ".atscale_torch")),
            result=os.path.join(ROOT, env("ATSCALE_RESULT",
                                          "ATSCALE_torch.json")),
            seq_gb=float(env("ATSCALE_SEQ_GB", 18.0)),
            n_reads=int(env("ATSCALE_READS", 100_000)),
            parity_reads=int(env("ATSCALE_PARITY_READS", 512)),
            batch=int(env("ATSCALE_BATCH", 1024)), device=device)

    def path(self, name: str) -> str:
        return os.path.join(self.work, name)


def log(m: str) -> None:
    print(f"[atscale +{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr,
          flush=True)


def record(demo: Demo, key: str, value: dict) -> dict:
    """Write value under key into the result JSON (the other keys kept)."""
    data = {}
    if os.path.exists(demo.result):
        with open(demo.result) as fh:
            data = json.load(fh)
    data[key] = value
    os.makedirs(os.path.dirname(os.path.abspath(demo.result)), exist_ok=True)
    with open(demo.result, "w") as fh:
        json.dump(data, fh, indent=1)
    log(f"recorded {key}")
    return value


def peak_rss_gb() -> float:
    """Peak resident set of this process so far, GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def host_record(demo: Demo) -> dict:
    """The host the stage runs on: cores, memory, the work directory's
    disk."""
    import shutil

    with open("/proc/meminfo") as fh:
        mem_kb = int(fh.readline().split()[1])
    disk = shutil.disk_usage(demo.work)
    return dict(cpu_count=os.cpu_count(), mem_gb=mem_kb / 2**20,
                disk_total_gb=disk.total / 2**30,
                disk_free_gb=disk.free / 2**30)


# ---------------------------------------------------------------- gen --
def _mutate(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    out = seq.copy()
    nerr = int(seq.shape[0] * rate)
    pos = rng.integers(0, seq.shape[0], nerr)  # collisions fine
    out[pos] = BASES[rng.integers(0, 4, nerr)]
    return out


def gen(demo: Demo) -> dict:
    """Skewed genomes in homology clusters, their taxonomy, the mixed-
    length FASTQ.gz reads and the parity subset: the JAX demo's draws, in
    its order."""
    rng = np.random.default_rng(SEED)
    gdir = demo.path("genomes")
    os.makedirs(gdir, exist_ok=True)
    t0 = time.time()
    total_target = demo.seq_gb * 1e9
    lengths: list[int] = []
    tot = 0.0
    while tot < total_target:
        block = np.clip(rng.lognormal(np.log(250e3), 1.0, 1024),
                        30e3, 5e6).astype(np.int64)
        lengths.extend(block.tolist())
        tot += float(block.sum())
    n = len(lengths)
    rows = []
    genome_index = []  # (accession, path, length) for read sampling
    i = 0
    cluster_id = 0
    while i < n:
        csize = int(min(np.clip(rng.geometric(0.3), 1, 16), n - i))
        clen = max(lengths[i:i + csize])
        base = BASES[rng.integers(0, 4, clen)]
        for j in range(csize):
            gi = i + j
            acc = f"GCF_{gi:06d}.1"
            L = lengths[gi]
            seq = base[:L] if j == 0 else _mutate(
                rng, base[:L], float(rng.uniform(0.01, 0.10)))
            path = os.path.join(gdir, f"{acc}_genomic.fna")
            with open(path, "wb") as fh:
                fh.write(b">" + acc.encode() + b" chromosome\n")
                fh.write(seq.tobytes())
                fh.write(b"\n")
            taxid = str(1000 + gi)
            names = (f"k__Bacteria;p__P{cluster_id%7};c__C{gi%11};"
                     f"o__O{gi%13};f__F{gi%17};g__G{cluster_id};"
                     f"s__Species {gi}")
            taxids = (f"2;{2000+cluster_id%7};{3000+gi%11};{4000+gi%13};"
                      f"{5000+gi%17};{6000+cluster_id};{1000+gi}")
            rows.append(f"{acc}\t{taxid}\tftp://x/{acc}_genomic.fna\t"
                        f"Organism {gi}\t{names}\t{taxids}")
            genome_index.append((acc, path, int(L)))
        i += csize
        cluster_id += 1
        if cluster_id % 1000 == 0:
            log(f"clusters {cluster_id}, genomes {i}/{n}")
    with open(demo.path("taxonomy.tsv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    log(f"genomes done: {n} in {cluster_id} clusters")

    # reads: read ids carry the source accession (the accuracy check)
    src = rng.choice(n, min(n, 8192), replace=False)
    with gzip.open(demo.path("reads.fq.gz"), "wb", compresslevel=1) as fq:
        for r in range(demo.n_reads):
            acc, path, L = genome_index[int(src[r % src.shape[0]])]
            rl = int(np.clip(rng.lognormal(np.log(2000), 0.6), 500, 8000))
            rl = min(rl, L - 1)
            with open(path, "rb") as fh:
                fh.seek(len(acc) + 13)  # the header line
                off = int(rng.integers(0, L - rl))
                fh.seek(off, 1)
                seq = np.frombuffer(fh.read(rl), dtype=np.uint8).copy()
            seq = _mutate(rng, seq, 0.02)
            fq.write(b"@read%d_%s\n" % (r, acc.encode()))
            fq.write(seq.tobytes() + b"\n+\n" + b"I" * rl + b"\n")
            if (r + 1) % 20000 == 0:
                log(f"reads {r + 1}/{demo.n_reads}")
    _write_parity_subset(demo)
    return record(demo, "gen", dict(
        n_species=n, n_clusters=cluster_id,
        seq_gb=round(sum(lengths) / 1e9, 2),
        len_min=int(min(lengths)), len_max=int(max(lengths)),
        len_median=int(np.median(lengths)),
        n_reads=demo.n_reads, reads="reads.fq.gz (mixed 500b-8kb, 2% err)",
        wall_s=time.time() - t0))


def _write_parity_subset(demo: Demo) -> None:
    """The first parity_reads reads as plain FASTA (the host check)."""
    from ..io.fastx import iter_fastx

    with open(demo.path("parity_reads.fna"), "wb") as fh:
        for rec in itertools.islice(iter_fastx(demo.path("reads.fq.gz")),
                                    demo.parity_reads):
            fh.write(b">" + rec.id.encode() + b"\n" + rec.seq + b"\n")


# -------------------------------------------------------------- build --
class _DirPeak:
    """The most bytes a directory held, polled every `every` seconds on a
    thread (the build's spill files come and go)."""

    def __init__(self, path: str, every: float = 2.0):
        self.path, self.every, self.peak = path, every, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def size(self) -> int:
        total = 0
        for d, _, files in os.walk(self.path):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(d, f))
                except OSError:  # removed while walking
                    pass
        return total

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            self.peak = max(self.peak, self.size())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.size())


def build(demo: Demo) -> dict:
    """The port's build of the demo's index, as the JAX demo builds it,
    on every host core."""
    from ..apps.build import BuildConfig, run_build

    threads = os.cpu_count() or 1
    host = host_record(demo)
    spill = demo.path("spill")
    os.makedirs(spill, exist_ok=True)
    t0 = time.time()
    with _DirPeak(spill) as disk:
        index = run_build(BuildConfig(
            input_file=demo.path("taxonomy.tsv"),
            input_sequence_dir=demo.path("genomes"),
            output_filename=demo.path("index.npz"),
            kmer_size=22, syncmer_size=12, use_syncmer=True,
            layout_mode="auto", tmax=4096,
            layout_file=demo.path("binning.out"), spill_dir=spill,
            threads=threads))
    wall = time.time() - t0
    hixf = index.hixf
    sizes = sorted((x.fingerprints.nbytes for x in hixf.ixfs), reverse=True)
    return record(demo, "build", dict(
        wall_s=wall,
        phases=dict(getattr(index, "build_timings", {})),
        n_ixfs=len(hixf.ixfs),
        depth=_depth(hixf),
        root_bins=hixf.ixfs[0].bin_count,
        fingerprint_gb=sum(sizes) / 2**30,
        largest_ixf_mb=sizes[0] / 2**20,
        max_slots=max(x.fingerprints.shape[0] for x in hixf.ixfs),
        index_npz_gb=os.path.getsize(demo.path("index.npz")) / 2**30,
        n_user_bins=hixf.num_user_bins,
        suggested_topk=index.suggested_topk,
        threads=threads,
        host=host,
        peak_rss_gb=peak_rss_gb(),
        spill_peak_gb=disk.peak / 2**30,
    ))


def _depth(hixf) -> int:
    """Levels of IXFs under the root, the root's included."""
    depth, level = 0, [0]
    while level:
        depth += 1
        level = [int(c) for i in level for c in hixf.next_ixf_id[i]
                 if int(c) != i and int(c) >= 0]
    return depth


# ----------------------------------------------------------- baseline --
def baseline(demo: Demo) -> dict:
    """A modelled 32-thread reference build from the single-thread rates
    of the port's native proxies on a 128-file sample (the JAX demo's
    model): counting and peel at 32x, the layout DP and serialisation as
    this build measured them (the reference runs them on one thread)."""
    import glob

    from ..hash import schemes as _schemes
    from ..hash.schemes import HashScheme, build_hashes
    from ..io.fastx import iter_fastx
    from ..ixf.xor_filter import build_ixf

    files = sorted(glob.glob(demo.path(os.path.join("genomes", "*.fna"))))
    sample = files[::max(1, len(files) // 128)][:128]
    scheme = HashScheme(kmer_size=22, syncmer_size=12, use_syncmer=True)
    seqs, nbytes = [], 0
    for f in sample:
        for rec in iter_fastx(f):
            seqs.append(rec.seq)
            nbytes += len(rec.seq)
    _schemes.NUM_THREADS = 1
    build_hashes(seqs[:4], scheme)  # warm the native library
    t0 = time.time()
    hashes = [build_hashes([q], scheme) for q in seqs]
    count_rate = nbytes / (time.time() - t0) / 1e6  # MB/s, one thread
    hs = [h for h in hashes if h.shape[0] > 64][:64]
    n_hashes = sum(h.shape[0] for h in hs)
    t0 = time.time()
    build_ixf(hs, threads=1)
    peel_rate = n_hashes / (time.time() - t0) / 1e6  # M hashes/s

    with open(demo.result) as fh:
        data = json.load(fh)
    seq_gb = data["gen"]["seq_gb"]
    phases = data.get("build", {}).get("phases", {})
    total_hashes_m = seq_gb * 1e9 * 0.092 / 1e6  # syncmer density k22 s12
    proxy = dict(
        count_s=seq_gb * 1e9 / (32 * count_rate * 1e6),
        layout_s=phases.get("layout_s"),
        peel_s=total_hashes_m / (32 * peel_rate),
        serialize_s=phases.get("serialize_s"))
    proxy_wall = sum(v for v in proxy.values() if v)
    our_wall = data.get("build", {}).get("wall_s")
    return record(demo, "build_baseline", dict(
        sample_files=len(sample),
        count_1thread_mb_s=count_rate,
        peel_1thread_mhash_s=peel_rate,
        proxy_phases=proxy,
        proxy_32thread_wall_s=proxy_wall,
        our_wall_s=our_wall,
        build_vs_baseline=proxy_wall / our_wall if our_wall else None,
        note="modelled 32-thread reference build from single-thread "
             "native rates; layout + serialize modelled 1-thread (the "
             "reference runs them single-threaded); our build ran on "
             f"{os.cpu_count()} host cores"))


# ------------------------------------------------------------- search --
def group_routes(dhixf) -> list[dict]:
    """Each uploaded descent group: its stacked shape [G, S, Bpad], its
    IXFs and the kernel its shape takes (K2n smem or rows, K2 slab or
    rows; on the CPU the plain twin)."""
    from ..device import probe
    from ..hash import device_syncmer as dsync

    out = []
    for g in dhixf.groups:
        G, S, Bp = g["tables"].shape
        if g["tables"].device.type != "cuda":
            route = "plain twin"
        elif Bp <= probe.NARROW_MAX_BINS:
            route = "K2n " + probe.narrow_mode(S, Bp, g["tables"].device)
        else:
            # as the L = 8,192 bucket's batch of the demo's k = 22,
            # s = 12 scheme takes it
            route = "K2 " + ("slab" if probe.slab_bins(
                S, Bp, dsync.hash_cap(8192, 22, 12, 5), g["tables"].device)
                else "rows")
        out.append(dict(shape=[G, S, Bp], ixfs=len(g["members"]),
                        route=route))
    return out


def step_activity(per_launch: list, packed) -> dict:
    """The group launches of one fused step of the packed reads and how
    many of them probe no pair (every read inactive in every subgroup),
    from each launch's active pairs a subgroup
    (``ActivityStats.per_launch``)."""
    per = [x.cpu().numpy() for x in per_launch]
    return dict(
        reads=int(packed.shape[0]), L=int(packed.shape[1] * 4),
        group_launches=len(per),
        empty_launches=int(sum(int(p.sum()) == 0 for p in per)),
        subgroups=int(sum(p.shape[0] for p in per)),
        empty_subgroups=int(sum(int((p == 0).sum()) for p in per)),
        active_pairs=[int(p.sum()) for p in per])


def _device_of(demo: Demo):
    import torch

    dev = torch.device(demo.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("at_scale_demo search: no CUDA device (--device "
                         "cpu runs the plain twins)")
    return dev


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def search(demo: Demo) -> dict:
    """The search on the card (the module docstring).  Launch counts are
    read as differences, so a caller's counts stay whole:
    ``search_launches`` are those of the three ``search_single`` calls
    (cold and both warm), ``warm_launches`` those of the last warm
    one."""
    import torch

    from ..device import launches
    from ..device.hixf_search import ACTIVITY, DeviceHIXF
    from ..hash import device_syncmer as dsync
    from ..hixf.index import load_index
    from ..io.fastx import read_all
    from ..native.baseline import baseline_search
    from ..search.pipeline import SearchConfig, search_single
    from ..search.thresholds import Thresholder
    from .bench import card_line

    dev = _device_of(demo)
    cuda = dev.type == "cuda"
    rss_start = peak_rss_gb()
    t0 = time.time()
    index = load_index(demo.path("index.npz"))
    load_s = time.time() - t0
    rss_load = peak_rss_gb()
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    dhixf = DeviceHIXF(index.hixf, dev)
    _sync(dev)
    prep_s = time.time() - t0
    rss_upload = peak_rss_gb()
    hier = len(dhixf.ixfs) > 1
    tables = [g["tables"] for g in dhixf.groups] if hier else [dhixf.table]
    table_bytes = sum(t.numel() for t in tables)
    fp_bytes = sum(x.fingerprints.nbytes for x in index.hixf.ixfs)
    upload_mem = torch.cuda.memory_allocated(dev) if cuda else None

    cfg = SearchConfig(engine="device", batch_size=demo.batch)
    # cold: the first search, the kernels' build on the card included
    # (nothing before it asks for the library)
    first = launches.read()
    t0 = time.time()
    with open(demo.path("device_parity.tsv"), "w") as out:
        search_single(index, demo.path("parity_reads.fna"), out, cfg, dhixf)
    cold_wall = time.time() - t0
    cold_launches = launches.since(first)
    routes = group_routes(dhixf) if hier else []

    walls, warm_launches = [], None
    for _ in range(2):  # warm, every read through the whole pipeline
        before = launches.read()
        t0 = time.time()
        with open(demo.path("device_full.tsv"), "w") as out:
            search_single(index, demo.path("reads.fq.gz"), out, cfg, dhixf)
        walls.append(time.time() - t0)
        warm_launches = launches.since(before)
    search_launches = launches.since(first)

    # the native reference proxy on one thread (the JAX demo's baseline;
    # after the upload, so that its flat copy of the index is not in the
    # upload's RSS)
    seqs = [r.seq for r in read_all(demo.path("parity_reads.fna"))]
    sub = seqs[:128]
    t0 = time.time()
    baseline_search(index.hixf, sub, scheme, thresholder, threads=1)
    r1 = len(sub) / (time.time() - t0)
    # search_single writes no header line (the JAX demo skipped its
    # first line as one, and so counted one read fewer)
    ids, best = set(), {}
    with open(demo.path("device_full.tsv")) as fh:
        for line in fh:
            c = line.split("\t")
            ids.add(c[0])
            if c[1] == "-":
                continue
            cnt = int(c[7])  # the read's best-count row, as profiles take
            if cnt > best.get(c[0], (-1, ""))[0]:
                best[c[0]] = (cnt, c[1])
    n_all = len(ids)
    hits = len(best)
    ok = sum(1 for rid, (_, acc) in best.items() if rid.endswith("_" + acc))

    # device burst: repeated batches of 2 kb reads, compute only
    burst = [s[:2000] for s in seqs if len(s) >= 2000] or [s for s in seqs]
    while len(burst) < BURST_READS:
        burst = burst + burst
    burst = burst[:BURST_READS]
    packed, lens = dsync.pack_reads(burst, 2048)
    k = max(16, int(getattr(index, "suggested_topk", 16)))
    with ACTIVITY.per_launch() as per_launch:  # warm; the step's launches
        dhixf.e2e_async(packed, lens, scheme, thresholder, k=k)()
    activity = step_activity(per_launch, packed) if hier else None
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        dhixf.e2e_async(packed, lens, scheme, thresholder, k=k)()
    burst_rate = reps * len(burst) / (time.time() - t0)

    steps = max(1, warm_launches["K1"])
    full_wall = walls[-1]
    return record(demo, "search", dict(
        device=demo.device,
        card=card_line() if cuda else None,
        torch=torch.__version__, cuda=torch.version.cuda,
        index_load_s=load_s,
        device_prep_s=prep_s,
        n_ixfs=len(dhixf.ixfs),
        groups=routes,
        routes={r: sum(g["route"] == r for g in routes)
                for r in sorted({g["route"] for g in routes})},
        fingerprint_bytes=fp_bytes,
        device_table_bytes=table_bytes,
        padding_share=(table_bytes - fp_bytes) / table_bytes,
        device_allocated_after_upload_bytes=upload_mem,
        peak_device_bytes=(torch.cuda.max_memory_allocated(dev) if cuda
                           else None),
        peak_rss_gb=dict(before_load=rss_start, after_load=rss_load,
                         after_upload=rss_upload, end=peak_rss_gb()),
        topk=k,
        batch=demo.batch,
        cold_wall_s=cold_wall,
        cold_launches=cold_launches,
        search_launches=search_launches,
        warm_walls_s=walls,
        n_reads=n_all,
        full_pipeline_wall_s=full_wall,
        full_pipeline_reads_per_s=n_all / full_wall,
        warm_launches=warm_launches,
        fused_steps=warm_launches["K1"],
        launches_per_step={kk: v / steps for kk, v in warm_launches.items()},
        step_activity=activity,
        device_burst_reads_per_s=burst_rate,
        pipeline_vs_burst=(n_all / full_wall) / burst_rate,
        baseline_1thread_reads_per_s=r1,
        baseline_32x_reads_per_s=32 * r1,
        vs_baseline=n_all / full_wall / (32 * r1),
        classified_fraction=hits / max(1, n_all),
        correct_of_classified=ok / max(1, hits),
    ))


def parity(demo: Demo) -> dict:
    """The host oracle on the parity reads against the device TSV of
    ``search``, byte for byte; SystemExit(1) where they differ."""
    from ..hixf.index import load_index
    from ..search.pipeline import SearchConfig, search_single

    index = load_index(demo.path("index.npz"))
    t0 = time.time()
    with open(demo.path("host_parity.tsv"), "w") as out:
        search_single(index, demo.path("parity_reads.fna"), out,
                      SearchConfig(engine="host", batch_size=1024), None)
    host_wall = time.time() - t0
    with open(demo.path("device_parity.tsv"), "rb") as fh:
        dev = fh.read()
    with open(demo.path("host_parity.tsv"), "rb") as fh:
        host = fh.read()
    rec = record(demo, "parity", dict(
        n_reads=sum(1 for _ in open(demo.path("parity_reads.fna"))) // 2,
        host_wall_s=host_wall, byte_identical=dev == host))
    if dev != host:
        raise SystemExit("PARITY FAILURE: device TSV != host TSV on the "
                         "parity reads")
    return rec


STAGES = {"gen": gen, "build": build, "baseline": baseline,
          "search": search, "parity": parity}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stage", choices=list(STAGES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the search's device (cpu: the plain twins)")
    args = ap.parse_args(argv)
    demo = Demo.from_env(args.device)
    os.makedirs(demo.work, exist_ok=True)
    STAGES[args.stage](demo)
    return 0


if __name__ == "__main__":
    sys.exit(main())
