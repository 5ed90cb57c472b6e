"""taxor_tpu_torch runs where JAX and the JAX package are absent: a
subprocess with ``jax`` and ``taxor_tpu`` blocked builds an index,
searches it with the three engines on the CPU (the sharded one on its
one-process 1 x 1 mesh) and profiles the result; two blocked rank
processes search with the sharded engine over torch.distributed; the
at-scale demo imports and generates its data blocked; a
subprocess where both are importable does the same and loads neither;
and no source of the port, nor chip_smoke.py, imports either."""

import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "taxor_tpu_torch")

SCRIPT = textwrap.dedent("""
    import os, sys
    if BLOCK:  # any `import jax` or `import taxor_tpu` now raises
        sys.modules["jax"] = None
        sys.modules["taxor_tpu"] = None
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from util import make_reads, make_ref_set
    from taxor_tpu_torch import cli

    rng = np.random.default_rng(3)
    tsv, gdir, genomes = make_ref_set(WORK, rng, n_species=N_SPECIES,
                                      genome_len=GENOME_LEN)
    reads = make_reads(WORK, rng, genomes, n_reads_per_genome=3,
                       read_len=700, error_rate=0.02)
    idx = os.path.join(WORK, "idx.taxor.npz")
    assert cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                     gdir, "--output-filename", idx, *SCHEME, "--layout",
                     LAYOUT, "--tmax", "64"]) == 0
    from taxor_tpu_torch.hixf.index import load_index
    n_ixfs = len(load_index(idx).hixf.ixfs)
    assert (n_ixfs > 1) == (LAYOUT == "auto"), n_ixfs
    out = {}
    for engine in ("device", "host", "sharded"):
        out[engine] = os.path.join(WORK, engine + ".tsv")
        assert cli.main(["search", "--index-file", idx, "--query-file",
                         reads, "--output-file", out[engine], "--engine",
                         engine, "--device", "cpu"]) == 0
    dev, host, sharded = (open(out[e], "rb").read()
                          for e in ("device", "host", "sharded"))
    assert dev == host == sharded and dev.count(b"GCF_") >= 3 * N_SPECIES
    cami = os.path.join(WORK, "profile.tsv")
    assert cli.main(["profile", "--search-file", out["device"],
                     "--cami-report-file", cami, "--binning-file",
                     os.path.join(WORK, "binning.tsv"), "--sample-id",
                     "s1"]) == 0
    assert "@SampleID:s1" in open(cami).read()
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and m.split(".")[0] in ("jax", "jaxlib", "taxor_tpu")]
    assert not loaded, loaded
    print("NOJAX_OK")
""")


SYNCMER = ["--kmer-size", "22", "--syncmer-size", "12", "--use-syncmer"]


def run_blocked(tmp_path, layout: str, n_species: int, genome_len: int,
                block: bool = True, scheme=SYNCMER) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    code = (f"REPO = {REPO!r}\nWORK = {str(tmp_path)!r}\n"
            f"BLOCK = {block!r}\nLAYOUT = {layout!r}\nSCHEME = {scheme!r}\n"
            f"N_SPECIES = {n_species}\nGENOME_LEN = {genome_len}\n"
            + SCRIPT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout


def test_port_runs_with_jax_blocked(tmp_path):
    run_blocked(tmp_path, "flat", 4, 5000)


def test_port_runs_hierarchical_with_jax_blocked(tmp_path):
    """More user bins than the 64 technical bins of an IXF: the layout is
    hierarchical and the device engine takes the grouped descent."""
    run_blocked(tmp_path, "auto", 100, 3000)


def test_port_runs_minimizer_hierarchy_with_jax_blocked(tmp_path):
    """A minimiser index (k = 20, window 26): its fracminhash thresholds
    take the descend-all descent through the minimiser extraction."""
    run_blocked(tmp_path, "auto", 100, 3000,
                scheme=["--kmer-size", "20", "--window-size", "26"])


def test_port_loads_no_jax_where_jax_is_installed(tmp_path):
    """JAX importable: build, search with both engines and profile leave
    jax and taxor_tpu out of sys.modules."""
    import jax  # noqa: F401  (JAX is installed here)

    run_blocked(tmp_path, "auto", 100, 3000, block=False)


RANK = ("import sys; sys.modules['jax'] = None; "
        "sys.modules['taxor_tpu'] = None; "
        "from taxor_tpu_torch import cli; rc = cli.main(sys.argv[1:]); "
        "import taxor_tpu_torch.device.sharding, "
        "taxor_tpu_torch.tools.dryrun_multichip; sys.exit(rc)")


def test_sharded_ranks_run_with_jax_blocked(tmp_path):
    """Two rank processes with jax and taxor_tpu blocked run ``search
    --engine sharded --distributed`` (gloo, one bins shard each) and
    write the host engine's TSV; the new modules import blocked."""
    run_blocked(tmp_path, "flat", 4, 5000)  # the index and host.tsv
    from .torch_world import free_port

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    port, out = free_port(), str(tmp_path / "dist.tsv")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, "search", "--index-file",
         str(tmp_path / "idx.taxor.npz"), "--query-file",
         str(tmp_path / "reads.fasta"), "--output-file", out, "--engine",
         "sharded", "--distributed", "--coordinator-address",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(r), "--device", "cpu"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    with open(out, "rb") as fh, open(tmp_path / "host.tsv", "rb") as eh:
        assert fh.read() == eh.read()


TOOLS_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any `import jax` or `import taxor_tpu`
    sys.modules["taxor_tpu"] = None  # now raises
    import taxor_tpu_torch.tools as tools
    names = [m.name for m in pkgutil.iter_modules(tools.__path__)]
    for name in names:
        importlib.import_module("taxor_tpu_torch.tools." + name)
    from taxor_tpu_torch.tools import debug_min
    assert debug_min.main(["--device", "cpu", "--phases", "0,5,15"]) == 0
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and m.split(".")[0] in ("jax", "jaxlib", "taxor_tpu", "bench",
                                      "profile_phases", "util")]
    assert not loaded, loaded
    print("TOOLS_OK", sorted(names))
""")


def test_tools_import_neither_jax_nor_the_jax_tooling(tmp_path):
    """Every module of taxor_tpu_torch.tools imports, and debug_min runs,
    with jax and taxor_tpu blocked; none loads the JAX package's bench.py,
    profile_phases.py or tests/util.py."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", TOOLS_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    for name in ("bench", "debug_extract", "debug_min", "probe_bounds",
                 "probe_experiments", "profile_phases", "synth", "timing"):
        assert f"'{name}'" in res.stdout


ATSCALE_SCRIPT = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None  # any `import jax` or `import taxor_tpu`
    sys.modules["taxor_tpu"] = None  # now raises
    from taxor_tpu_torch.tools import at_scale_demo as demo
    d = demo.Demo(work=WORK, result=os.path.join(WORK, "r.json"),
                  seq_gb=0.001, n_reads=64, parity_reads=16)
    rec = demo.gen(d)
    assert rec["n_species"] == len(os.listdir(d.path("genomes"))) == 1024
    assert open(d.path("parity_reads.fna")).read().count(">") == 16
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and m.split(".")[0] in ("jax", "jaxlib", "taxor_tpu")]
    assert not loaded, loaded
    print("ATSCALE_OK")
""")


def test_at_scale_demo_runs_with_jax_blocked(tmp_path):
    """taxor_tpu_torch.tools.at_scale_demo imports, and its gen runs at
    one block of 1,024 genomes, with jax and taxor_tpu blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    code = f"WORK = {str(tmp_path)!r}\n" + ATSCALE_SCRIPT
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ATSCALE_OK" in res.stdout


def _sources():
    """(path, text) of every Python source of the port and chip_smoke.py."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # generated files
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            yield os.path.relpath(path, REPO), fh.read()


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
    offenders = [p for p, src in _sources() if pat.search(src)]
    assert not offenders, offenders
    assert len(list(_sources())) >= 30


def test_port_never_imports_jax_package_device_modules():
    """Nor any module of the JAX package."""
    pat = re.compile(r"^\s*(from|import)\s+taxor_tpu(\.|\s|$)", re.M)
    offenders = [p for p, src in _sources() if pat.search(src)]
    assert not offenders, offenders
