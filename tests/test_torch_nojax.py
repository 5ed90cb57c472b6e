"""taxor_tpu_torch runs where JAX is absent: a subprocess with ``jax``
blocked builds an index and searches it with both engines on the CPU,
and no source of the package imports JAX or the JAX package's device
modules."""

import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "taxor_tpu_torch")

# modules of the JAX package that import jax at module level
JAX_MODULES = ("taxor_tpu.device", "taxor_tpu.hash.device_syncmer",
               "taxor_tpu.utils.u64jnp", "taxor_tpu.cli")

SCRIPT = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
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
                     gdir, "--output-filename", idx, "--kmer-size", "22",
                     "--syncmer-size", "12", "--use-syncmer", "--layout",
                     LAYOUT, "--tmax", "64"]) == 0
    from taxor_tpu.hixf.index import load_index
    n_ixfs = len(load_index(idx).hixf.ixfs)
    assert (n_ixfs > 1) == (LAYOUT == "auto"), n_ixfs
    out = {}
    for engine in ("device", "host"):
        out[engine] = os.path.join(WORK, engine + ".tsv")
        assert cli.main(["search", "--index-file", idx, "--query-file",
                         reads, "--output-file", out[engine], "--engine",
                         engine, "--device", "cpu"]) == 0
    dev, host = (open(out[e], "rb").read() for e in ("device", "host"))
    assert dev == host and dev.count(b"GCF_") >= 3 * N_SPECIES, dev
    assert sys.modules["jax"] is None
    loaded = [m for m in sys.modules if m.startswith(JAX_MODULES)]
    assert not loaded, loaded
    print("NOJAX_OK")
""")


def run_blocked(tmp_path, layout: str, n_species: int,
                genome_len: int) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    code = (f"REPO = {REPO!r}\nWORK = {str(tmp_path)!r}\n"
            f"JAX_MODULES = {JAX_MODULES!r}\nLAYOUT = {layout!r}\n"
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


def _sources():
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # generated files
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    yield os.path.relpath(path, REPO), fh.read()


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
    offenders = [p for p, src in _sources() if pat.search(src)]
    assert not offenders, offenders
    assert len(list(_sources())) >= 10


def test_port_never_imports_jax_package_device_modules():
    names = "|".join(re.escape(m) for m in JAX_MODULES)
    pat = re.compile(rf"^\s*(from|import)\s+({names})\b", re.M)
    offenders = [p for p, src in _sources() if pat.search(src)]
    assert not offenders, offenders
