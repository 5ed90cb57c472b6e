"""The port's command line against the JAX package's: the same options
with the same defaults (but the port's --device), and one small
hierarchical ``build`` through each writing the same files, the counting
stage's chopper.count and chopper_sketches/ included."""

import argparse
import os
import zipfile

import numpy as np
import pytest

from taxor_tpu import cli as jax_cli
from taxor_tpu_torch import cli

from .util import make_ref_set

JAX_ONLY: dict = {}
PORT_ONLY = {"search": {"--device"}, "prewarm": {"--device"}}
COMMANDS = ("build", "search", "profile", "prewarm")


def options(mod, command: str) -> dict:
    """{option string: default} of one subcommand of a CLI module."""
    sub = argparse.ArgumentParser().add_subparsers()
    parser = getattr(mod, f"_add_{command}")(sub)
    return {o: a.default for a in parser._actions for o in a.option_strings
            if o not in ("-h", "--help")}


@pytest.mark.parametrize("command", COMMANDS)
def test_options_and_defaults_match_the_jax_cli(command):
    jax_opts, port_opts = options(jax_cli, command), options(cli, command)
    assert set(jax_opts) - set(port_opts) == JAX_ONLY.get(command, set())
    assert set(port_opts) - set(jax_opts) == PORT_ONLY.get(command, set())
    for opt in set(jax_opts) & set(port_opts):
        assert port_opts[opt] == jax_opts[opt], opt


def tree(root: str) -> dict:
    """{relative path: bytes} of the files under root; an .npz index maps
    to its members' bytes (the zip's entry times are the write time)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with zipfile.ZipFile(path) as z:
                    out[rel] = {n: z.read(n) for n in sorted(z.namelist())}
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_build_through_each_cli_writes_the_same_files(tmp_path, monkeypatch):
    """70 species over 64 technical bins: the auto layout runs the
    counting stage, whose artifacts the port used to leave out."""
    rng = np.random.default_rng(8)
    tsv, gdir, _ = make_ref_set(str(tmp_path), rng, n_species=70,
                                genome_len=2500)
    trees = []
    for name, mod in (("jax", jax_cli), ("port", cli)):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.chdir(out)  # binning.out and chopper.* land here
        assert mod.main(["-v", "build", "--input-file", tsv,
                         "--input-sequence-dir", gdir, "--output-filename",
                         "idx.taxor.npz", "--kmer-size", "22",
                         "--syncmer-size", "12", "--use-syncmer", "--tmax",
                         "64", "--layout-cost", "cpu"]) == 0
        trees.append(tree(str(out)))
    assert trees[0] == trees[1]
    names = set(trees[0])
    assert {"idx.taxor.npz", "binning.out", "chopper.count"} <= names
    assert any(n.startswith("chopper_sketches" + os.sep) for n in names)


def test_resume_and_an_empty_prefix(tmp_path, monkeypatch):
    """A build with --count-output-prefix '' writes no counting artifacts,
    and a second one with --resume reads binning.out instead of rewriting
    it: through each CLI, the same files after both."""
    rng = np.random.default_rng(9)
    tsv, gdir, _ = make_ref_set(str(tmp_path), rng, n_species=70,
                                genome_len=2000)
    args = ["build", "--input-file", tsv, "--input-sequence-dir", gdir,
            "--output-filename", "idx.taxor.npz", "--kmer-size", "22",
            "--syncmer-size", "12", "--use-syncmer", "--tmax", "64",
            "--count-output-prefix", ""]
    trees = []
    for name, mod in (("jax", jax_cli), ("port", cli)):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.chdir(out)
        assert mod.main(args) == 0
        stamp = os.stat("binning.out").st_mtime_ns
        assert mod.main(args + ["--resume"]) == 0
        assert os.stat("binning.out").st_mtime_ns == stamp  # read only
        trees.append(tree(str(out)))
    assert trees[0] == trees[1]
    assert set(trees[0]) == {"idx.taxor.npz", "binning.out"}
