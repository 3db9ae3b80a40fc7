"""Taxonomy and LCA in the port against the JAX package's CLI, on the
fixtures of tests/test_e2e_taxonomy.py: ``mkindexp -m MAP -x DUMP``
writes the same index bytes in both packages, and ``searchp`` with the
``staxids lcaid lcataxid`` columns (and the SAM ``st ls lt`` tags) writes
the same output; the port's LCA equals the JAX package's on random
trees."""

import bz2

import numpy as np
import pytest

from lambda_tpu import cli as jcli
from lambda_tpu.index import taxonomy as jtax
from lambda_tpu.io import fasta
from lambda_tpu_torch import cli as tcli
from lambda_tpu_torch.index import taxonomy as ttax
from tests.test_e2e import GYRA

COLUMNS = "std staxids lcaid lcataxid"


def _tax_db(d, acc_lines, nodes, names, bz2_map=False):
    db = d / "db.fasta"
    fasta.write_fasta(db, [
        fasta.SeqRecord("sp|P0AES4|GYRA_ECOLI gyrase", GYRA.encode()),
        fasta.SeqRecord("sp|P12345|OTHER other protein", GYRA[:200].encode()),
    ])
    text = "accession\taccession.version\ttaxid\tgi\n" + acc_lines
    if bz2_map:
        acc_map = d / "map.accession2taxid.bz2"
        with bz2.open(acc_map, "wt") as fh:
            fh.write(text)
    else:
        acc_map = d / "map.accession2taxid"
        acc_map.write_text(text)
    dump = d / "dump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text("".join(
        f"{i}\t|\t{p}\t|\t{rank}\t|\n" for i, p, rank in nodes))
    (dump / "names.dmp").write_text("".join(
        f"{i}\t|\t{n}\t|\t\t|\tscientific name\t|\n" for i, n in names))
    return ["-d", str(db), "-m", str(acc_map), "-x", str(dump)]


def _indexes(d, mk_args):
    """The index of each package's mkindexp; their bytes."""
    lits = {}
    for who, main in (("jax", jcli.main), ("port", tcli.main)):
        lit = d / f"{who}.lit"
        assert main(["mkindexp", *mk_args, "-i", str(lit), "-v", "0"]) == 0
        lits[who] = lit
    return lits


@pytest.fixture(scope="module")
def tax_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tax")
    mk = _tax_db(
        d, "P0AES4\tP0AES4.1\t562\t0\nP12345\tP12345.1\t9606\t0\n",
        [(1, 1, "no rank"), (131567, 1, "no rank"), (2, 131567,
                                                    "superkingdom"),
         (2759, 131567, "superkingdom"), (562, 2, "species"),
         (9606, 2759, "species")],
        [(1, "root"), (131567, "cellular organisms"), (2, "Bacteria"),
         (2759, "Eukaryota"), (562, "Escherichia coli"),
         (9606, "Homo sapiens")])
    return d, _indexes(d, mk)


def _search_both(d, lit, q_seq, out_name, *args):
    q = d / f"{out_name}.fasta"
    fasta.write_fasta(q, [fasta.SeqRecord("q1", q_seq.encode())])
    outs = {}
    for who, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        out = d / f"{who}_{out_name}"
        assert main(["searchp", "-q", str(q), "-i", str(lit), "-o",
                     str(out), *args, "-v", "0",
                     "--version-to-outputfile", "0", *extra]) == 0
        outs[who] = out.read_bytes()
    return outs


def test_port_index_bytes_and_staxids_lca_columns(tax_setup):
    d, lits = tax_setup
    assert lits["port"].read_bytes() == lits["jax"].read_bytes()
    outs = _search_both(d, lits["port"], GYRA[50:150], "both.m8",
                        "--output-columns", COLUMNS, "-n", "5")
    assert outs["port"] == outs["jax"]
    rows = [r.split("\t") for r in outs["port"].decode().splitlines()]
    assert len(rows) == 2
    assert {r[1]: r[12] for r in rows} == {"sp|P0AES4|GYRA_ECOLI": "562",
                                           "sp|P12345|OTHER": "9606"}
    assert rows[0][13:15] == ["cellular organisms", "131567"]


@pytest.mark.parametrize("out_name,args", [
    ("single.m8", ("--output-columns", "std lcataxid")),
    ("single.sam", ("--sam-bam-tags", "AS st ls lt")),
], ids=["m8", "sam"])
def test_port_lca_single_subject(tax_setup, out_name, args):
    d, lits = tax_setup
    outs = _search_both(d, lits["port"], GYRA[300:400], out_name, *args)
    assert outs["port"] == outs["jax"]
    assert b"562" in outs["port"]


def test_port_bz2_map_and_out_of_tree_taxid(tmp_path):
    mk = _tax_db(
        tmp_path, "P0AES4\tP0AES4.1\t562\t0\nP12345\tP12345.1\t999999999\t0\n",
        [(1, 1, "no rank"), (2, 1, "superkingdom"), (562, 2, "species")],
        [(1, "root"), (2, "Bacteria"), (562, "Escherichia coli")],
        bz2_map=True)
    lits = _indexes(tmp_path, mk)
    assert lits["port"].read_bytes() == lits["jax"].read_bytes()
    outs = _search_both(tmp_path, lits["port"], GYRA[30:110], "o.m8",
                        "--output-columns", COLUMNS)
    assert outs["port"] == outs["jax"] and outs["port"]
    assert b"999999999" not in b"".join(
        r.split(b"\t")[13] for r in outs["port"].splitlines())


def test_port_lca_random_trees_match_jax(tmp_path):
    """The port's thinned tree and LCA equal the JAX package's, and the
    true LCA of the original tree, on random trees and present sets."""
    rng = np.random.default_rng(123)
    for trial in range(12):
        n = int(rng.integers(4, 60))
        ids = list(range(2, n + 2))
        parent_of = {1: 1}
        for i in ids:
            parent_of[i] = int(rng.choice([1] + [j for j in ids if j < i])) \
                if i > 2 else 1
        dump = tmp_path / f"dump{trial}"
        dump.mkdir()
        (dump / "nodes.dmp").write_text("".join(
            f"{i}\t|\t{p}\t|\tno rank\t|\n" for i, p in parent_of.items()))
        (dump / "names.dmp").write_text("".join(
            f"{i}\t|\ttax{i}\t|\t\t|\tscientific name\t|\n"
            for i in parent_of))
        k = int(rng.integers(2, max(3, n // 2)))
        present = set(int(x) for x in rng.choice(ids, size=k, replace=False))
        tree = ttax.build_tax_tree(str(dump), present)
        want_tree = jtax.build_tax_tree(str(dump), present)
        for got, want in zip(tree, want_tree):       # parents, heights,
            np.testing.assert_array_equal(got, want)  # names

        def orig_ancestors(t):
            chain = [t]
            while t != 1:
                t = parent_of[t]
                chain.append(t)
            return chain

        for a in sorted(present):
            for b in sorted(present):
                anc = set(orig_ancestors(a))
                want = next(t for t in orig_ancestors(b) if t in anc)
                assert ttax.compute_lca(tree[0], tree[1], a, b) == want \
                    == jtax.compute_lca(*want_tree[:2], a, b)
