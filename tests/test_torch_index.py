"""The index artifact is shared between the packages: an index written by
the JAX package's mkindexp loads in the port with equal arrays and vice
versa, and ``resident_index`` uploads exactly those arrays."""

import numpy as np
import pytest
import torch

from lambda_tpu import options as jopt
from lambda_tpu.index import artifact as jart
from lambda_tpu.io import fasta
from lambda_tpu_torch import options as topt
from lambda_tpu_torch.index import artifact as tart
from lambda_tpu_torch.ops import searchsorted as tss
from lambda_tpu_torch.search import pipeline as tpipe
from tests.test_torch_seeding import protein_db


def _assert_same_index(a, b):
    ka, kb = a.get_kmer(allow_partial=False), b.get_kmer(allow_partial=False)
    for name in ("keys", "pos", "frame"):
        np.testing.assert_array_equal(getattr(ka, name), getattr(kb, name))
    for name in ("trans_concat", "trans_offsets", "trans_lengths"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.ids == b.ids
    assert (a.orig_alph, a.trans_alph, a.red_alph) == \
        (b.orig_alph, b.trans_alph, b.red_alph)
    assert a.db_total_length == b.db_total_length


@pytest.fixture(scope="module")
def db_fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_index")
    subj, _ = protein_db(9, n_subj=80, n_qry=0)
    fasta.write_fasta(d / "db.fasta", [fasta.SeqRecord(f"s{i}", s.encode())
                                       for i, s in enumerate(subj)])
    return d


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_artifact_round_trips_between_packages(db_fasta, writer):
    d = db_fasta
    lit = d / f"{writer}.lit"
    if writer == "jax":
        o = jopt.IndexerOptions(domain=jopt.Domain.PROTEIN,
                                db_file=str(d / "db.fasta"),
                                index_file=str(lit))
        jart.save_index(jart.build_index(o), str(lit))
    else:
        o = topt.IndexerOptions(domain=topt.Domain.PROTEIN,
                                db_file=str(d / "db.fasta"),
                                index_file=str(lit))
        tart.save_index(tart.build_index(o), str(lit))
    _assert_same_index(jart.load_index(str(lit)), tart.load_index(str(lit)))


def test_port_builds_the_same_index(db_fasta):
    d = db_fasta
    kw = dict(db_file=str(d / "db.fasta"), index_file=str(d / "x.lit"))
    _assert_same_index(
        tart.build_index(topt.IndexerOptions(domain=topt.Domain.PROTEIN,
                                             **kw)),
        jart.build_index(jopt.IndexerOptions(domain=jopt.Domain.PROTEIN,
                                             **kw)))


@pytest.mark.parametrize("domain", ["NUCLEOTIDE", "BISULFITE", "PROTEIN"],
                         ids=["mkindexn", "mkindexbs", "mkindexp"])
def test_port_builds_the_same_dna_index(tmp_path, domain):
    """A DNA database indexed for each search domain (mkindexp on DNA is
    the six-frame TBLASTN/TBLASTX index): the same arrays, and the same
    bytes once saved."""
    rng = np.random.default_rng(17)
    fasta.write_fasta(tmp_path / "dna.fasta", [
        fasta.SeqRecord(f"chr{i} contig", "".join(
            rng.choice(list("ACGT"), int(rng.integers(150, 400)))).encode())
        for i in range(24)])
    built = {}
    for who, opt_mod, art in (("jax", jopt, jart), ("port", topt, tart)):
        o = opt_mod.IndexerOptions(domain=opt_mod.Domain[domain],
                                   db_file=str(tmp_path / "dna.fasta"),
                                   index_file=str(tmp_path / f"{who}.lit"))
        built[who] = art.build_index(o)
        art.save_index(built[who], o.index_file)
    _assert_same_index(built["port"], built["jax"])
    assert (tmp_path / "port.lit").read_bytes() == \
        (tmp_path / "jax.lit").read_bytes()
    assert built["port"].orig_alph != built["port"].trans_alph \
        or domain != "PROTEIN"


def test_resident_index_uploads_the_loaded_arrays(db_fasta):
    d = db_fasta
    lit = d / "res.lit"
    o = jopt.IndexerOptions(domain=jopt.Domain.PROTEIN,
                            db_file=str(d / "db.fasta"), index_file=str(lit))
    jart.save_index(jart.build_index(o), str(lit))
    idx = jart.load_index(str(lit))
    kg = idx.get_kmer(allow_partial=False)
    m = tss.pick_bucket_m(kg.bits, kg.chars_per_word, kg.num_positions)
    res = tpipe.resident_index(tpipe.index_arrays(idx, m), "cpu")
    np.testing.assert_array_equal(res["keys"].numpy(),
                                  kg.keys.astype(np.int64))
    assert res["keys"].dtype == torch.int64
    np.testing.assert_array_equal(res["pos"].numpy(), kg.pos)
    np.testing.assert_array_equal(res["frame"].numpy(), kg.frame)
    np.testing.assert_array_equal(
        res["bucket"].numpy(), tss.prefix_table(kg.keys[:, 0], kg.bits, m))
    np.testing.assert_array_equal(res["sbj_offsets"].numpy(),
                                  idx.trans_offsets[:-1])
    np.testing.assert_array_equal(res["sbj_lens"].numpy(), idx.trans_lengths)
    np.testing.assert_array_equal(res["trans_sbj"].numpy(),
                                  idx.trans_concat.astype(np.int8))
