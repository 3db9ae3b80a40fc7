"""Pigeonhole seeding (seed delta >= 2) in the port against the JAX
package, on the fixtures of tests/test_seed_delta.py and of the
bisulfite pigeonhole case of tests/test_e2e_bisulfite.py: the JAX
package's run_search and the port's (on the CPU) write byte-equal m8,
and the port holds every property those tests hold of the JAX package
(delta 1 misses the dense mutations, delta 2 and 3 find them, the
half-exact anchor needs an exact first half)."""

import numpy as np
import pytest

from lambda_tpu import options as jopt
from lambda_tpu.index import artifact as jart
from lambda_tpu.io import fasta
from lambda_tpu.search import pipeline as jpipe
from lambda_tpu_torch import cli as tcli
from lambda_tpu_torch import options as topt
from lambda_tpu_torch.ops import kmer as tkmer
from lambda_tpu_torch.search import pipeline as tpipe
from tests.test_e2e import revcomp

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


@pytest.fixture(scope="module")
def db_and_queries(tmp_path_factory):
    """tests/test_seed_delta.py's fixture: a query that mutates a
    database fragment every 6 positions, so every 14-mer seed window
    holds >= 2 mismatches."""
    d = tmp_path_factory.mktemp("torch_delta")
    rng = np.random.default_rng(17)
    seqs = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(4)]
    db = [fasta.SeqRecord(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
    frag = list(seqs[2][100:180])
    for p in range(3, len(frag), 6):
        frag[p] = COMP[frag[p]]
    fasta.write_fasta(d / "db.fasta", db)
    fasta.write_fasta(d / "q.fasta",
                      [fasta.SeqRecord("mut_q", "".join(frag).encode())])
    iopts = jopt.IndexerOptions(domain=jopt.Domain.NUCLEOTIDE,
                                db_file=str(d / "db.fasta"),
                                index_file=str(d / "db.lit"))
    jart.save_index(jart.build_index(iopts), str(d / "db.lit"))
    return d


def _search_both(d, delta: int, half: bool, tag: str):
    """The JAX package's and the port's m8 bytes (and the port's rows)
    under test_seed_delta.py's options."""
    outs = []
    for mod, pipe in ((jopt, jpipe), (topt, tpipe)):
        out = str(d / f"out_{tag}_{mod.__name__.split('.')[0]}.m8")
        opt = mod.make_search_options(
            mod.Domain.NUCLEOTIDE, query_file=str(d / "q.fasta"),
            index_file=str(d / "db.lit"), output=out, verbosity=0)
        opt.search_opts.max_seed_dist = delta
        opt.iterative_search = False
        opt.adaptive_seeding = False
        opt.seed_half_exact = half
        opt.pre_scoring = 0
        if pipe is tpipe:
            pipe.run_search(opt, device="cpu")
        else:
            pipe.run_search(opt)
        outs.append(open(out, "rb").read())
    assert outs[1] == outs[0]
    return [ln.split("\t") for ln in outs[1].decode().splitlines()
            if ln and not ln.startswith("#")]


def test_delta1_misses_dense_mutations(db_and_queries):
    assert _search_both(db_and_queries, 1, False, "d1") == []


def test_delta2_finds_dense_mutations(db_and_queries):
    rows = _search_both(db_and_queries, 2, False, "d2")
    assert rows, "pigeonhole delta=2 must seed the 2-mismatch windows"
    hit = rows[0]
    assert hit[0] == "mut_q" and hit[1] == "s2"
    assert int(hit[8]) >= 95 and int(hit[9]) <= 185


def test_delta3_also_finds(db_and_queries):
    rows = _search_both(db_and_queries, 3, False, "d3")
    assert rows and rows[0][1] == "s2"


def test_pigeon_chunks_partition():
    for k in (9, 10, 14, 17):
        for delta in (2, 3):
            off, ln = tkmer.pigeon_chunks(k, delta)
            assert len(off) == delta + 1
            assert ln.sum() == k
            assert off[0] == 0
            assert (np.diff(off) == ln[:-1]).all()
            assert ln.min() >= 1


def test_delta2_half_exact_requires_exact_first_half(db_and_queries):
    """With --seed-half-exact (default), delta >= 2 confines errors to
    the second seed half; the dense-mutation fixture has no exact first
    half anywhere, so nothing may be found, in both packages."""
    assert _search_both(db_and_queries, 2, True, "hx") == []


def test_bisulfite_seed_delta2_pigeonhole(tmp_path):
    """tests/test_e2e_bisulfite.py's pigeonhole case: verification uses
    the per-frame-parity bisulfite reduction (fwd for even subject
    frames, rev for odd), through both CLIs; m8 byte-equal and the read
    found on chr1 at its position."""
    from lambda_tpu import cli as jcli

    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), 400))
    db = tmp_path / "genome.fasta"
    fasta.write_fasta(db, [fasta.SeqRecord("chr1", genome.encode())])
    lit = tmp_path / "genome.lit"
    assert tcli.main(["mkindexbs", "-d", str(db), "-i", str(lit),
                      "-v", "0"]) == 0
    read = list(genome[100:180].replace("C", "T"))
    swap = {"A": "G", "G": "T", "T": "A"}
    for p in range(4, len(read), 8):
        read[p] = swap.get(read[p], "A")
    q = tmp_path / "reads.fasta"
    fasta.write_fasta(q, [fasta.SeqRecord("noisy", "".join(read).encode()),
                          fasta.SeqRecord("noisy_minus", revcomp(
                              "".join(read)).encode())])
    outs = []
    for cli, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        out = tmp_path / f"out_{len(outs)}.m8"
        assert cli.main(["searchbs", "-q", str(q), "-i", str(lit), "-o",
                         str(out), "--seed-delta", "2", "--search0", "OFF",
                         "--adaptive-seeding", "0", "--pre-scoring", "0",
                         "--seed-half-exact", "0", "-e", "1e-2", "-v", "0",
                         *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[1] == outs[0]
    rows = [ln.split("\t") for ln in outs[1].decode().splitlines()]
    assert rows, "BS pigeonhole seeding found nothing"
    assert rows[0][1] == "chr1"
    assert 95 <= int(rows[0][8]) <= 105
