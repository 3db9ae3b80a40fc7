"""The generator repeats for a seed and gives the stated composition,
lengths, family law and query mixes."""

import json

import numpy as np
import pytest

from benchmark.harness import generate as g
from benchmark.reference import tables
from conftest import BENCH


def db_params(residues):
    p = json.loads((BENCH / "configs/blastp_sprot_half.json").read_text())
    return dict(p["database"], residues=residues, absent_families=500)


@pytest.fixture(scope="module")
def db():
    return g.make_database(2 ** 33 + 7, db_params(10_000_000))


def test_same_seed_same_database_other_seed_other(db):
    again = g.make_database(2 ** 33 + 7, db_params(10_000_000))
    other = g.make_database(2 ** 33 + 8, db_params(10_000_000))
    assert np.array_equal(db.seq, again.seq)
    assert np.array_equal(db.order, again.order)
    assert not np.array_equal(db.seq[:1000], other.seq[:1000])


def test_residues_composition_and_mean_length(db):
    p = db_params(10_000_000)
    assert db.residues == 10_000_000 == int(db.lengths().sum())
    comp = np.bincount(db.seq, minlength=20) / db.seq.size
    assert np.abs(comp - tables.background()).max() < 0.003
    # the ancestors' lengths are the quantile set of the log-normal
    assert abs(g.length_set(20000, p).mean() - 360) < 4
    assert abs(db.lengths().mean() - 360) < 18
    assert db.lengths().min() >= 1


def test_families_follow_the_power_law_and_absent_ones_stay_out(db):
    sizes = g.size_set(100000, db_params(1))
    assert sizes.min() == 1 and sizes.max() <= 300
    # P(s) ~ s^-2: about 61 % singletons, 15 % pairs
    assert abs((sizes == 1).mean() - 0.61) < 0.01
    assert abs((sizes == 2).mean() - 0.152) < 0.01
    assert db.family.max() < db.n_in_db
    assert len(db.fams.size) - db.n_in_db >= 500


def test_proteins_are_new_members_at_the_family_divergence(db):
    rng = g.rng_for(5, 2)
    qs = g.make_proteins(rng, db, 200, 0.7)
    assert sum(q.planted for q in qs) == 140
    for q in qs[:40]:
        anc = db.fams.anc[db.fams.anc_off[q.family]:
                          db.fams.anc_off[q.family + 1]]
        assert abs(len(q.text) - len(anc)) <= 12
        if q.planted:
            assert q.family in set(db.family.tolist())
        else:
            assert q.family >= db.n_in_db
    again = g.make_proteins(g.rng_for(5, 2), db, 200, 0.7)
    assert [q.text for q in qs] == [q.text for q in again]


def test_reads_code_for_a_fragment_of_their_subject(db):
    reads = g.make_reads(g.rng_for(6, 2), db, 100, 0.7, 50)
    assert all(len(r.text) == 150 for r in reads)
    assert sum(r.planted for r in reads) == 70
    for i, r in enumerate(reads[:30]):
        if not r.planted:
            assert r.family == -1
            continue
        dna = tables.revcomp(r.text) if i % 2 else r.text
        aa = tables.translate(dna)
        assert (aa < 20).all()          # no stop codon in a coding read
        members = np.nonzero(db.family == r.family)[0]
        best = 0
        for m in members:
            s = db.subject(int(m))
            for st in range(len(s) - 49):
                best = max(best, int((s[st:st + 50] == aa).sum()))
        assert best >= 50 - 6           # 50 // 8 residues replaced


def test_homolog_share_is_spread_evenly():
    flags = [g._homolog(i, 0.7) for i in range(100)]
    assert sum(flags) == 70
    assert all(sum(flags[i:i + 10]) == 7 for i in range(0, 100, 10))
    assert sum(g._homolog(i, 1 / 32) for i in range(1024)) == 32
