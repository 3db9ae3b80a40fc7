"""--db-shards / --q-shards in the port's CLI (on a grid of CPU cells)
against the JAX package's CLI, byte for byte, on the fixtures of
tests/test_sharding.py (exact and adaptive seeding, bisulfite,
--kmer-words 2, the q x db grids with the 11 queries that once lost every
match on q-shards >= 1, pigeonhole with adaptive seeding, --lazy-query)
and of tests/test_db_stream.py (the mesh2 case, and tiny per-cell hit
budgets that force the overflow retry through the mesh).  The JAX
package's own tests hold its sharded bytes equal to its unsharded ones,
so each fixture's JAX run is the unsharded search, made once; the budget
case compares with the JAX mesh itself."""

import numpy as np
import pytest

from lambda_tpu import alphabets as jab, cli as jcli, options as jopt
from lambda_tpu.io import fasta
from lambda_tpu.search import pipeline as jpipe
from lambda_tpu.stats import StatsHolder as JStats
from lambda_tpu_torch import alphabets as tab, cli as tcli
from lambda_tpu_torch import options as topt
from lambda_tpu_torch.search import pipeline as tpipe
from lambda_tpu_torch.stats import StatsHolder as TStats
from tests.test_e2e import GYRA

AA = "ARNDCQEGHILKMFPSTWYV"
PLAIN_DB = [("GYRA_ECOLI", GYRA), ("OTHER1", GYRA[::-1]),
            ("OTHER2", "MNKQRSTVWYACDEFGHILMNPQRSTVWYACDEFGHIKLM" * 4)]


def _write(path, recs):
    fasta.write_fasta(path, [fasta.SeqRecord(n, s.encode()) for n, s in recs])
    return path


def _repeat_db():
    rng = np.random.default_rng(9)
    rep = GYRA[100:140] * 3
    return [("GYRA_ECOLI", GYRA), ("REPEAT1", rep),
            ("REPEAT2", rep[20:] + rep[:20]),
            ("RAND", "".join(rng.choice(list(AA), 200)))]


def _delta2_db_and_queries():
    rng = np.random.default_rng(31)
    rep = GYRA[100:140] * 3
    db = [("GYRA_ECOLI", GYRA), ("REPEAT1", rep),
          ("REPEAT2", rep[20:] + rep[:20]),
          ("RAND", "".join(rng.choice(list(AA), 200)))]
    mut = list(GYRA[95:175])
    for p in range(3, len(mut), 9):
        mut[p] = AA[(AA.index(mut[p]) + 1) % len(AA)]
    return db, [("q1", "".join(mut)), ("q2", GYRA[100:140] * 2)]


def _bisulfite():
    rng = np.random.default_rng(77)
    genomes = ["".join(rng.choice(list("ACGT"), 300)) for _ in range(3)]
    return ([(f"chr{i}", g) for i, g in enumerate(genomes)],
            [(f"r{i}_fwd", g[100:180].replace("C", "T"))
             for i, g in enumerate(genomes)])


# fixture -> (mkindex subcommand and flags, database, queries, search
# subcommand, the flags of every run); the database/query recipes are
# tests/test_sharding.py's
FIXTURES = {
    "plain": ("mkindexp", [], PLAIN_DB,
              [("q1", GYRA[50:130]), ("q2", GYRA[300:380])],
              "searchp", ["--adaptive-seeding", "0"]),
    "adaptive": ("mkindexp", [], _repeat_db(),
                 [("q1", GYRA[95:175]), ("q2", GYRA[100:140] * 2)],
                 "searchp", []),
    "bisulfite": ("mkindexbs", [], *_bisulfite(), "searchbs",
                  ["--adaptive-seeding", "0"]),
    "words2": ("mkindexp", ["--kmer-words", "2"], PLAIN_DB[:2],
               [("q1", GYRA[50:130])], "searchp",
               ["--adaptive-seeding", "0"]),
    "grid": ("mkindexp", [], PLAIN_DB,
             [(f"q{i}", GYRA[i * 25:i * 25 + 80]) for i in range(11)],
             "searchp", []),
    "delta2": ("mkindexp", [], *_delta2_db_and_queries(), "searchp",
               ["--seed-delta", "2", "--search0", "OFF"]),
    "lazy": ("mkindexp", [], [("GYRA_ECOLI", GYRA), ("G2", GYRA[40:200])],
             [(f"q{i}", GYRA[i * 30:i * 30 + 70]) for i in range(4)],
             "searchp", []),
    "lazy_grid": ("mkindexp", [],
                  [("GYRA_ECOLI", GYRA), ("G2", GYRA[40:200])],
                  [(f"q{i}", GYRA[i * 18:i * 18 + 70]) for i in range(9)],
                  "searchp", []),
}

# (fixture, the port's extra flags)
CASES = [
    ("plain", ["--db-shards", "1"]), ("plain", ["--db-shards", "2"]),
    ("plain", ["--db-shards", "4"]),
    ("adaptive", ["--db-shards", "2"]), ("adaptive", ["--db-shards", "4"]),
    ("bisulfite", ["--db-shards", "4"]),
    ("words2", ["--db-shards", "2"]),
    ("grid", ["--q-shards", "2", "--db-shards", "1"]),
    ("grid", ["--q-shards", "4", "--db-shards", "2"]),
    ("grid", ["--q-shards", "2", "--db-shards", "4"]),
    ("delta2", ["--db-shards", "2"]), ("delta2", ["--db-shards", "4"]),
    ("lazy", ["--lazy-query", "--db-shards", "2"]),
    ("lazy_grid", ["--lazy-query", "--q-shards", "2", "--db-shards", "2",
                   "--query-batch", "4"]),
]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Each fixture's database indexed once (by the port's mkindex: its
    index bytes are the JAX package's) and its JAX CLI m8, made once."""
    made = {}

    def get(name):
        if name not in made:
            mk, mk_flags, db, qs, se, flags = FIXTURES[name]
            d = tmp_path_factory.mktemp(f"mesh_{name}")
            lit = d / "db.lit"
            assert tcli.main([mk, "-d", str(_write(d / "db.fasta", db)),
                              "-i", str(lit), "-v", "0", *mk_flags]) == 0
            q = _write(d / "q.fasta", qs)
            out = d / "jax.m8"
            assert jcli.main([se, "-q", str(q), "-i", str(lit), "-o",
                              str(out), "-v", "0", *flags]) == 0
            made[name] = (d, lit, q, out.read_bytes())
        return made[name]

    return get


@pytest.mark.parametrize("name,extra", CASES,
                         ids=[f"{n}-{'_'.join(e).replace('--', '')}"
                              for n, e in CASES])
def test_port_mesh_cli_equals_jax(fixtures, name, extra):
    d, lit, q, want = fixtures(name)
    se, flags = FIXTURES[name][4], FIXTURES[name][5]
    assert want.strip(), "fixture must produce matches"
    out = d / f"port_{'_'.join(extra)}.m8"
    assert tcli.main([se, "-q", str(q), "-i", str(lit), "-o", str(out),
                      "-v", "0", "--device", "cpu", *flags, *extra]) == 0
    assert out.read_bytes() == want


def test_port_mesh_prebuilt_artifact_equals_jax(fixtures):
    """mkindexp --shards 4 searched with --db-shards 4 (the shards feed the
    cells directly) and with --db-shards 2 (the index is split again)."""
    d, lit, q, want = fixtures("grid")
    lit4 = d / "db_s4.lit"
    assert tcli.main(["mkindexp", "-d", str(d / "db.fasta"), "-i",
                      str(lit4), "-v", "0", "--shards", "4"]) == 0
    for n in ("4", "2"):
        out = d / f"prebuilt{n}.m8"
        assert tcli.main(["searchp", "-q", str(q), "-i", str(lit4), "-o",
                          str(out), "-v", "0", "--device", "cpu",
                          "--db-shards", n]) == 0
        assert out.read_bytes() == want, n


def test_port_mesh_shard_subset_equals_jax(fixtures):
    """docs/MULTIHOST.md's per-host command: --shard-subset of a sharded
    index together with --db-shards over the host's devices gives the
    JAX CLI's bytes for the same slice."""
    d, lit, q, _ = fixtures("grid")
    lit2 = d / "db_s2.lit"
    assert tcli.main(["mkindexp", "-d", str(d / "db.fasta"), "-i",
                      str(lit2), "-v", "0", "--shards", "2"]) == 0
    outs = {}
    for cli, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        out = d / f"subset_{cli is tcli}.m8"
        assert cli.main(["searchp", "-q", str(q), "-i", str(lit2), "-o",
                         str(out), "-v", "0", "--shard-subset", "0",
                         "--db-shards", "2", *extra]) == 0
        outs[cli is tcli] = out.read_bytes()
    assert outs[False].strip() and outs[True] == outs[False]


@pytest.fixture(scope="module")
def stream_fixture(tmp_path_factory):
    """tests/test_db_stream.py's database (GYRA and 23 random proteins)
    and queries (mutated homolog fragments and true negatives)."""
    d = tmp_path_factory.mktemp("mesh_stream")
    rng = np.random.default_rng(11)
    recs = [fasta.SeqRecord("GYRA_ECOLI gyrase", GYRA.encode())]
    for i in range(23):
        recs.append(fasta.SeqRecord(
            f"rand{i}",
            "".join(rng.choice(list(AA), int(rng.integers(120, 350))))
            .encode()))
    fasta.write_fasta(d / "db.fasta", recs)
    qs = [fasta.SeqRecord("q_gyra", GYRA[40:140].encode())]
    for i in range(9):
        if i % 3 != 2:
            src = recs[1 + (i * 5) % 23].seq.decode()
            st = int(rng.integers(0, max(1, len(src) - 90)))
            frag = list(src[st:st + 85])
            for _ in range(8):
                frag[int(rng.integers(0, len(frag)))] = \
                    str(rng.choice(list(AA)))
            qs.append(fasta.SeqRecord(f"q{i}", "".join(frag).encode()))
        else:
            qs.append(fasta.SeqRecord(
                f"q{i}", "".join(rng.choice(list(AA), 85)).encode()))
    fasta.write_fasta(d / "q.fasta", qs)
    lit = d / "db.lit"
    assert tcli.main(["mkindexp", "-d", str(d / "db.fasta"), "-i", str(lit),
                      "-v", "0"]) == 0
    return d, d / "q.fasta", lit


def test_stream_fixture_mesh2_equals_jax(stream_fixture):
    """tests/test_db_stream.py's mesh2 case: default options, --db-shards
    2, the JAX package's resident bytes."""
    d, q, lit = stream_fixture
    outs = {}
    for cli, tag, extra in ((jcli, "jax", []),
                            (tcli, "mesh2", ["--db-shards", "2",
                                             "--device", "cpu"])):
        out = d / f"{tag}.m8"
        assert cli.main(["searchp", "-q", str(q), "-i", str(lit), "-o",
                         str(out), "-v", "0", *extra]) == 0
        outs[tag] = out.read_bytes()
    assert outs["jax"].strip() and outs["mesh2"] == outs["jax"]


@pytest.mark.parametrize("delta", [1, 2])
def test_mesh_budget_retry_equals_jax_mesh(stream_fixture, delta):
    """Tiny per-cell hit budgets (max_hits_per_query_frame 4: 32 hit slots
    per cell) force the overflow retry through the mesh: the port's
    matches and the scale its retries reached equal the JAX mesh's."""
    d, q, lit = stream_fixture

    def run(pkg):
        mod, ab_, pipe, st = pkg
        opt = mod.make_search_options(
            mod.Domain.PROTEIN, query_file=str(q), index_file=str(lit),
            output=str(d / "x.m8"), verbosity=0,
            max_hits_per_query_frame=4)
        opt.db_shards = 2
        opt.search_opts.max_seed_dist = delta
        ctx = (pipe.SearchContext(opt) if mod is jopt
               else pipe.SearchContext(opt, device="cpu"))
        seqs = [ab_.encode(r.seq, ctx.qry_orig_alph)
                for r in fasta.read_fasta(str(q))]
        stats = st()
        res = ctx.process_batch(seqs, opt.search_opts, stats)
        rows = sorted((qi, bm.n_s_id, bm.q_start, bm.q_end, bm.s_start,
                       bm.s_end, bm.raw_score)
                      for qi, ms in res.items() for bm in ms)
        return rows, dict(ctx._budget_scale), (
            stats.hits_after_seeding, stats.hits_overflow,
            stats.cursors_overflow)

    want = run((jopt, jab, jpipe, JStats))
    got = run((topt, tab, tpipe, TStats))
    assert want[0] and max(want[1].values()) > 1, "no retry"
    assert got == want


def test_mesh_refusals_as_jax(stream_fixture, capsys):
    """--q-shards that is no power of two <= 16, and --db-stream with the
    mesh: both CLIs exit 1 with the same message."""
    d, q, lit = stream_fixture
    for extra in (["--q-shards", "3"], ["--db-stream", "2", "--db-shards",
                                         "2"]):
        argv = ["searchp", "-q", str(q), "-i", str(lit), "-o",
                str(d / "refused.m8"), "-v", "0", *extra]
        assert jcli.main(argv) == 1
        want = capsys.readouterr().err
        assert tcli.main(argv + ["--device", "cpu"]) == 1
        assert capsys.readouterr().err == want and want
