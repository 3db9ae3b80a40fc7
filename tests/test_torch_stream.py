"""--db-stream N in the port against the JAX package, on the fixtures of
tests/test_db_stream.py: the JAX CLI's resident search and the port's
CLI (on the CPU), resident and streamed, write byte-equal m8, for the
default configuration, pigeonhole seeding, exact seeds, a prebuilt
sharded artifact and bisulfite; tiny per-shard budgets force the
overflow retry through the stream passes; the mesh conflict is refused
as the JAX package refuses it."""

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


@pytest.fixture(scope="module")
def db_and_query(tmp_path_factory):
    """tests/test_db_stream.py's database (GYRA and 23 random proteins)
    and queries (mutated homolog fragments and true negatives), indexed
    by the port's mkindexp (its index bytes are the JAX package's)."""
    d = tmp_path_factory.mktemp("torch_stream")
    rng = np.random.default_rng(11)
    AA = "ARNDCQEGHILKMFPSTWYV"
    recs = [fasta.SeqRecord("GYRA_ECOLI gyrase", GYRA.encode())]
    for i in range(23):
        recs.append(fasta.SeqRecord(
            f"rand{i}",
            "".join(rng.choice(list(AA), int(rng.integers(120, 350))))
            .encode()))
    db = d / "db.fasta"
    fasta.write_fasta(db, recs)
    qs = [fasta.SeqRecord("q_gyra", GYRA[40:140].encode())]
    for i in range(9):
        if i % 3 != 2:  # mutated homolog fragments
            src = recs[1 + (i * 5) % 23].seq.decode()
            st = int(rng.integers(0, max(1, len(src) - 90)))
            frag = list(src[st:st + 85])
            for _ in range(8):
                frag[int(rng.integers(0, len(frag)))] = \
                    str(rng.choice(list(AA)))
            qs.append(fasta.SeqRecord(f"q{i}", "".join(frag).encode()))
        else:           # true negative
            qs.append(fasta.SeqRecord(
                f"q{i}", "".join(rng.choice(list(AA), 85)).encode()))
    q = d / "q.fasta"
    fasta.write_fasta(q, qs)
    lit = d / "db.lit"
    assert tcli.main(["mkindexp", "-d", str(db), "-i", str(lit),
                      "-v", "0"]) == 0
    return d, db, q, lit


def search(cli, d, q, lit, tag, *extra, sub="searchp"):
    out = d / f"out_{tag}.m8"
    argv = [sub, "-q", str(q), "-i", str(lit), "-o", str(out), "-v", "0",
            *extra]
    if cli is tcli:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return out.read_bytes()


def test_stream_parity_default_config(db_and_query):
    """Default options (adaptive seeding, two phases, half-exact delta
    1): streamed shards give the JAX package's resident bytes."""
    d, db, q, lit = db_and_query
    base = search(jcli, d, q, lit, "jax")
    assert base.strip(), "fixture must produce matches"
    assert search(tcli, d, q, lit, "res") == base
    assert search(tcli, d, q, lit, "st2", "--db-stream", "2") == base
    assert search(tcli, d, q, lit, "st5", "--db-stream", "5") == base


@pytest.mark.parametrize("adapt", ["1", "0"])
def test_stream_parity_pigeonhole(db_and_query, adapt):
    """delta 2 (pigeonhole): the whole-seed abundance cutoff and adaptive
    elongation on shard-summed verified counts equal the single index's
    decisions, adaptive on and off."""
    d, db, q, lit = db_and_query
    args = ("--seed-delta", "2", "--seed-half-exact", "0",
            "--adaptive-seeding", adapt, "--search0", "0")
    base = search(jcli, d, q, lit, f"jd2a{adapt}", *args)
    assert base.strip()
    assert search(tcli, d, q, lit, f"d2a{adapt}", *args) == base
    assert search(tcli, d, q, lit, f"d2a{adapt}s3", "--db-stream", "3",
                  *args) == base


def test_stream_parity_nonadaptive_exact(db_and_query):
    d, db, q, lit = db_and_query
    args = ("--adaptive-seeding", "0", "--seed-delta", "0")
    base = search(jcli, d, q, lit, "jex", *args)
    assert search(tcli, d, q, lit, "ex3", "--db-stream", "3", *args) == base


def test_stream_prebuilt_sharded_artifact(db_and_query):
    """mkindex --shards N artifacts feed the stream passes directly
    when the counts match, and are re-split otherwise: both give the
    resident bytes."""
    d, db, q, lit = db_and_query
    lit3 = d / "db_s3.lit"
    assert tcli.main(["mkindexp", "-d", str(db), "-i", str(lit3), "-v", "0",
                      "--shards", "3"]) == 0
    base = search(jcli, d, q, lit, "jpb")
    assert search(tcli, d, q, lit3, "pb3", "--db-stream", "3") == base
    assert search(tcli, d, q, lit3, "pb2", "--db-stream", "2") == base


def test_stream_bisulfite_parity(tmp_path):
    """Bisulfite streams too: the fwd/rev matrix selection rides the
    frame-id parity, which subject-contiguous shards preserve."""
    rng = np.random.default_rng(3)
    DNA = "ACGT"
    recs = [fasta.SeqRecord(
        f"s{i}", "".join(rng.choice(list(DNA), 300)).encode())
        for i in range(8)]
    db = tmp_path / "db.fasta"
    fasta.write_fasta(db, recs)
    qs = []
    for i in range(4):
        src = list(recs[i].seq.decode()[50:150])
        for j, c in enumerate(src):          # C->T conversions
            if c == "C" and rng.random() < 0.7:
                src[j] = "T"
        qs.append(fasta.SeqRecord(f"q{i}", "".join(src).encode()))
    q = tmp_path / "q.fasta"
    fasta.write_fasta(q, qs)
    lit = tmp_path / "db.lit"
    assert tcli.main(["mkindexbs", "-d", str(db), "-i", str(lit),
                      "-v", "0"]) == 0
    args = ("-e", "0.1")
    base = search(jcli, tmp_path, q, lit, "jbs", *args, sub="searchbs")
    assert base.strip()
    assert search(tcli, tmp_path, q, lit, "bs3", "--db-stream", "3", *args,
                  sub="searchbs") == base


def test_stream_budget_retry_parity(db_and_query):
    """Tiny per-shard hit budgets force the overflow retry through the
    stream passes (pass B again; pigeonhole's decisions taken again):
    the matches equal the JAX package's generous-budget resident run."""
    d, db, q, lit = db_and_query

    def rows(res):
        return sorted((qi, bm.n_s_id, bm.q_start, bm.q_end, bm.s_start,
                       bm.s_end, bm.raw_score)
                      for qi, ms in res.items() for bm in ms)

    def run(pkg, stream, max_hits, delta):
        mod, ab_, pipe, st = pkg
        opt = mod.make_search_options(
            mod.Domain.PROTEIN, query_file=str(q), index_file=str(lit),
            output=str(d / "x.m8"), verbosity=0,
            max_hits_per_query_frame=max_hits)
        opt.db_stream = stream
        opt.search_opts.max_seed_dist = delta
        ctx = (pipe.SearchContext(opt) if mod is jopt
               else pipe.SearchContext(opt, device="cpu"))
        seqs = [ab_.encode(r.seq, ctx.qry_orig_alph)
                for r in fasta.read_fasta(str(q))]
        res = ctx.process_batch(seqs, opt.search_opts, st())
        return rows(res), max(ctx._budget_scale.values(), default=1)

    jax_pkg = (jopt, jab, jpipe, JStats)
    port = (topt, tab, tpipe, TStats)
    for delta in (1, 2):
        ref, _ = run(jax_pkg, 1, 2048, delta)
        assert ref
        tiny, scale = run(port, 3, 4, delta)  # 32 hit slots per shard
        assert scale > 1, "the tiny budgets did not overflow"
        assert tiny == ref
        assert run(port, 3, 2048, delta)[0] == ref


def test_stream_mesh_conflict_refused_as_jax(db_and_query, capsys):
    """--db-stream with --db-shards: both CLIs exit 1 with the same
    message."""
    d, db, q, lit = db_and_query
    argv = ["searchp", "-q", str(q), "-i", str(lit), "-o",
            str(d / "refused.m8"), "-v", "0", "--db-stream", "2",
            "--db-shards", "2"]
    assert jcli.main(argv) == 1
    want = capsys.readouterr().err
    assert tcli.main(argv + ["--device", "cpu"]) == 1
    got = capsys.readouterr().err
    assert "db-stream" in got and got == want


@pytest.mark.parametrize("prebuilt", [False, True])
def test_stream_shards_equal_jax_mesh_host_arrays(db_and_query, prebuilt):
    """The port's parallel/mesh.py (the host half) splits the index into
    the JAX package's shard arrays, padding rows 0xFFFFFFFF included."""
    from lambda_tpu.index import artifact as jart
    from lambda_tpu.parallel import mesh as jmesh
    from lambda_tpu_torch.index import artifact as tart
    from lambda_tpu_torch.parallel import mesh as tmesh

    d, db, q, lit = db_and_query
    path = d / "db_s3.lit" if prebuilt else lit
    if prebuilt and not path.exists():
        assert tcli.main(["mkindexp", "-d", str(db), "-i", str(path),
                          "-v", "0", "--shards", "3"]) == 0
    ji, ti = jart.load_index(str(path)), tart.load_index(str(path))
    red = np.arange(len(ji.trans_concat), dtype=np.int64).astype(np.int8)
    if prebuilt:
        want = jmesh.shard_prebuilt_index(ji, red)
        got = tmesh.shard_prebuilt_index(ti, red)
    else:
        args = (ji.trans_concat, red, ji.trans_offsets, ji.trans_lengths, 4)
        want = jmesh.shard_loaded_index(ji.get_kmer(), *args)
        got = tmesh.shard_loaded_index(ti.get_kmer(), *args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    pad = got["keys"][got["pos"] == 0]
    assert (pad == 0xFFFFFFFF).all(axis=1).any()
