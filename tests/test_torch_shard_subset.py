"""--shard-subset and merge_m8 in the port against the JAX package, on
the fixture of tests/test_shard_artifact.py: each host's slice of a
sharded index gives the JAX package's bytes, the slices' union is the
full run line for line, the port's merge_m8 reassembles them, and the
SAM header under a subset is the full run's."""

import numpy as np
import pytest

from lambda_tpu import cli as jcli
from lambda_tpu.io import fasta
from lambda_tpu_torch import cli as tcli
from tests.test_e2e import GYRA


@pytest.fixture(scope="module")
def db_and_query(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_shard_subset")
    rng = np.random.default_rng(42)
    AA = "ARNDCQEGHILKMFPSTWYV"
    recs = [fasta.SeqRecord("GYRA_ECOLI gyrase", GYRA.encode())]
    for i in range(7):
        recs.append(fasta.SeqRecord(
            f"rand{i}", "".join(rng.choice(list(AA), 150)).encode()))
    db = d / "db.fasta"
    fasta.write_fasta(db, recs)
    q = d / "q.fasta"
    fasta.write_fasta(q, [
        fasta.SeqRecord("q1", GYRA[50:130].encode()),
        fasta.SeqRecord("q2", recs[4].seq[30:110]),
        fasta.SeqRecord("q3", recs[7].seq[10:100]),
    ])
    lit = d / "db.lit"
    assert tcli.main(["mkindexp", "-d", str(db), "-i", str(lit), "-v", "0",
                      "--shards", "2"]) == 0
    return d, q, lit


def _search(cli, d, q, lit, tag, *extra, suffix=".m8"):
    out = d / f"out_{tag}{suffix}"
    argv = ["searchp", "-q", str(q), "-i", str(lit), "-o", str(out),
            "-v", "0", "--adaptive-seeding", "0", *extra]
    if cli is tcli:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return out.read_bytes()


@pytest.mark.parametrize("annot", ["0", "1"])
def test_shard_subset_search_union(db_and_query, annot):
    """Each host's slice equals the JAX package's; without annotations
    the slices' union is the full run line for line (dbTotalLength and
    e-values stay global), with them (the default) each line carries the
    merge column."""
    d, q, lit = db_and_query
    full = _search(tcli, d, q, lit, "full", "-n", "500")
    assert full == _search(jcli, d, q, lit, "jfull", "-n", "500")
    lines = []
    for k in ("0", "1"):
        args = ("-n", "500", "--shard-subset", k, "--merge-annotations",
                annot)
        got = _search(tcli, d, q, lit, f"s{k}a{annot}", *args)
        assert got == _search(jcli, d, q, lit, f"js{k}a{annot}", *args)
        lines.append(set(got.decode().splitlines()))
    assert lines[0] and lines[1] and not (lines[0] & lines[1])
    if annot == "0":
        assert lines[0] | lines[1] == set(full.decode().splitlines())
    else:
        assert all(ln.split("\t")[-1].startswith("X:")
                   for ln in lines[0] | lines[1])


def test_merge_m8_tool(db_and_query, tmp_path):
    """The port's merge_m8 (a copy of the JAX package's tool) reassembles
    the per-host outputs (annotation column on by default under a
    subset, detected and stripped): the merged line set is the full
    run's, and equals the JAX tool's merge byte for byte."""
    from lambda_tpu.tools import merge_m8 as jmerge
    from lambda_tpu_torch.tools import merge_m8 as tmerge

    d, q, lit = db_and_query
    full = _search(tcli, d, q, lit, "mfull", "-n", "500")
    for k in ("0", "1"):
        _search(tcli, d, q, lit, f"m{k}", "-n", "500", "--shard-subset", k)
    parts = [str(d / "out_m0.m8"), str(d / "out_m1.m8")]
    out, jout = tmp_path / "merged.m8", tmp_path / "jmerged.m8"
    assert tmerge.main([str(out), *parts]) == 0
    jmerge.merge(parts, str(jout))
    merged = out.read_text().splitlines()
    assert set(merged) == set(full.decode().splitlines())
    assert out.read_bytes() == jout.read_bytes()
    last_q, last_bs = None, None
    for ln in merged:
        f = ln.split("\t")
        bs = float(f[11])
        if f[0] == last_q:
            assert bs <= last_bs + 1e-9
        last_q, last_bs = f[0], bs


def test_shard_subset_refusals_as_jax(db_and_query, tmp_path, capsys):
    """A subset of an unsharded index, and --db-stream with a subset:
    both CLIs exit 1 with the same message."""
    d, q, lit = db_and_query
    lit1 = tmp_path / "one.lit"
    assert tcli.main(["mkindexp", "-d", str(d / "db.fasta"), "-i",
                      str(lit1), "-v", "0"]) == 0
    for idx, extra in ((lit1, ["--shard-subset", "0"]),
                       (lit, ["--shard-subset", "0", "--db-stream", "2"])):
        argv = ["searchp", "-q", str(q), "-i", str(idx), "-o",
                str(tmp_path / "x.m8"), "-v", "0", *extra]
        assert jcli.main(argv) == 1
        want = capsys.readouterr().err
        assert tcli.main(argv + ["--device", "cpu"]) == 1
        assert capsys.readouterr().err == want and want


def test_shard_subset_sam_header(db_and_query):
    """SAM under --shard-subset: the header (but @PG, which embeds the
    command line) equals the full run's and the JAX package's; records
    cover the subset's subjects."""
    d, q, lit = db_and_query

    def sam(cli, tag, *extra):
        return _search(cli, d, q, lit, tag, "--sam-with-refheader", *extra,
                       suffix=".sam").decode()

    full = sam(tcli, "samfull")
    part = sam(tcli, "sam0", "--shard-subset", "0")
    jpart = sam(jcli, "jsam0", "--shard-subset", "0")

    def hdr(t):
        return [ln for ln in t.splitlines()
                if ln.startswith("@") and not ln.startswith("@PG")]

    def body(t):
        return {ln for ln in t.splitlines() if not ln.startswith("@")}

    assert hdr(part) == hdr(full) == hdr(jpart)
    assert any(ln.startswith("@SQ") for ln in hdr(part))
    assert body(part) and body(part) <= body(full)
    assert body(part) == body(jpart)
