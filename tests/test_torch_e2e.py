"""End to end: the JAX package's run_search and the port's run_search (on
the CPU) on one random protein database give byte-equal m8, and the
port's output does not depend on the query batch size."""

import gzip

import numpy as np
import pytest

from lambda_tpu import options as jopt
from lambda_tpu.index import artifact as jart
from lambda_tpu.io import fasta
from lambda_tpu.search import pipeline as jpipe
from lambda_tpu_torch import options as topt
from lambda_tpu_torch.search import pipeline as tpipe

AA = "ARNDCQEGHILKMFPSTWYV"


@pytest.fixture(scope="module")
def e2e_case(tmp_path_factory):
    """200 random subjects of 400 aa and 64 queries mixed like
    bench_e2e.py: 70 % homolog fragments (120 aa, 12 substitutions),
    30 % random sequences."""
    d = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(5)
    letters = np.frombuffer(AA.encode(), np.uint8)
    db = letters[rng.integers(0, 20, (200, 400))]
    fasta.write_fasta(d / "db.fasta", [fasta.SeqRecord(f"s{i}", r.tobytes())
                                       for i, r in enumerate(db)])
    qs = []
    for i in range(64):
        if i % 10 < 7:
            src = db[int(rng.integers(0, 200))]
            st = int(rng.integers(0, 280))
            frag = src[st:st + 120].copy()
            frag[rng.integers(0, 120, 12)] = letters[rng.integers(0, 20, 12)]
        else:
            frag = letters[rng.integers(0, 20, 120)]
        qs.append(fasta.SeqRecord(f"q{i}", frag.tobytes()))
    fasta.write_fasta(d / "q.fasta", qs)
    iopts = jopt.IndexerOptions(domain=jopt.Domain.PROTEIN,
                                db_file=str(d / "db.fasta"),
                                index_file=str(d / "db.lit"))
    jart.save_index(jart.build_index(iopts), str(d / "db.lit"))
    return d


def _search(mod_opt, d, out, profile="none", **kw):
    opt = mod_opt.make_search_options(
        mod_opt.Domain.PROTEIN, query_file=str(d / "q.fasta"),
        index_file=str(d / "db.lit"), output=str(out), verbosity=0)
    for k, v in kw.items():
        setattr(opt, k, v)
    mod_opt.apply_profile(opt, profile)
    mod_opt.detect_output_format(opt)
    return opt


@pytest.mark.parametrize("suffix,kw", [
    (".m8", {}),
    (".m9.gz", {}),
    (".m8", dict(lazy_qry_file=True, max_matches=3)),
    (".m8", dict(iterative_search=False, merge_annotations=True)),
    (".m8", dict(adaptive_seeding=False)),
    (".m8", dict(profile="sensitive")),
], ids=["default", "m9_gz", "lazy_n3", "one_phase_annot", "no_adaptive",
        "sensitive"])
def test_port_run_search_matches_jax(e2e_case, suffix, kw):
    d = e2e_case
    jpipe.run_search(_search(jopt, d, d / f"jax{suffix}", **kw))
    tpipe.run_search(_search(topt, d, d / f"port{suffix}", **kw),
                     device="cpu")
    want, got = ((d / f"{who}{suffix}").read_bytes()
                 for who in ("jax", "port"))
    if suffix.endswith(".gz"):
        want, got = gzip.decompress(want), gzip.decompress(got)
    assert len(want) > 2000, "fixture found too few hits"
    # the m9 header names the program; that tag is the one difference
    assert got.replace(b"LAMBDA-TPU-TORCH-", b"LAMBDA-TPU-") == want


def test_port_output_independent_of_batch_size(e2e_case):
    d = e2e_case
    outs = []
    for qb in (16, 512):
        out = d / f"port_qb{qb}.m8"
        tpipe.run_search(_search(topt, d, out, query_batch_size=qb),
                         device="cpu")
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("kw", [{}, dict(iterative_search=False)],
                         ids=["default", "one_phase"])
def test_device_trace_matches_jax_and_default(e2e_case, monkeypatch, kw):
    """LAMBDA_SW_TRACE=device (pass 2 through K2's plain version and the
    host walk, statistics per match) gives the same m8 as JAX under the
    same variable and as the port's own default (host C++) pass 2."""
    d = e2e_case
    tag = "_".join(kw) or "default"
    tpipe.run_search(_search(topt, d, d / f"port_host_{tag}.m8", **kw),
                     device="cpu")
    monkeypatch.setenv("LAMBDA_SW_TRACE", "device")
    jpipe.run_search(_search(jopt, d, d / f"jax_dev_{tag}.m8", **kw))
    tpipe.run_search(_search(topt, d, d / f"port_dev_{tag}.m8", **kw),
                     device="cpu")
    host, want, got = ((d / f"{who}_{tag}.m8").read_bytes()
                       for who in ("port_host", "jax_dev", "port_dev"))
    assert len(want) > 2000, "fixture found too few hits"
    assert got == want
    assert got == host
