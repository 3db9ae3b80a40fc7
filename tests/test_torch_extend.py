"""The port's extension stage (lambda_tpu_torch.search.extend) against the
JAX package's: widen/merge, the shape-class bucketing, pass-1 scores
(the port's sw_scores_device on the CPU, i.e. device-side window gather +
plain K1, against JAX ``_run_bucketed(with_trace=False)``) and pass-2
traceback statistics, on the same MatchBatch of real seed hits."""

import numpy as np
import pytest
import torch

from lambda_tpu import scoring
from lambda_tpu.ops import sw_xla
from lambda_tpu.search import extend as jx
from lambda_tpu.stats import StatsHolder
from lambda_tpu_torch.search import extend as tx
from tests.test_torch_seeding import cfg_for, run_both, seeding_inputs


@pytest.fixture(scope="module")
def matches():
    idx, trans_concat, offsets, lengths, trans_q, red_q = seeding_inputs(
        47, n_qry=30)
    j, _ = run_both(idx, trans_concat, offsets, lengths, trans_q, red_q,
                    cfg_for(idx, 11, 3, 1))
    n = int(j["stats_vec"][4])
    p = j["packed"][:n].astype(np.int64)
    seed_len = p[:, 3] & 0xFF
    mk = dict(qry_id=p[:, 3] >> 8, subj_id=p[:, 0], qry_start=p[:, 2],
              qry_end=p[:, 2] + seed_len, subj_start=p[:, 1],
              subj_end=p[:, 1] + seed_len)
    qlens = np.array([len(f) for f in trans_q], np.int64)
    return dict(mk=mk, qlens=qlens, slens=lengths.astype(np.int64),
                trans_q=trans_q, trans_concat=trans_concat, offsets=offsets)


def _merged(mod, f):
    st = StatsHolder()
    m = mod.widen_and_merge(mod.MatchBatch(**{k: v.copy()
                                              for k, v in f["mk"].items()}),
                            f["qlens"], f["slens"], st)
    return m, st


def test_widen_and_merge_matches_jax(matches):
    jm, jst = _merged(jx, matches)
    tm, tst = _merged(tx, matches)
    assert len(jm) > 20
    for a, b in zip(tm._arrays(), jm._arrays()):
        np.testing.assert_array_equal(a, b)
    assert (tst.hits_merged, tst.hits_duplicate) == \
        (jst.hits_merged, jst.hits_duplicate)


def test_bucket_groups_match_jax(matches):
    jm, _ = _merged(jx, matches)
    qlen, d_row, _ = jx._ext_geometry(jm)
    rev = np.arange(len(jm)) % 3 == 0
    assert tx.bucket_groups(qlen, d_row, rev) == \
        jx.bucket_groups(qlen, d_row, rev)
    for n in (1, 16, 17, 8192, 9000):
        assert tx._bucket(n) == jx._bucket(n)
    for n in (0, 7, 8, 40, 1023, 1500):
        assert tx._bucket_d(n) == jx._bucket_d(n)


def _pass1_both(matches):
    """Pass-1 scores of the merged matches: JAX ``_run_bucketed`` (CPU
    backend) and the port's ``sw_scores_device`` on CPU tensors."""
    jm, _ = _merged(jx, matches)
    sch = scoring.make_protein_scheme(62, -11, -1)
    ext = sw_xla.extend_matrix(sch.matrix)
    gf, ge = sch.dp_gap_first, sch.dp_gap_extend
    windows = jx.SubjectWindows(matches["trans_concat"], matches["offsets"])
    want, _ = jx._run_bucketed(jm, matches["trans_q"], windows, ext, ext,
                               gf, ge, False, with_trace=False)

    trans_q = matches["trans_q"]
    tq = np.zeros((len(trans_q), max(map(len, trans_q))), np.int8)
    for g, f in enumerate(trans_q):
        tq[g, :len(f)] = f
    tm = tx.MatchBatch(*jm._arrays())
    e8 = tx.sw_band.ext8_from_ext32(ext)
    st = StatsHolder()
    got = tx.sw_scores_device(
        tm, torch.as_tensor(tq), torch.as_tensor(matches["trans_concat"]),
        torch.as_tensor(matches["offsets"][:-1].astype(np.int64)),
        torch.as_tensor(matches["offsets"][1:] - matches["offsets"][:-1]),
        e8, e8, gf, ge, False, stats=st)
    return tm, st, got, want


def test_pass1_scores_match_jax(matches):
    tm, st, got, want = _pass1_both(matches)
    assert (want > 0).sum() > 20
    np.testing.assert_array_equal(got, want)
    assert st.ext_dispatches == len(
        tx.bucket_groups(*tx._ext_geometry(tm)[:2], np.zeros(len(tm), bool)))


@pytest.mark.parametrize("x_drop", [1, 3, 5])
def test_pass1_scores_xdrop_match_jax(matches, monkeypatch, x_drop):
    """LAMBDA_SW_XDROP (latched in both packages, set here on the
    modules): the port's pass 1 takes each class's column chunk from the
    JAX plan and gives JAX's X-drop scores, which differ from the exact
    ones."""
    from lambda_tpu.ops import sw_band as jsw

    _, _, exact, _ = _pass1_both(matches)
    monkeypatch.setattr(jsw, "_XDROP", x_drop)
    monkeypatch.setattr(tx.sw_band, "_XDROP", x_drop)
    _, _, got, want = _pass1_both(matches)
    np.testing.assert_array_equal(got, want)
    assert (got != exact).any() and (got <= exact).all()


def test_trace_pass_matches_jax(matches):
    jm, _ = _merged(jx, matches)
    sch = scoring.make_protein_scheme(62, -11, -1)
    ext = sw_xla.extend_matrix(sch.matrix)
    gf, ge = sch.dp_gap_first, sch.dp_gap_extend
    jw = jx.SubjectWindows(matches["trans_concat"], matches["offsets"])
    tw = tx.SubjectWindows(matches["trans_concat"], matches["offsets"])
    want = jx.trace_pass(jm, matches["trans_q"], jw, ext, ext, gf, ge, False)
    got = tx.trace_pass(tx.MatchBatch(*jm._arrays()), matches["trans_q"], tw,
                        ext, ext, gf, ge, False)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_trace_pass_device_matches_jax_and_host(matches, monkeypatch):
    """LAMBDA_SW_TRACE=device: pass 2 through K2's path (device-side
    window gather, plain K2 on the CPU, host walk) gives JAX's scores and
    traces under the same variable and the default host pass's, with no
    statistics array."""
    jm, _ = _merged(jx, matches)
    sch = scoring.make_protein_scheme(62, -11, -1)
    ext = sw_xla.extend_matrix(sch.matrix)
    gf, ge = sch.dp_gap_first, sch.dp_gap_extend
    jw = jx.SubjectWindows(matches["trans_concat"], matches["offsets"])
    tw = tx.SubjectWindows(matches["trans_concat"], matches["offsets"])
    tm = tx.MatchBatch(*jm._arrays())
    host = tx.trace_pass(tm, matches["trans_q"], tw, ext, ext, gf, ge, False)
    trans_q = matches["trans_q"]
    tq = np.zeros((len(trans_q), max(map(len, trans_q))), np.int8)
    for g, f in enumerate(trans_q):
        tq[g, :len(f)] = f
    resident = (torch.as_tensor(tq), torch.as_tensor(matches["trans_concat"]),
                torch.as_tensor(matches["offsets"][:-1].astype(np.int64)),
                torch.as_tensor(matches["offsets"][1:]
                                - matches["offsets"][:-1]))
    monkeypatch.setenv("LAMBDA_SW_TRACE", "device")
    want = jx.trace_pass(jm, trans_q, jw, ext, ext, gf, ge, False)
    got = tx.trace_pass(tm, trans_q, tw, ext, ext, gf, ge, False,
                        resident=resident)
    assert got[2] is None and want[2] is None
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], host[0])
    assert got[1] == host[1]
    assert sum(t is not None for t in got[1]) > 20
    with pytest.raises(ValueError):
        tx.trace_pass(tm, trans_q, tw, ext, ext, gf, ge, False)
