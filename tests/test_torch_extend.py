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


def _dna_matches(mode: str):
    """A DNA5 batch: 6 subjects of 2 frames each (bisulfite's forward and
    reverse frames) and 16 query frames cut from them, C->T converted on
    even subject frames and G->A on odd ones (bisulfite) or with random
    substitutions (BLASTN), one seed hit per query frame, widened and
    merged by the JAX package."""
    rng = np.random.default_rng(61 if mode == "bisulfite" else 62)
    frames = [rng.integers(0, 4, int(rng.integers(150, 260))).astype(np.uint8)
              for _ in range(12)]
    offsets = np.zeros(len(frames) + 1, np.int64)
    offsets[1:] = np.cumsum([len(f) for f in frames])
    trans_concat = np.concatenate(frames)
    trans_q, mk = [], {k: [] for k in ("qry_id", "subj_id", "qry_start",
                                       "qry_end", "subj_start", "subj_end")}
    for g in range(16):
        sid = int(rng.integers(0, len(frames)))
        st = int(rng.integers(0, len(frames[sid]) - 90))
        q = frames[sid][st:st + 80].copy()
        if mode == "bisulfite":
            conv = (1, 3) if sid % 2 == 0 else (2, 0)   # C->T or G->A
            q[(q == conv[0]) & (rng.random(len(q)) < 0.8)] = conv[1]
        else:
            q[rng.integers(0, 80, 6)] = rng.integers(0, 4, 6)
        q[int(rng.integers(0, 80))] = 4                   # an N
        trans_q.append(q)
        for k, v in (("qry_id", g), ("subj_id", sid), ("qry_start", 20),
                     ("qry_end", 32), ("subj_start", st + 20),
                     ("subj_end", st + 32)):
            mk[k].append(v)
    mk = {k: np.asarray(v, np.int64) for k, v in mk.items()}
    qlens = np.array([len(f) for f in trans_q], np.int64)
    jm = jx.widen_and_merge(jx.MatchBatch(**mk), qlens,
                            offsets[1:] - offsets[:-1], StatsHolder())
    tq = np.zeros((len(trans_q), 96), np.int8)
    for g, f in enumerate(trans_q):
        tq[g, :len(f)] = f
    resident = (torch.as_tensor(tq), torch.as_tensor(trans_concat.astype(
        np.int8)), torch.as_tensor(offsets[:-1]),
        torch.as_tensor(offsets[1:] - offsets[:-1]))
    if mode == "bisulfite":
        schemes = [scoring.make_bisulfite_scheme(2, -3, -5, -2, d)
                   for d in ("fwd", "rev")]
    else:
        schemes = [scoring.make_nucleotide_scheme(2, -3, -5, -2)] * 2
    exts = [sw_xla.extend_matrix(s.matrix) for s in schemes]
    windows = (jx.SubjectWindows(trans_concat, offsets),
               tx.SubjectWindows(trans_concat, offsets))
    return (jm, trans_q, windows, exts, schemes[0].dp_gap_first,
            schemes[0].dp_gap_extend, resident)


@pytest.mark.parametrize("mode", ["blastn", "bisulfite"])
def test_dna_pass1_and_pass2_match_jax(monkeypatch, mode):
    """The kernels' host entry points at the DNA width (C 6: DNA5 and
    PAD): pass-1 scores with one launch per (qlen, band, matrix) class,
    the host pass 2 and K2's path all equal the JAX package's; bisulfite
    scores odd subject frames with the reverse matrix, in two classes."""
    jm, trans_q, (jw, tw), (fwd, rev), gf, ge, resident = _dna_matches(mode)
    bs = mode == "bisulfite"
    tm = tx.MatchBatch(*jm._arrays())
    want, _ = jx._run_bucketed(jm, trans_q, jw, fwd, rev, gf, ge, bs,
                               with_trace=False)
    st = StatsHolder()
    e8 = [tx.sw_band.ext8_from_ext32(e) for e in (fwd, rev)]
    assert e8[0].shape == (6, 6)
    got = tx.sw_scores_device(tm, *resident, *e8, gf, ge, bs, stats=st)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() >= 12
    classes = tx.bucket_groups(*tx._ext_geometry(tm)[:2],
                               (tm.subj_id % 2 == 1) if bs
                               else np.zeros(len(tm), bool))
    assert st.ext_dispatches == len(classes)
    assert {r for _, _, r in classes} == ({False, True} if bs else {False})
    if bs:       # the reverse matrix changes the odd frames' scores
        alias = tx.sw_scores_device(tm, *resident, e8[0], e8[0], gf, ge, bs)
        assert (alias != got).any()

    want2 = jx.trace_pass(jm, trans_q, jw, fwd, rev, gf, ge, bs)
    host = tx.trace_pass(tm, trans_q, tw, fwd, rev, gf, ge, bs)
    np.testing.assert_array_equal(host[0], want2[0])
    assert host[1] == want2[1]
    np.testing.assert_array_equal(host[2], want2[2])
    monkeypatch.setenv("LAMBDA_SW_TRACE", "device")
    want3 = jx.trace_pass(jm, trans_q, jw, fwd, rev, gf, ge, bs)
    dev = tx.trace_pass(tm, trans_q, tw, fwd, rev, gf, ge, bs,
                        resident=resident)
    np.testing.assert_array_equal(dev[0], want3[0])
    assert dev[1] == want3[1]
    np.testing.assert_array_equal(dev[0], host[0])
