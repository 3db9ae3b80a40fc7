"""Parity of the port's fused seeder (lambda_tpu_torch.search.seeding) with
the JAX package's make_seeder: the packed hit rows and the stats vector
(including the cursor/hit overflow counts that drive the budget retry)
must be exactly equal, for both default BLASTP phases and for pigeonhole
seeding (seed delta 2 and 3); and of the port's db-stream passes with
make_stream_seeder's, shard by shard."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambda_tpu import alphabets as ab, frames as fr, scoring
from lambda_tpu.index.build import build_kmer_index
from lambda_tpu.ops import searchsorted as jss
from lambda_tpu.search import seeding as jseeding
from lambda_tpu_torch.search import seeding as tseeding
from lambda_tpu_torch.ops import searchsorted as tss

AA = "ACDEFGHIKLMNPQRSTVWY"


def protein_db(seed: int, n_subj: int = 300, n_qry: int = 24):
    """Random protein subjects, a third of them carrying a mutated copy of
    a segment of another subject (shared domains), and queries: 2/3
    mutated subject fragments with a small indel, 1/3 random sequences
    (numpy seed)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(AA.encode(), np.uint8)

    def mutate(x, rate):
        x = x.copy()
        for p in rng.integers(0, len(x), int(len(x) * rate)):
            x[p] = letters[rng.integers(0, 20)]
        return x

    subj = [letters[rng.integers(0, 20, int(rng.integers(60, 400)))]
            for _ in range(n_subj)]
    for i in range(0, n_subj, 3):
        src = subj[int(rng.integers(0, n_subj))]
        L = min(50, len(src), len(subj[i]))
        a = int(rng.integers(0, len(src) - L + 1))
        b = int(rng.integers(0, len(subj[i]) - L + 1))
        subj[i][b:b + L] = mutate(src[a:a + L], 0.1)
    qrys = []
    for i in range(n_qry):
        if i % 3 == 2:
            q = letters[rng.integers(0, 20, int(rng.integers(30, 150)))]
        else:
            src = subj[int(rng.integers(0, n_subj))]
            L = int(rng.integers(30, min(150, len(src)) + 1))
            st = int(rng.integers(0, len(src) - L + 1))
            q = mutate(src[st:st + L], 0.1)
            cut = int(rng.integers(5, L - 5))
            q = np.concatenate([q[:cut], q[cut + int(rng.integers(0, 3)):]]
                               if i % 2 else
                               [q[:cut], letters[rng.integers(0, 20, 2)],
                                q[cut:]])
        qrys.append(q)
    return ([s.tobytes().decode() for s in subj],
            [q.tobytes().decode() for q in qrys])


def seeding_inputs(seed: int, n_qry: int = 24, with_red: bool = False):
    """(index, subject concat, offsets, lengths, query frames, reduced
    query frames), and with ``with_red`` the reduced subject concat."""
    subj, qrys = protein_db(seed, n_qry=n_qry)
    trans_s = [ab.encode(s, ab.AMINO_ACID) for s in subj]
    red_s = fr.reduce_frames(trans_s, ab.AMINO_ACID, ab.LI10)
    red_concat, offsets, lengths = fr.concat_frames(red_s)
    trans_concat = np.concatenate(trans_s).astype(np.int8)
    idx = build_kmer_index(red_concat, offsets, ab.ALPHABET_SIZES[ab.LI10])
    trans_q = [ab.encode(q, ab.AMINO_ACID) for q in qrys]
    red_q = fr.reduce_frames(trans_q, ab.AMINO_ACID, ab.LI10)
    out = (idx, trans_concat, offsets, lengths, trans_q, red_q)
    return out + (red_concat.astype(np.int8),) if with_red else out


def cfg_for(idx, seed_length, seed_offset, delta, **kw):
    d = dict(seed_length=seed_length, seed_offset=seed_offset,
             max_seed_dist=delta, half_exact=True, adaptive=True,
             max_matches=25, pre_scoring=2, pre_scoring_thresh=2.0,
             alphabet_size=idx.alphabet_size, bits=idx.bits,
             cpw=idx.chars_per_word, words=idx.words,
             n_rows=idx.num_positions, max_cursors=4096, max_hits=16384,
             bucket_m=jss.pick_bucket_m(idx.bits, idx.chars_per_word,
                                        idx.num_positions))
    d.update(kw)
    return d


def query_arrays(trans_q, red_q, jcfg):
    """Seed slots and padded query rows of a batch (the pipeline's
    layout): (sf, sb, sr, tq, rq, ql)."""
    sf, sb, sr, T, _ = jseeding.compute_seed_slots(
        trans_q, 1, ab.AA27_CHAR_TO_RANK[ord("X")], jcfg)
    G = len(trans_q)
    Lmax = max(len(f) for f in trans_q) + 1
    tq = np.zeros((G, Lmax), np.int8)
    rq = np.zeros((G, Lmax), np.int8)
    ql = np.array([len(f) for f in trans_q], np.int32)
    for g in range(G):
        tq[g, :ql[g]] = trans_q[g]
        rq[g, :ql[g]] = red_q[g]
    return sf, sb, sr, tq, rq, ql


SUB = scoring.make_protein_scheme(62, -11, -1).matrix.astype(np.int32)


def t(a):
    return torch.as_tensor(np.asarray(a))


def run_both(idx, trans_concat, offsets, lengths, trans_q, red_q, cfgd,
             red_concat=None):
    """The JAX package's fused seeder and the port's on the same inputs
    (``red_concat``, the reduced subject concat, for pigeonhole)."""
    if red_concat is None:
        red_concat = np.zeros(1, np.int8)
    jcfg = jseeding.SeedConfig(**cfgd)
    tcfg = tseeding.SeedConfig(**{k: v for k, v in cfgd.items()
                                  if k != "n_rows"})
    sf, sb, sr, tq, rq, ql = query_arrays(trans_q, red_q, jcfg)
    sub = SUB
    bucket = jss.prefix_table(idx.keys[:, 0], idx.bits, cfgd["bucket_m"])
    keys = idx.keys
    pos = idx.pos.astype(np.int32)
    frame = idx.frame.astype(np.int32)
    soff = offsets[:-1].astype(np.int32)
    slen = lengths.astype(np.int32)

    _, _, fused = jseeding.make_seeder(jcfg)
    j = fused(*map(jnp.asarray, (keys, rq, ql, sf, sb, sr)),
              jnp.zeros(sf.shape[0], jnp.int32),
              *map(jnp.asarray, (pos, frame, soff, slen, trans_concat, tq)),
              jnp.asarray(red_concat), jnp.asarray(sub), jnp.asarray(sub),
              jnp.asarray(bucket))

    seeder = tseeding.make_seeder(tcfg)
    p = seeder(t(keys.astype(np.int64)), t(rq), t(ql), t(sf), t(sb), t(sr),
               torch.zeros(sf.shape[0], dtype=torch.int32),
               t(pos), t(frame), t(soff).long(), t(slen), t(trans_concat),
               t(tq), t(sub).long(), t(sub).long(), t(bucket).long(),
               red_sbj=t(red_concat))
    return ({k: np.asarray(j[k]) for k in ("packed", "stats_vec")},
            {k: p[k].numpy() for k in ("packed", "stats_vec")})


def both(inputs, cfgd):
    return run_both(*inputs[:6], cfgd, red_concat=inputs[6])


@pytest.fixture(scope="module")
def inputs():
    return seeding_inputs(31, with_red=True)


@pytest.mark.parametrize("phase,thresh", [((10, 5, 0), 2.0),
                                          ((11, 3, 1), 2.0),
                                          ((11, 3, 1), 5.5)],
                         ids=["phase0_delta0", "phase1_delta1",
                              "phase1_strict_prescore"])
def test_fused_seeder_matches_jax(inputs, phase, thresh):
    j, p = both(inputs, cfg_for(inputs[0], *phase,
                                     pre_scoring_thresh=thresh))
    assert j["stats_vec"][4] > 0, "fixture located nothing"
    if thresh > 2.0:
        assert j["stats_vec"][2] > 0, "no hit failed the prescore"
    np.testing.assert_array_equal(p["stats_vec"], j["stats_vec"])
    np.testing.assert_array_equal(p["packed"], j["packed"])


@pytest.mark.parametrize("budgets", [(64, 256), (4096, 128)],
                         ids=["cursor_budget", "hit_budget"])
def test_fused_seeder_overflow_counts_match_jax(inputs, budgets):
    """Small budgets: the overflow counts that drive the retry agree."""
    cfgd = cfg_for(inputs[0], 11, 3, 1, max_cursors=budgets[0],
                   max_hits=budgets[1])
    j, p = both(inputs, cfgd)
    assert j["stats_vec"][1] > 0 or j["stats_vec"][3] > 0
    np.testing.assert_array_equal(p["stats_vec"], j["stats_vec"])
    np.testing.assert_array_equal(p["packed"], j["packed"])


def test_seed_slots_copy_matches_jax(inputs):
    idx, _, _, _, trans_q, _, _ = inputs
    cfgd = cfg_for(idx, 11, 3, 1)
    want = jseeding.compute_seed_slots(trans_q, 1, 21,
                                       jseeding.SeedConfig(**cfgd))
    got = tseeding.compute_seed_slots(
        trans_q, 1, 21, tseeding.SeedConfig(**{k: v for k, v in cfgd.items()
                                               if k != "n_rows"}))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]
    assert tss.steps_for(idx.num_positions) == \
        jss.steps_for(idx.num_positions)


# pigeonhole (delta >= 2): seed length 11 (delta 2: chunks 4/4/3; delta 3:
# 3/3/3/2; half-exact: the exact first 5 characters), offset 3
PIGEON_CASES = [(d, h, a) for d in (2, 3) for h in (True, False)
                for a in (True, False)]


@pytest.mark.parametrize("delta,half,adaptive", PIGEON_CASES,
                         ids=[f"d{d}_{'half' if h else 'full'}_"
                              f"{'adapt' if a else 'fixed'}"
                              for d, h, a in PIGEON_CASES])
def test_fused_seeder_pigeonhole_matches_jax(inputs, delta, half, adaptive):
    j, p = both(inputs, cfg_for(inputs[0], 11, 3, delta,
                                     half_exact=half, adaptive=adaptive))
    assert j["stats_vec"][4] > 0, "fixture located nothing"
    np.testing.assert_array_equal(p["stats_vec"], j["stats_vec"])
    np.testing.assert_array_equal(p["packed"], j["packed"])


@pytest.mark.parametrize("budgets", [(64, 256), (4096, 128)],
                         ids=["cursor_budget", "hit_budget"])
def test_fused_seeder_pigeonhole_overflow_matches_jax(inputs, budgets):
    """Budgets that overflow: pigeonhole's verified counts (and so its
    decisions) are those of the truncated hit list, in both packages."""
    cfgd = cfg_for(inputs[0], 11, 3, 2, half_exact=False,
                   max_cursors=budgets[0], max_hits=budgets[1])
    j, p = both(inputs, cfgd)
    assert j["stats_vec"][1] > 0 or j["stats_vec"][3] > 0
    np.testing.assert_array_equal(p["stats_vec"], j["stats_vec"])
    np.testing.assert_array_equal(p["packed"], j["packed"])


STREAM_CASES = [("delta1_adaptive", (11, 3, 1), {}),
                ("delta0_fixed", (10, 5, 0), dict(adaptive=False)),
                ("pigeon_adaptive", (11, 3, 2), dict(half_exact=False)),
                ("pigeon_half_fixed", (11, 3, 2), dict(adaptive=False))]


@pytest.mark.parametrize("name,phase,kw", STREAM_CASES,
                         ids=[c[0] for c in STREAM_CASES])
def test_stream_passes_match_jax_shard_by_shard(inputs, name, phase, kw):
    """make_stream_seeder's three passes over 3 shards (the JAX package's
    shard_loaded_index): each shard's pass-A counts, the decisions on
    their sums, and each shard's pass-B packed rows and stats equal the
    JAX package's exactly."""
    from lambda_tpu.parallel import mesh as jmesh

    idx, trans_concat, offsets, lengths, trans_q, red_q, red_concat = inputs
    cfgd = cfg_for(idx, *phase, **kw)
    sh = jmesh.shard_loaded_index(idx, trans_concat, red_concat, offsets,
                                  lengths, 3)
    cfgd["n_rows"] = int(sh["keys"].shape[1])
    cfgd["bucket_m"] = 0
    jcfg = jseeding.SeedConfig(**cfgd)
    jst = jseeding.make_stream_seeder(jcfg)
    tst = tseeding.make_stream_seeder(tseeding.SeedConfig(
        **{k: v for k, v in cfgd.items() if k != "n_rows"}))
    assert tst["pigeon"] == jst["pigeon"] == (phase[2] >= 2)
    sf, sb, sr, tq, rq, ql = query_arrays(trans_q, red_q, jcfg)
    h0 = np.zeros(sf.shape[0], np.int32)
    slot_args = (rq, ql, sf, sb, sr)

    def shard(i):
        return [sh[n][i] for n in ("keys", "pos", "frame", "offsets",
                                   "lengths", "trans", "red")]

    def targs(a):
        return [t(x) if np.asarray(x).dtype != np.uint32 else
                t(np.asarray(x).astype(np.int64)) for x in a]

    def extra(i):
        keys, pos, frame, offs, lens, trans, red = shard(i)
        return (keys, *slot_args, h0, pos, frame, offs, lens, trans, tq,
                red, SUB, SUB)

    jacc = tacc = None
    for i in range(3):
        if jst["pigeon"]:
            ja = jst["pass_a"](*map(jnp.asarray, extra(i)))
            ta = tst["pass_a"](*targs(extra(i)))
        else:
            ja = jst["pass_a"](*map(jnp.asarray, (shard(i)[0], *slot_args)))
            ta = tst["pass_a"](*targs((shard(i)[0], *slot_args)))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        jacc = ja if jacc is None else jacc + ja
        tacc = ta if tacc is None else tacc + ta
    assert int(np.asarray(jacc).sum()) > 0
    jd = jst["decide"](jacc, *map(jnp.asarray, (ql, sf, sb, sr, h0)))
    td = tst["decide"](tacc, *targs((ql, sf, sb, sr, h0)))
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if jst["pigeon"]:            # decide gives (L, keep); pass B takes
        jd, td = jd[::-1], td[::-1]  # (keep, L), as the pipelines pass it
    n_sel = 0
    for i in range(3):
        jb = jst["pass_b"](*map(jnp.asarray, extra(i)), *jd)
        tb = tst["pass_b"](*targs(extra(i)), *td)
        np.testing.assert_array_equal(tb["stats_vec"].numpy(),
                                      np.asarray(jb["stats_vec"]))
        np.testing.assert_array_equal(tb["packed"].numpy(),
                                      np.asarray(jb["packed"]))
        n_sel += int(np.asarray(jb["stats_vec"])[4])
    assert n_sel > 0, "the streamed passes located nothing"
