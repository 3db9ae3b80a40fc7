"""The device half of the port's parallel/mesh.py against the JAX
package's, on the same numpy-seeded inputs, every comparison exact: the
fused demo step (make_sharded_search_step, K4's function per cell) on
the JAX package's virtual 8-device CPU mesh and on a grid of CPU devices,
the sharded seeder's hit sets (adaptive off and on, pigeonhole, and an
elongation budget that overflows), pass 1 over the grid's cells (with
and without X-drop, and a cell that holds no row of a class), and the
grid's placement and psum."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from lambda_tpu.ops import sw_band as jsw
from lambda_tpu.parallel import mesh as jmesh
from lambda_tpu.search import seeding as jseed
from lambda_tpu_torch import frames as tfr
from lambda_tpu_torch.index.build import build_kmer_index as tbuild
from lambda_tpu_torch.ops import sw_band as tsw, sw_rect
from lambda_tpu_torch.parallel import mesh as tmesh
from lambda_tpu_torch.search import extend as tx, seeding as tseed

CPU = torch.device("cpu")


def jax_mesh(q: int, db: int) -> JMesh:
    devs = np.array(jax.devices("cpu")[:q * db]).reshape(q, db)
    return JMesh(devs, ("q", "db"))


def jput(mesh, x, *axes):
    return jax.device_put(np.asarray(x), NamedSharding(mesh, P(*axes)))


def grid(q: int, db: int) -> tmesh.Mesh:
    return tmesh.Mesh([CPU] * (q * db), q, db)


# ---------------------------------------------------------------- grid


def test_mesh_places_once_per_device_and_sums_rows():
    """put_db shares one tensor among the cells of a db column that name
    the same device; put_q hands each q row its block; reduce_db is the
    sum over a row's cells, which it takes over."""
    m = grid(2, 3)
    x = np.arange(3 * 4, dtype=np.int32).reshape(3, 4)
    cells = m.put_db(x)
    assert cells[0] is cells[3] and cells[1] is cells[4]
    assert all(torch.equal(cells[c], torch.as_tensor(x[c % 3]))
               for c in range(6))
    q = m.put_q(np.arange(8).reshape(4, 2))
    assert torch.equal(q[4], torch.as_tensor([[4, 5], [6, 7]]))
    keys = m.put_db(np.full((3, 2, 4), 0xFFFFFFFF, np.uint32))
    assert keys[0].dtype == torch.int64 and int(keys[0].max()) == 0xFFFFFFFF
    parts = [cells[c].clone() for c in m.row(1)]    # handed over
    assert int(m.reduce_db(parts).sum()) == x.sum() and parts == []
    with pytest.raises(ValueError):
        tmesh.Mesh([CPU] * 3, 2, 2)


# ---------------------------------------------------------------- demo step


def _demo(cfg, n_db):
    frames, red_q, trans_q, subst = tmesh.make_demo_inputs(
        cfg, n_q=8, q_len=32, db_seq_len=256, n_db_frames=8)
    jf, jrq, jtq, jsub = jmesh.make_demo_inputs(
        cfg, n_q=8, q_len=32, db_seq_len=256, n_db_frames=8)
    for a, b in zip(frames + [red_q, trans_q, subst],
                    jf + [jrq, jtq, jsub]):
        np.testing.assert_array_equal(a, b)
    red_frames = [f.astype(np.uint8) for f in frames]
    shards = tmesh.shard_index(red_frames, cfg.alphabet_size, n_db,
                               words=cfg.words)
    stacked = tmesh.stack_shards(shards)
    jstacked = jmesh.stack_shards(jmesh.shard_index(
        red_frames, cfg.alphabet_size, n_db, words=cfg.words))
    for k in jstacked:
        np.testing.assert_array_equal(stacked[k], jstacked[k])
    sbj, sbj_len = tmesh.demo_subjects(shards, red_frames)
    return red_q, trans_q, subst, stacked, sbj, sbj_len


@pytest.mark.parametrize("n_db", [1, 2, 4, 8])
def test_search_step_equals_jax(n_db):
    """make_sharded_search_step on make_demo_inputs: the merged top-k and
    db_total equal the JAX step's on the virtual CPU mesh of the same
    shape, and the step's windowed SW ran through K4's wrapper."""
    cfg = tmesh.StepConfig(seeds_per_query=8, occ_cap=4, window=48, top_k=4)
    jcfg = jmesh.StepConfig(seeds_per_query=8, occ_cap=4, window=48, top_k=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    red_q, trans_q, subst, st, sbj, sbj_len = _demo(cfg, n_db)
    nq = 8 // n_db if n_db < 8 else 1
    jm = jax_mesh(nq, n_db)
    jstep = jmesh.make_sharded_search_step(jm, jcfg,
                                           n_rows_padded=st["keys"].shape[1])
    want, jtotal = jstep(
        jput(jm, red_q, "q", None), jput(jm, trans_q, "q", None),
        jput(jm, st["keys"], "db", None, None), jput(jm, st["pos"], "db",
                                                     None),
        jput(jm, st["rows"], "db"), jput(jm, sbj, "db", None),
        jput(jm, sbj_len, "db"), jput(jm, subst, None, None))
    m = grid(nq, n_db)
    step = tmesh.make_sharded_search_step(m, cfg)
    before = sw_rect.launches
    got, total = step(m.put_q(red_q), m.put_q(trans_q), m.put_db(st["keys"]),
                      m.put_db(st["pos"]), m.put_db(st["rows"]),
                      m.put_db(sbj), m.put_db(sbj_len), m.put_all(subst))
    assert sw_rect.launches == before         # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    assert int(total[0, 0]) == 8 * 256 and (got[:, 0] > 0).any()


# ---------------------------------------------------------------- seeder


@pytest.fixture(scope="module")
def seed_inputs():
    """tests/test_sharding.py's seeder fixture: 8 subjects of 300 chars
    over a 10-letter alphabet, 6 query fragments with a substitution,
    plus 10 more fragments (16 queries: q blocks of 8 for q 2)."""
    rng = np.random.default_rng(23)
    A = 10
    tf = [rng.integers(0, A, size=300).astype(np.uint8) for _ in range(8)]
    qfs = []
    for i in range(16):
        f = tf[i % 8][40 + 7 * (i // 8):140 + 7 * (i // 8)].copy()
        f[10] = (f[10] + 1) % A
        qfs.append(f)
    concat, offsets, lengths = tfr.concat_frames(tf)
    subst = np.full((A, A), -1, np.int32)
    np.fill_diagonal(subst, 2)
    return A, tf, qfs, concat, offsets, lengths, subst


def _cfgs(A, **kw):
    base = dict(seed_length=10, seed_offset=5, max_seed_dist=1,
                half_exact=False, adaptive=False, max_matches=64,
                pre_scoring=2, pre_scoring_thresh=1.0, alphabet_size=A,
                bits=4, cpw=8, words=4, max_cursors=1024, max_hits=4096)
    base.update(kw)
    jcfg = jseed.SeedConfig(n_rows=4096, **base)
    return tseed.SeedConfig(**base), jcfg


def _slots(cfg, qfs):
    slot_frame, slot_begin, slot_rem, _, _ = tseed.compute_seed_slots(
        qfs, 1, 99, cfg)
    G = len(qfs)
    red_q = np.zeros((G, max(len(f) for f in qfs)), np.int32)
    for g, f in enumerate(qfs):
        red_q[g, :len(f)] = f
    qlens = np.array([len(f) for f in qfs], np.int32)
    return red_q, qlens, slot_frame, slot_begin, slot_rem


def _hit_set(outs, base, q_rows, Dm):
    got = set()
    for c, h in enumerate(outs):
        h = {k: np.asarray(v) for k, v in h.items() if k != "stats"}
        sel = h["valid"] & h["passed"]
        i, j = divmod(c, Dm)
        got |= set(zip(h["q_frame"][sel] + i * q_rows, h["q_begin"][sel],
                       h["seed_len"][sel], h["s_frame"][sel] + base[j],
                       h["s_off"][sel]))
    return got


def _stats(outs):
    return [tuple(int(v) for v in np.asarray(o)[:4]) for o in outs]


SEEDER_CASES = [  # (n_q, n_db, delta, adaptive, max_cursors)
    (1, 2, 1, False, 1024), (1, 4, 1, False, 1024),
    (1, 2, 1, True, 1024), (1, 4, 1, True, 1024),
    (2, 2, 2, True, 1024), (1, 2, 1, True, 8),
]


@pytest.mark.parametrize("n_q,n_db,delta,adaptive,max_cursors",
                         SEEDER_CASES)
def test_sharded_seeder_equals_jax(seed_inputs, n_q, n_db, delta, adaptive,
                                   max_cursors):
    """The port's make_sharded_seeder gives JAX make_sharded_seeder's hit
    set (global ids) and per-cell stats; with the budgets it does not
    overflow (every case but the last) that set is also the port's
    single-device seeder's.  The last case overflows the elongation
    budget (8 live cursors per slot): the walk takes the JAX mesh's
    compacted cursors and both report the same overflow."""
    A, tf, qfs, concat, offsets, lengths, subst = seed_inputs
    cfg, jcfg = _cfgs(A, max_seed_dist=delta, adaptive=adaptive,
                      max_cursors=max_cursors)
    red_q, qlens, slot_frame, slot_begin, slot_rem = _slots(cfg, qfs)
    G, Q = len(qfs), slot_frame.shape[0]
    kidx = tbuild(concat, offsets, A)
    sh = tmesh.shard_loaded_index(kidx, concat, concat.astype(np.int8),
                                  offsets, lengths, n_db)
    red8 = concat.astype(np.int8)

    # JAX: the production sharded config on the virtual CPU mesh
    _, _, fused_sh = jseed.make_seeder(dataclasses.replace(
        jcfg, psum_axis="db", vary_axes=("q",)))
    jm = jax_mesh(n_q, n_db)
    jouts = jmesh.make_sharded_seeder(jm, fused_sh)(
        jput(jm, sh["keys"], "db", None, None),
        jput(jm, sh["pos"], "db", None), jput(jm, sh["frame"], "db", None),
        jput(jm, sh["offsets"], "db", None),
        jput(jm, sh["lengths"], "db", None),
        jput(jm, sh["trans"], "db", None), jput(jm, sh["red"], "db", None),
        jput(jm, red_q, "q", None), jput(jm, qlens, "q"),
        jput(jm, slot_frame, "q", None), jput(jm, slot_begin, "q", None),
        jput(jm, slot_rem, "q", None), jput(jm, np.zeros(Q, np.int32), "q"),
        jput(jm, red_q, "q", None), jput(jm, subst, None, None),
        jput(jm, subst, None, None),
        jput(jm, np.zeros((n_db, 1), np.int32), "db", None))
    jh = [np.asarray(o) for o in jouts]
    want = set()
    for i in range(n_q):
        for j in range(n_db):
            sel = jh[5][i, j] & jh[6][i, j]
            want |= set(zip(jh[0][i, j][sel] + i * (G // n_q),
                            jh[1][i, j][sel], jh[2][i, j][sel],
                            jh[3][i, j][sel] + sh["base"][j],
                            jh[4][i, j][sel]))
    want_stats = [tuple(int(jh[7 + s][i, j]) for s in range(4))
                  for i in range(n_q) for j in range(n_db)]

    m = grid(n_q, n_db)
    step = tmesh.make_sharded_seeder(m, tseed.make_seeder(cfg))
    outs = step(m.put_db(sh["keys"]), m.put_db(sh["pos"]),
                m.put_db(sh["frame"]), m.put_db(sh["offsets"], torch.int64),
                m.put_db(sh["lengths"], torch.int64), m.put_db(sh["trans"]),
                m.put_db(sh["red"]), m.put_q(red_q), m.put_q(qlens),
                m.put_q(slot_frame), m.put_q(slot_begin), m.put_q(slot_rem),
                m.put_q(np.zeros(Q, np.int64)), m.put_q(red_q),
                m.put_all(subst, torch.int64), m.put_all(subst, torch.int64),
                None)
    got = _hit_set(outs, sh["base"], G // n_q, n_db)
    assert want, "fixture found no hits"
    assert got == want
    assert _stats([o["stats_vec"] for o in outs]) == want_stats

    if max_cursors < 1024:
        assert max(s[3] for s in want_stats) > 0, "the budget did not bind"
        return
    res = tseed.make_seeder(cfg)(
        torch.as_tensor(kidx.keys.astype(np.int64)), torch.as_tensor(red_q),
        torch.as_tensor(qlens), torch.as_tensor(slot_frame),
        torch.as_tensor(slot_begin), torch.as_tensor(slot_rem),
        torch.zeros(Q, dtype=torch.int64),
        torch.as_tensor(kidx.pos.astype(np.int32)),
        torch.as_tensor(kidx.frame.astype(np.int32)),
        torch.as_tensor(offsets[:-1]), torch.as_tensor(lengths),
        torch.as_tensor(red8), torch.as_tensor(red_q),
        torch.as_tensor(subst, dtype=torch.int64),
        torch.as_tensor(subst, dtype=torch.int64),
        red_sbj=torch.as_tensor(red8))
    h = {k: res[k].numpy() for k in ("q_frame", "q_begin", "seed_len",
                                     "s_frame", "s_off", "valid", "passed")}
    sel = h["valid"] & h["passed"]
    single = set(zip(h["q_frame"][sel], h["q_begin"][sel], h["seed_len"][sel],
                     h["s_frame"][sel], h["s_off"][sel]))
    assert got == single


# ---------------------------------------------------------------- scorer


def _band_inputs(rng, Qm, Dm, N, D):
    """A (Qm, Dm) grid of random pass-1 rows over random local subject
    shards, padding rows (qry_len 0, d_row -1) at each cell's end."""
    L = 64
    G = 4 * Qm
    trans_q = rng.integers(0, 20, (G, L)).astype(np.int8)
    F, S = 5, 400
    trans = rng.integers(0, 20, (Dm, S)).astype(np.int8)
    lens = rng.integers(30, 80, (Dm, F)).astype(np.int32)
    offs = np.zeros((Dm, F), np.int32)
    offs[:, 1:] = np.cumsum(lens, axis=1)[:, :-1]
    Bp = 12
    arrs = {k: np.zeros((Qm, Dm, Bp), np.int32) for k in
            ("qry_id", "qry_start", "qry_len", "subj_id", "d_lo", "d_row")}
    arrs["d_row"][:] = -1
    for i in range(Qm):
        for j in range(Dm):
            n = int(rng.integers(1, Bp))
            ql = rng.integers(10, min(N - D, L) + 1, n)
            arrs["qry_id"][i, j, :n] = rng.integers(0, 4, n)
            arrs["qry_start"][i, j, :n] = rng.integers(0, L - ql + 1)
            arrs["qry_len"][i, j, :n] = ql
            arrs["subj_id"][i, j, :n] = rng.integers(0, F, n)
            arrs["d_lo"][i, j, :n] = rng.integers(-10, 40, n)
            arrs["d_row"][i, j, :n] = rng.integers(0, D + 1, n)
    # a homologous window in every cell's first row
    for i in range(Qm):
        for j in range(Dm):
            sid = arrs["subj_id"][i, j, 0]
            o = offs[j, sid] + max(int(arrs["d_lo"][i, j, 0]), 0)
            ql = arrs["qry_len"][i, j, 0]
            q0 = arrs["qry_start"][i, j, 0]
            trans[j, o:o + ql] = trans_q[i * 4 + arrs["qry_id"][i, j, 0],
                                         q0:q0 + ql][:S - o]
    return trans_q, trans, offs, lens, arrs


def _band_parts(Qm, Dm, trans_q, trans, offs, lens, arrs):
    """The real rows of ``_band_inputs`` (d_row >= 0) as one MatchBatch
    with global ids -- query rows of cell (i, j) offset by i's q block,
    subject frames by j's shard base -- with each row's cell (i, j) and
    its slot there, and the grid's parts: one per cell, its q block and
    its local subject shard (SearchContext._sharded_scores's parts)."""
    q_rows, F = trans_q.shape[0] // Qm, offs.shape[1]
    i, j, k = np.nonzero(arrs["d_row"] >= 0)
    at = {n: arrs[n][i, j, k].astype(np.int64) for n in arrs}
    m = tx.MatchBatch(
        qry_id=at["qry_id"] + i * q_rows, subj_id=at["subj_id"] + j * F,
        qry_start=at["qry_start"], qry_end=at["qry_start"] + at["qry_len"],
        subj_start=np.zeros_like(at["d_lo"]),
        subj_end=np.zeros_like(at["d_lo"]), d_lo=at["d_lo"],
        d_hi=at["d_lo"] + at["d_row"])
    parts = [((torch.as_tensor(trans_q[c // Dm * q_rows:][:q_rows]),
               torch.as_tensor(trans[c % Dm]),
               torch.as_tensor(offs[c % Dm], dtype=torch.int64),
               torch.as_tensor(lens[c % Dm], dtype=torch.int64)),
              c // Dm * q_rows, c % Dm * F) for c in range(Qm * Dm)]
    return m, i * Dm + j, k, parts


@pytest.mark.parametrize("xdrop", [0, 5])
def test_sharded_band_scorer_equals_jax(monkeypatch, xdrop):
    """Pass 1 over a (q, db) grid, one part per cell (extend.score_parts,
    the route of SearchContext._sharded_scores), gives the JAX mesh
    scorer's scores (kernel='xla', its CPU route) on the same rows: per
    (qlen, band) class the JAX scorer runs at that class's plan width,
    as the JAX pipeline runs it, exact and with LAMBDA_SW_XDROP (latched
    at import in both packages, set on both modules here).  The JAX
    scorer's padding rows (qry_len 0, d_row -1) score 0; the port's
    cells hold no padding rows."""
    from lambda_tpu import scoring as jscoring

    monkeypatch.setattr(jsw, "_XDROP", xdrop)
    monkeypatch.setattr(tsw, "_XDROP", xdrop)
    rng = np.random.default_rng(5)
    Qm, Dm, D = 2, 2, 23
    N = jsw._plan(64 + D, D)[0]
    trans_q, trans, offs, lens, arrs = _band_inputs(rng, Qm, Dm, N, D)
    sch = jscoring.make_protein_scheme(62, -11, -1)
    e8 = tsw.extend_matrix8(sch.matrix)
    gf, ge = sch.dp_gap_first, sch.dp_gap_extend
    names = ("qry_id", "qry_start", "qry_len", "subj_id", "d_lo", "d_row")
    jm = jax_mesh(Qm, Dm)
    m, cell, slot, parts = _band_parts(Qm, Dm, trans_q, trans, offs, lens,
                                       arrs)
    got = tx.score_parts(m, parts, cell, e8, e8, gf, ge, False)
    qlen, d_row, _ = tx._ext_geometry(m)
    classes = tx.bucket_groups(qlen, d_row, np.zeros(len(m), bool))
    assert len(classes) > 1
    want = np.zeros(len(m), np.int64)
    for (qbk, dbk, _), rows in classes.items():
        jax_out = np.asarray(jmesh.make_sharded_band_scorer(
            jm, jsw._plan(qbk + dbk, dbk)[0], dbk, gf, ge, kernel="xla")(
            jput(jm, trans_q, "q", None), jput(jm, trans, "db", None),
            jput(jm, offs, "db", None), jput(jm, lens, "db", None),
            *(jput(jm, arrs[k], "q", "db", None) for k in names),
            jput(jm, e8, None, None)))
        assert (jax_out[arrs["d_row"] < 0] == 0).all()
        want[rows] = jax_out.reshape(Qm * Dm, -1)[cell[rows], slot[rows]]
    np.testing.assert_array_equal(got, want)
    assert want.max() > 20


def test_sharded_scores_skip_a_cells_absent_class(monkeypatch):
    """A cell launches only its own rows of each class: with one class's
    rows taken out of the last cell, that cell launches nothing for the
    class, every other (cell, class) that holds rows launches once on
    exactly those rows, the counters still count one dispatch per class,
    and the rows left keep the scores of the full grid."""
    from lambda_tpu_torch.stats import StatsHolder

    rng = np.random.default_rng(5)
    Qm, Dm, D = 2, 2, 23
    inputs = _band_inputs(rng, Qm, Dm, jsw._plan(64 + D, D)[0], D)
    m, cell, _, parts = _band_parts(Qm, Dm, *inputs)
    e8 = tsw.extend_matrix8(np.eye(20, dtype=np.int32) * 6 - 2)
    full = tx.score_parts(m, parts, cell, e8, e8, -12, -1, False)

    def classes(mb):
        return tx.bucket_groups(*tx._ext_geometry(mb)[:2],
                                np.zeros(len(mb), bool))

    key, rows = next((k, r) for k, r in classes(m).items()
                     if 3 in cell[r] and len(set(cell[r])) > 1)
    keep = np.setdiff1d(np.arange(len(m)), np.asarray(rows)[cell[rows] == 3])
    m2, cell2 = m.take(keep), cell[keep]
    held = {(int(c), tuple(r[cell2[r] == c]))
            for r in map(np.asarray, classes(m2).values())
            for c in set(cell2[r])}
    assert key in classes(m2) and 3 not in cell2[classes(m2)[key]]
    launched, scored = set(), [0]
    gather, score = tx._gather_windows, tsw.sw_band_score_device

    def gather_hook(resident, mb, idxs, pad, N, q_base, s_base):
        launched.add((q_base // 4 * Dm + s_base // 5, tuple(idxs)))
        return gather(resident, mb, idxs, pad, N, q_base, s_base)

    def score_hook(*a):
        scored[0] += 1
        return score(*a)

    monkeypatch.setattr(tx, "_gather_windows", gather_hook)
    monkeypatch.setattr(tsw, "sw_band_score_device", score_hook)
    st = StatsHolder()
    got = tx.score_parts(m2, parts, cell2, e8, e8, -12, -1, False, stats=st)
    assert launched == held and scored[0] == len(held)
    assert (st.ext_dispatches, st.ext_dispatch_rows) \
        == (len(classes(m2)), len(m2))
    np.testing.assert_array_equal(got, full[keep])


@pytest.mark.parametrize("max_cursors", [8, 1024])
def test_mesh_decide_walk_budget_equals_jax_stage1(seed_inputs, max_cursors):
    """The mesh's decide on curves summed over two shards takes the JAX
    seeder's stage-1 decisions on the whole index: every cursor's seed
    length and keep, and the elongation budget's overflow, also when the
    budget (8 globally live cursors per slot) leaves cursors unwalked,
    which then keep the seed length and their count.  The port's
    resident stage 1 takes the same decisions."""
    A, tf, qfs, concat, offsets, lengths, subst = seed_inputs
    cfg, jcfg = _cfgs(A, adaptive=True, max_cursors=max_cursors)
    red_q, qlens, slot_frame, slot_begin, slot_rem = _slots(cfg, qfs)
    Q, T = slot_frame.shape
    kidx = tbuild(concat, offsets, A)
    stage1 = jseed.make_seeder(jcfg)[0]
    js = stage1(kidx.keys, red_q, qlens, slot_frame, slot_begin, slot_rem,
                np.zeros(Q, np.int32))
    seeder = tseed.make_seeder(cfg)
    V = seeder.V
    sh = tmesh.shard_loaded_index(kidx, concat, concat.astype(np.int8),
                                  offsets, lengths, 2)
    tq = [torch.as_tensor(x) for x in (red_q, qlens, slot_frame, slot_begin,
                                       slot_rem)]
    acc = sum(seeder.curve_pass(torch.as_tensor(sh["keys"][j].astype(
        np.int64)), *tq) for j in range(2))
    seed_len, keep = seeder.curve_decide(acc, tq[1], *tq[2:],
                                         torch.zeros(Q, dtype=torch.int64),
                                         max_cursors=max_cursors)
    want_len = np.asarray(js["seed_len"]).reshape(Q, T, V)
    np.testing.assert_array_equal(seed_len.numpy(), want_len)
    kept = (acc[..., 0] > 0) & keep
    np.testing.assert_array_equal(
        kept.numpy(), np.asarray(js["count"]).reshape(Q, T, V) > 0)
    assert int(tmesh._ext_overflow(acc, max_cursors)) == int(js["ext_over"])
    res = seeder.stage1(torch.as_tensor(kidx.keys.astype(np.int64)), *tq,
                        torch.zeros(Q, dtype=torch.int64))
    np.testing.assert_array_equal(res["seed_len"].numpy().reshape(Q, T, V),
                                  want_len)
    if max_cursors < 1024:
        assert int(js["ext_over"]) > 0, "the budget did not bind"
        walked = want_len > cfg.seed_length
        assert walked.any() and not walked.all()
