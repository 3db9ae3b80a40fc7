"""The one generator of the benchmark: a protein database of families and
the query mixes, all from ``--seed``, all from parameters in the
configuration and traffic files.

Database (a configuration's ``database`` block):

* ``residues`` in all; subjects are members of families, generated family
  by family in a seeded order until the total is reached (the last subject
  is cut to it).  The families left over are absent from the database and
  feed the queries without a homolog.
* Family sizes: a discrete power law P(s) ~ s^-``size_exponent`` on [1,
  ``size_max``]; ancestor lengths: log-normal with mean ``length_mean``
  and shape ``length_sigma``, clipped to [``length_min``,
  ``length_max``]; divergence: uniform on [``divergence_min``,
  ``divergence_max``].  Each of the three is a fixed set of quantiles in
  a seeded order, so every seed holds the same sizes, lengths and
  divergences, paired anew.
* A member (and a query that is a new member) is its family's ancestor
  with each residue substituted at the family's divergence, and
  ``indels_per_residue`` indels of 1 to ``indel_max`` residues, half of
  them insertions.  Residues are drawn from the Robinson & Robinson
  frequencies.

Traffic (a traffic file): ``kind`` ``proteins`` (new members of database
families for a ``homolog_share`` of the queries, members of absent
families for the rest) or ``reads`` (DNA reads: the reverse translation,
a random synonymous codon per residue, of a ``fragment_aa`` fragment of a
subject with ``fragment_aa // 8`` residues replaced, every other read
reverse-complemented, for a ``homolog_share``; random DNA for the rest).
Query i of a stream is a homolog when floor((i + 1) share) > floor(i
share), which spreads any share evenly (0.7: seven in every ten).
"""

from __future__ import annotations

import dataclasses
import statistics
from pathlib import Path

import numpy as np

from ..reference import tables

_LETTERS = np.frombuffer(tables.STANDARD_AA.encode(), dtype=np.uint8)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def length_set(n: int, p: dict) -> np.ndarray:
    sigma = float(p["length_sigma"])
    mu = np.log(float(p["length_mean"])) - sigma * sigma / 2
    z = np.array([statistics.NormalDist().inv_cdf(u) for u in _quantiles(n)])
    return np.clip(np.exp(mu + sigma * z), p["length_min"],
                   p["length_max"]).astype(np.int64)


def size_set(n: int, p: dict) -> np.ndarray:
    s = np.arange(1, int(p["size_max"]) + 1, dtype=np.float64)
    cdf = np.cumsum(s ** -float(p["size_exponent"]))
    return np.searchsorted(cdf / cdf[-1], _quantiles(n)).astype(np.int64) + 1


def divergence_set(n: int, p: dict) -> np.ndarray:
    lo, hi = float(p["divergence_min"]), float(p["divergence_max"])
    return (lo + (hi - lo) * _quantiles(n)).astype(np.float32)


# the residue of each of 2^16 equal slices of the background distribution
_BG_LUT = np.minimum(np.searchsorted(
    np.cumsum(tables.background()), (np.arange(1 << 16) + 0.5) / (1 << 16)),
    19).astype(np.uint8)


def _background(rng, n: int) -> np.ndarray:
    """``n`` residues drawn from the background frequencies."""
    return _BG_LUT[rng.integers(0, 1 << 16, n, dtype=np.uint16)]


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated index ranges [starts[k], starts[k] + lens[k])."""
    seg = np.cumsum(lens) - lens
    dt = np.int32 if int(lens.sum()) + int(np.max(starts, initial=0)) \
        < 2 ** 31 else np.int64
    return np.arange(int(lens.sum()), dtype=dt) \
        + np.repeat((starts - seg).astype(dt), lens)


@dataclasses.dataclass
class Families:
    anc: np.ndarray          # ancestors' residues (indices into STANDARD_AA)
    anc_off: np.ndarray      # (n + 1,)
    size: np.ndarray         # members each family would have
    div: np.ndarray          # substitution rate of a member
    indel_rate: float
    indel_max: int

    @property
    def anc_len(self) -> np.ndarray:
        return np.diff(self.anc_off)

    def derive(self, rng, fams: np.ndarray):
        """New members of families ``fams``: (residues, lengths)."""
        L = self.anc_len[fams]
        seq = self.anc[_ranges(self.anc_off[fams], L)]
        hit = rng.random(len(seq), dtype=np.float32) \
            < np.repeat(self.div[fams], L)
        seq[hit] = _background(rng, int(hit.sum()))
        seg = np.cumsum(L) - L
        n_ind = rng.poisson(L * self.indel_rate)
        own = np.repeat(np.arange(len(fams)), n_ind)
        pos = seg[own] + (rng.random(len(own)) * L[own]).astype(np.int64)
        ln = rng.integers(1, self.indel_max + 1, len(own))
        dele = rng.random(len(own)) < 0.5
        ends = np.minimum(pos + ln, seg[own] + L[own])
        gone = np.unique(_ranges(pos[dele], ends[dele] - pos[dele]))
        ins = ~dele
        at = np.repeat(pos[ins], ln[ins])
        keep = np.ones(len(seq), dtype=bool)
        keep[gone] = False
        seq = np.insert(seq[keep], at - np.searchsorted(gone, at),
                        _background(rng, int(ln[ins].sum())))
        lost = np.searchsorted(gone, seg + L) - np.searchsorted(gone, seg)
        lens = L - lost + np.bincount(own[ins], weights=ln[ins],
                                      minlength=len(fams)).astype(np.int64)
        return seq, lens


@dataclasses.dataclass
class Database:
    seq: np.ndarray          # residues, concatenated in generated order
    off: np.ndarray          # (n + 1,) offsets in ``seq``, generated order
    order: np.ndarray        # subject k is generated subject order[k]
    family: np.ndarray       # family of each subject
    fams: Families
    n_in_db: int             # families 0 .. n_in_db - 1 are in the database

    @property
    def n_subjects(self) -> int:
        return len(self.order)

    @property
    def residues(self) -> int:
        return int(self.off[-1])

    def lengths(self) -> np.ndarray:
        return np.diff(self.off)[self.order]

    def subject(self, k: int) -> np.ndarray:
        g = self.order[k]
        return self.seq[self.off[g]:self.off[g + 1]]

    def write_fasta(self, path: Path) -> None:
        data = _LETTERS[self.seq].tobytes()
        parts = []
        for k, g in enumerate(self.order.tolist()):
            parts += [b">s%d\n" % k, data[self.off[g]:self.off[g + 1]], b"\n"]
        path.write_bytes(b"".join(parts))


def make_database(seed: int, p: dict) -> Database:
    """The database of configuration block ``p`` from ``seed``."""
    total = int(p["residues"])
    n_db = 64
    for _ in range(4):          # families the residues take, on average
        n_db = int(total / (size_set(n_db, p).mean()
                            * length_set(n_db, p).mean())) + 1
    n_fam = int(n_db * (1 + float(p["spare_families"]))) \
        + int(p["absent_families"])
    rng = rng_for(seed, 1)
    fams = Families(anc=np.empty(0, np.uint8), anc_off=np.zeros(1, np.int64),
                    size=rng.permutation(size_set(n_fam, p)),
                    div=rng.permutation(divergence_set(n_fam, p)),
                    indel_rate=float(p["indels_per_residue"]),
                    indel_max=int(p["indel_max"]))
    anc_len = rng.permutation(length_set(n_fam, p))
    fams.anc_off = np.concatenate([[0], np.cumsum(anc_len)])
    fams.anc = _background(rng, int(anc_len.sum()))
    # families in order, a chunk of about 4M residues at a time, until
    # the residues are reached
    need = np.cumsum(fams.size * anc_len)
    seqs, lens, fam_of = [], [], []
    start = got = 0
    last = n_fam - int(p["absent_families"])
    while got < total:
        if start >= last:
            raise ValueError("spare_families is too small for this seed")
        base = need[start - 1] if start else 0
        stop = min(last, int(np.searchsorted(need, base + (1 << 22))) + 1)
        members = np.repeat(np.arange(start, stop), fams.size[start:stop])
        s, ln = fams.derive(rng, members)
        seqs.append(s)
        lens.append(ln)
        fam_of.append(members)
        got += int(ln.sum())
        start = stop
    lens = np.concatenate(lens)
    cut = int(np.searchsorted(np.cumsum(lens), total)) + 1
    lens = lens[:cut]
    lens[-1] -= int(lens.sum()) - total
    family = np.concatenate(fam_of)[:cut].astype(np.int32)
    # subjects in a seeded order, not family by family: subject k of the
    # database is generated subject order[k]
    order = rng.permutation(cut)
    return Database(seq=np.concatenate(seqs)[:total],
                    off=np.concatenate([[0], np.cumsum(lens)]), order=order,
                    family=family[order], fams=fams, n_in_db=start)


@dataclasses.dataclass
class Query:
    text: str               # protein letters, or DNA for reads
    family: int             # source family (-1: random DNA)
    planted: bool           # a homolog of the database


def _homolog(i: int, share: float) -> bool:
    return int((i + 1) * share + 1e-9) > int(i * share + 1e-9)


def make_proteins(rng, db: Database, n: int, share: float) -> list[Query]:
    """``n`` proteins: new members of database families (chosen in
    proportion to their size in the database) for the homolog share,
    else new members of absent families."""
    planted = np.array([_homolog(i, share) for i in range(n)])
    fams = np.where(planted,
                    db.family[rng.integers(0, len(db.family), n)],
                    rng.integers(db.n_in_db, len(db.fams.size), n))
    seq, lens = db.fams.derive(rng, fams)
    off = np.concatenate([[0], np.cumsum(lens)])
    text = _LETTERS[seq].tobytes().decode()
    return [Query(text[off[k]:off[k + 1]], int(fams[k]), bool(planted[k]))
            for k in range(n)]


def _codon_lut() -> np.ndarray:
    """(20, 6, 3) bytes: the k % n-th codon of each residue."""
    lut = np.zeros((20, 6, 3), dtype=np.uint8)
    for r, aa in enumerate(tables.STANDARD_AA):
        cs = tables.AA_TO_CODONS[aa]
        for k in range(6):
            lut[r, k] = np.frombuffer(cs[k % len(cs)].encode(), np.uint8)
    return lut


def make_reads(rng, db: Database, n: int, share: float,
               fragment_aa: int) -> list[Query]:
    lens = db.lengths()
    ok = np.nonzero(lens >= fragment_aa)[0]
    lut = _codon_lut()
    out = []
    for i in range(n):
        if not _homolog(i, share):
            dna = _LETTERS_DNA[rng.integers(0, 4, 3 * fragment_aa)]
            out.append(Query(dna.tobytes().decode(), -1, False))
            continue
        k = int(ok[rng.integers(0, len(ok))])
        st = int(rng.integers(0, lens[k] - fragment_aa + 1))
        frag = db.subject(k)[st:st + fragment_aa].copy()
        nsub = fragment_aa // 8
        frag[rng.integers(0, fragment_aa, nsub)] = rng.integers(0, 20, nsub)
        dna = lut[frag, rng.integers(0, 6, fragment_aa)].tobytes().decode()
        out.append(Query(tables.revcomp(dna) if i % 2 else dna,
                         int(db.family[k]), True))
    return out


_LETTERS_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_queries(rng, db: Database, traffic: dict, n: int) -> list[Query]:
    if traffic["kind"] == "reads":
        return make_reads(rng, db, n, float(traffic["homolog_share"]),
                          int(traffic["fragment_aa"]))
    return make_proteins(rng, db, n, float(traffic["homolog_share"]))


def write_queries(path: Path, qs: list[Query], first_id: int) -> None:
    path.write_text("".join(f">q{first_id + k}\n{q.text}\n"
                            for k, q in enumerate(qs)))
