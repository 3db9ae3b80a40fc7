"""BLAST pairwise report (m0) output.

Equivalent of the reference's SeqAn2 BlastReport usage
(``lambda/src/search_output.hpp:319-330`` header,
``myWriteRecord`` -> seqan::writeRecord(outfileBlastRep), ``:746-749``
footer).  The layout follows classic ``blastall -m0`` / SeqAn2
conventions: global header with reference citation, per-query section
with a one-line-per-subject overview and full alignment blocks (60
columns, match line with identities as letters and positives as '+'),
and a database statistics footer.
"""

from __future__ import annotations

_REFERENCE = (
    "Reference: Altschul, Stephen F., Thomas L. Madden, Alejandro A.\n"
    "Schaffer, Jinghui Zhang, Zheng Zhang, Webb Miller, and David J.\n"
    "Lipman (1997), \"Gapped BLAST and PSI-BLAST: a new generation of\n"
    "protein database search programs\", Nucleic Acids Res. 25:3389-3402.\n")


class BlastReportWriter:
    def __init__(self, path: str, program_name: str, version_string: str,
                 db_name: str, db_num_seqs: int, db_total_length: int,
                 matrix_name: str, gap_open: int, gap_extend: int):
        from ..misc import open_output
        self.fh = open_output(path)
        self.program_name = program_name.upper()
        self.version_string = version_string
        self.db_name = db_name
        self.db_num_seqs = db_num_seqs
        self.db_total_length = db_total_length
        self.matrix_name = matrix_name
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.num_queries = 0

    def write_header(self) -> None:
        w = self.fh.write
        w(f"{self.version_string}\n\n\n")
        w(_REFERENCE)
        w("\n\n")
        w(f"Database: {self.db_name}\n")
        w(f"           {self.db_num_seqs:,} sequences; "
          f"{self.db_total_length:,} total letters\n\n")

    def write_record(self, q_id: str, q_length: int, matches,
                     subject_ids, evalue_fmt, bits_fmt,
                     alignment_rows) -> None:
        """matches: list of BlastMatch; alignment_rows: per-match
        (q_row, m_row, s_row, q_positions, s_positions) display data."""
        self.num_queries += 1
        w = self.fh.write
        w(f"\nQuery= {q_id}\n\n")
        w(f"Length={q_length}\n")
        w("                                                                "
          "   Score     E\n")
        w("Sequences producing significant alignments:                     "
          "  (Bits)  Value\n\n")
        from .blast_tab import first_word

        seen = []
        for m in matches:
            sid = first_word(subject_ids[m.n_s_id])
            if sid in seen:
                continue
            seen.append(sid)
            name = sid[:60]
            w(f"  {name:<64}{bits_fmt(m.bit_score):>5}  {evalue_fmt(m.e_value)}\n")
        w("\n")

        last_sid = None
        for m, rows in zip(matches, alignment_rows):
            sid_full = subject_ids[m.n_s_id]
            if sid_full != last_sid:
                w(f"\n> {sid_full}\n")
                w(f"Length={m.s_length}\n")
                last_sid = sid_full
            w(f"\n Score = {m.bit_score:.1f} bits ({m.raw_score}), "
              f" Expect = {evalue_fmt(m.e_value)}\n")
            gaps = m.num_gaps
            al = m.align_length

            def pct(n: int) -> int:
                # NCBI/lround semantics: half away from zero, not
                # Python round()'s half-to-even (12.5% -> 13, not 12)
                return int(100.0 * n / al + 0.5)

            w(f" Identities = {m.num_matches}/{al} ({pct(m.num_matches)}%), "
              f"Positives = {m.num_positives}/{al} ({pct(m.num_positives)}%), "
              f"Gaps = {gaps}/{al} ({pct(gaps)}%)\n")
            # Frame/Strand line keyed on the PROGRAM (classic BLAST):
            # blastx prints the query frame, tblastn the subject frame,
            # tblastx both, blastn (incl. bisulfite) the strands
            prog = self.program_name
            if prog == "TBLASTX":
                w(f" Frame = {m.q_frame_shift:+d}/{m.s_frame_shift:+d}\n")
            elif prog == "BLASTX":
                w(f" Frame = {m.q_frame_shift:+d}\n")
            elif prog == "TBLASTN":
                w(f" Frame = {m.s_frame_shift:+d}\n")
            elif prog == "BLASTN":
                # query strand first, subject strand second — must agree
                # with the printed coordinates (the minus partner's
                # coords descend); subjects are always plus here
                qstrand = "Minus" if m.q_frame_shift < 0 else "Plus"
                sstrand = "Minus" if m.s_frame_shift < 0 else "Plus"
                w(f" Strand={qstrand}/{sstrand}\n")
            w("\n")

            q_row, m_row, s_row, (q_start_col, q_end_col), (s_start_col, s_end_col) = rows
            # coordinate column scales with the widest line-start coord
            # (classic BLAST): fixed width-5 misaligned the match line
            # for 6+ digit genomic coordinates
            cw = 5
            for off in range(0, len(q_row), 60):
                cw = max(cw, len(str(q_start_col[off])) + 1,
                         len(str(s_start_col[off])) + 1)
            for off in range(0, len(q_row), 60):
                end = min(off + 60, len(q_row)) - 1
                w(f"Query  {q_start_col[off]:<{cw}}{q_row[off:end + 1]}  "
                  f"{q_end_col[end]}\n")
                w(f"       {'':<{cw}}{m_row[off:end + 1]}\n")
                w(f"Sbjct  {s_start_col[off]:<{cw}}{s_row[off:end + 1]}  "
                  f"{s_end_col[end]}\n\n")

    def write_footer(self) -> None:
        w = self.fh.write
        w("\n\n  Database: " + self.db_name + "\n")
        w(f"  Number of letters in database: {self.db_total_length:,}\n")
        w(f"  Number of sequences in database:  {self.db_num_seqs:,}\n\n\n")
        w(f"Matrix: {self.matrix_name}\n")
        w(f"Gap Penalties: Existence: {-self.gap_open}, "
          f"Extension: {-self.gap_extend}\n\n")
        self.fh.close()


def build_alignment_rows(bm, q_frame_chars: str, s_frame_chars: str,
                         subst, positive_fn, factor_q: int, factor_s: int):
    """Build display rows for one match.

    q_frame_chars/s_frame_chars: the translated frame sequences as str.
    Returns (q_row, m_row, s_row, q_pos, s_pos); *_pos give, for every row
    offset, the 1-based untranslated coordinate used at line starts/ends
    (start coordinate of the residue at that offset; the final entry is
    the end coordinate)."""
    qi, sj = bm.q_start, bm.s_start
    q_row = []
    s_row = []
    m_row = []
    q_pos_frame = []  # frame-space position per column (or last consumed)
    s_pos_frame = []
    for op, run in bm.ops:
        for _ in range(run):
            if op == "M":
                qc = q_frame_chars[qi]
                sc = s_frame_chars[sj]
                q_row.append(qc)
                s_row.append(sc)
                if qc == sc:
                    m_row.append(qc)
                elif positive_fn(qi, sj):
                    m_row.append("+")
                else:
                    m_row.append(" ")
                q_pos_frame.append(qi)
                s_pos_frame.append(sj)
                qi += 1
                sj += 1
            elif op == "D":
                q_row.append("-")
                s_row.append(s_frame_chars[sj])
                m_row.append(" ")
                q_pos_frame.append(qi)
                s_pos_frame.append(sj)
                sj += 1
            else:
                q_row.append(q_frame_chars[qi])
                s_row.append("-")
                m_row.append(" ")
                q_pos_frame.append(qi)
                s_pos_frame.append(sj)
                qi += 1
    from .blast_tab import untranslate_positions

    def col_coords(pos_frame, fs, length, factor, total_cols, row):
        """Per-column (start, end) display coordinates: start = coord of
        the residue at/after this column; end = coord of the last residue
        consumed at/up to this column."""
        starts = [0] * total_cols
        ends = [0] * total_cols
        for c in range(total_cols):
            p = pos_frame[c]
            a, b = untranslate_positions(p, p + 1, fs, length, factor)
            starts[c] = a
            ends[c] = b
        # for gap columns, starts should reference the NEXT consumed residue
        # and ends the PREVIOUS one; pos_frame already holds the pending
        # position for gaps, so ends need a shift back on gap columns
        last_end = ends[0]
        for c in range(total_cols):
            if row[c] == "-":
                ends[c] = last_end
            else:
                last_end = ends[c]
        return starts, ends

    total = len(q_row)
    qsc = col_coords(q_pos_frame, bm.q_frame_shift, bm.q_length, factor_q,
                     total, q_row)
    ssc = col_coords(s_pos_frame, bm.s_frame_shift, bm.s_length, factor_s,
                     total, s_row)
    return "".join(q_row), "".join(m_row), "".join(s_row), qsc, ssc
