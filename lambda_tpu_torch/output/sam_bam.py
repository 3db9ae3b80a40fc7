"""SAM and BAM output.

Port of ``lambda/src/search_output.hpp``:
* header generation (:348-456): @HD/@PG/@CO lines, optional full
  reference header (@SQ) for SAM, always for BAM
* per-match record assembly (:464-731): coordinate untranslation for
  translated subjects, CIGAR in DNA and/or protein space with hard/soft
  clips (blastMatchOneCigar/TwoCigar :116-298), SEQ untranslation for
  translated queries (_untranslateSequence :86-109), uniq-seq
  suppression, the 14 optional tags, SECONDARY flag handling
* BAM is written through an own bgzf encoder (the reference uses SeqAn2's).

Note: for negative *subject* frames the reference mirrors the position
with ``record.qLength`` (search_output.hpp:498), which is a bug; we emit
the leftmost plus-strand coordinate of the aligned region instead.
This is a copy of the JAX package's ``output/sam_bam.py`` with one
change: ``_bgzf_flush_block`` has no zlib branch, because the port's
native BGZF encoder (``native.bgzf_compress_block``) is always built and
raises rather than returning None.  Both packages compress through the
same C++ source, so their BAM files are equal byte for byte.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import __version__, alphabets as ab

TAG_ORDER = ["AS", "OC", "NM", "IH", "ar", "ae", "ai", "ap", "qf", "qs",
             "sf", "st", "ls", "lt"]


def build_cigar_one(bm, q_len_orig: int, q_frame_len: int, q_translated: bool,
                    hard_clip: bool):
    """blastMatchOneCigar (search_output.hpp:116-194).  Returns a list of
    (op, count) in final orientation."""
    trans_fac = 3 if q_translated else 1
    # frame-offset hard clips exist only for TRANSLATED queries: the
    # bisulfite frames are strand DUPLICATES (|shift| 2 is not a base
    # offset, frames.py BS chain) — the reference's unconditional
    # |shift|-1 (search_output.hpp:127) claims one base too many there
    left_frame_clip = max(abs(bm.q_frame_shift) - 1, 0) if q_translated else 0
    right_frame_clip = ((q_len_orig - left_frame_clip) % 3) if q_translated else 0
    left_clip = bm.q_start * trans_fac
    right_clip = (q_frame_len - bm.q_end) * trans_fac

    cigar: list[tuple[str, int]] = []
    if hard_clip:
        if left_frame_clip + left_clip > 0:
            cigar.append(("H", left_frame_clip + left_clip))
    else:
        if left_frame_clip > 0:
            cigar.append(("H", left_frame_clip))
        if left_clip > 0:
            cigar.append(("S", left_clip))

    for op, run in bm.ops:
        cigar.append((op, run * trans_fac))

    if hard_clip:
        if right_frame_clip + right_clip > 0:
            cigar.append(("H", right_frame_clip + right_clip))
    else:
        if right_clip > 0:
            cigar.append(("S", right_clip))
        if right_frame_clip > 0:
            cigar.append(("H", right_frame_clip))

    # NO reversal for negative frames (deviation from the reference's
    # reverse(), search_output.hpp:192): here bm.q_start/ops are
    # FRAME-space and SEQ is emitted in frame orientation (the
    # reverse-complemented read, FLAG 0x10), so the frame-order CIGAR
    # already matches SEQ and POS — reversing would mirror the clips
    # and ops against the emitted sequence (verified: junk+revcomp
    # reads produced records whose SEQ did not match the reference at
    # POS under the reversed CIGAR).
    return _coalesce(cigar)


def build_cigar_two(bm, q_len_orig: int, q_frame_len: int, hard_clip: bool):
    """blastMatchTwoCigar (search_output.hpp:198-298): returns
    (dna_cigar, prot_cigar) for translated queries."""
    left_frame_clip = max(abs(bm.q_frame_shift) - 1, 0)
    right_frame_clip = (q_len_orig - left_frame_clip) % 3
    left_clip = bm.q_start
    right_clip = q_frame_len - bm.q_end

    dna: list[tuple[str, int]] = []
    prot: list[tuple[str, int]] = []
    if hard_clip:
        if left_frame_clip + left_clip > 0:
            dna.append(("H", left_frame_clip + 3 * left_clip))
        if left_clip > 0:
            prot.append(("H", left_clip))
    else:
        if left_frame_clip > 0:
            dna.append(("H", left_frame_clip))
        if left_clip > 0:
            dna.append(("S", 3 * left_clip))
            prot.append(("S", left_clip))

    for op, run in bm.ops:
        dna.append((op, run * 3))
        prot.append((op, run))

    if hard_clip:
        if right_frame_clip + right_clip > 0:
            dna.append(("H", right_frame_clip + 3 * right_clip))
        if right_clip > 0:
            prot.append(("H", right_clip))
    else:
        if right_clip > 0:
            dna.append(("S", 3 * right_clip))
            prot.append(("S", right_clip))
        if right_frame_clip > 0:
            dna.append(("H", right_frame_clip))

    # no reversal for negative frames — same frame-space reasoning as
    # build_cigar_one (the reference reverses at search_output.hpp:297,
    # a convention mismatch with our frame-oriented SEQ emission)
    return _coalesce(dna), _coalesce(prot)


def _coalesce(cigar):
    out = []
    for op, n in cigar:
        if n == 0:
            continue
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + n)
        else:
            out.append((op, n))
    return out


def cigar_str(cigar) -> str:
    return "".join(f"{n}{op}" for op, n in cigar) if cigar else "*"


def untranslate_sequence(orig_dna: np.ndarray, q_start: int, q_end: int,
                         frame_shift: int) -> str:
    """_untranslateSequence (search_output.hpp:86-109): protein-space
    [q_start, q_end) back to DNA characters on the read's strand."""
    fs = abs(frame_shift)
    L = len(orig_dna)
    if frame_shift >= 0:
        sl = orig_dna[3 * q_start + fs - 1 : 3 * q_end + fs - 1]
        return ab.decode(sl, ab.DNA5)
    sl = orig_dna[L - (3 * q_end + fs - 1) : L - (3 * q_start + fs - 1)]
    return ab.decode(ab.reverse_complement(sl, ab.DNA5), ab.DNA5)


class SamBamWriter:
    def __init__(self, path: str, bam: bool, opt, ctx):
        self.bam = bam
        self.opt = opt
        self.ctx = ctx
        self.path = path
        self.tags = [t for t in TAG_ORDER if t in opt.sam_bam_tags]
        # contig names truncated at first whitespace (search_output.hpp:360-375)
        from ..index import artifact as _art

        if isinstance(ctx.idx.ids, _art.SubsetList):
            # only pre-round-4 gen-2 artifacts lack the global id table
            raise RuntimeError(
                "SAM/BAM output requires the full reference table, but "
                "this sharded index predates the global-id layout; "
                "recreate it with mkindex* --shards (or write m8/m9 and "
                "merge with tools/merge_m8).")
        self.refs = [i.split(None, 1)[0] if i else i for i in ctx.idx.ids]
        # @SQ lengths from the GLOBAL length table when sequences are
        # only partially loaded (--shard-subset): the header must equal
        # the unsharded run's (search_output.hpp:348-456)
        self.ref_lens = (
            [int(x) for x in ctx.idx.seq_lengths]
            if isinstance(ctx.idx.seqs, _art.SubsetList)
            else [len(s) for s in ctx.idx.seqs])
        if bam:
            self.fh = open(path, "wb")
            self._bgzf_buf = b""
        else:
            from ..misc import open_output

            self.fh = open_output(path)

    # ---------------- header ----------------

    def _header_lines(self) -> list[str]:
        opt = self.opt
        lines = ["@HD\tVN:1.4\tGO:query"]
        if self.bam or opt.sam_with_ref_header:
            for name, ln in zip(self.refs, self.ref_lens):
                lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
        if opt.version_to_output_file:
            lines.append(f"@PG\tID:lambda\tPN:lambda\tVN:{__version__}"
                         f"\tCL:{opt.command_line}")
        lines.append("@CO\tLambda-TPU is a BLAST compatible local aligner "
                     "reimplemented TPU-native, modeled on seqan/lambda "
                     "(http://seqan.de/lambda).")
        lines.append("@CO\tSAM/BAM dialect documentation is available here: "
                     "https://github.com/seqan/lambda/wiki/Output-Formats")
        lines.append("@CO\tIf you use any results found by Lambda, please cite "
                     "Hauswedell et al. (2014) doi: 10.1093/bioinformatics/btu439")
        cols = "Optional tags as follow"
        for t in self.tags:
            cols += f"\t{t}:{TAG_DESCRIPTIONS[t]}"
        lines.append(f"@CO\t{cols}")
        return lines

    def write_header(self) -> None:
        # SAM without ref header only writes self-created lines
        # (search_output.hpp:442-455); @SQ inclusion handled above
        text = "\n".join(self._header_lines()) + "\n"
        if self.bam:
            hdr = b"BAM\x01"
            t = text.encode()
            hdr += struct.pack("<i", len(t)) + t
            hdr += struct.pack("<i", len(self.refs))
            for name, ln in zip(self.refs, self.ref_lens):
                nb = name.encode() + b"\x00"
                hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
            self._bgzf_write(hdr)
        else:
            self.fh.write(text)

    # ---------------- records ----------------

    def write_record(self, q_id: str, q_seq: np.ndarray, matches,
                     lca_tax: int = 0, lca_name: str = "") -> None:
        ctx, opt = self.ctx, self.opt
        program = ctx.program
        qname = q_id.split(None, 1)[0] if q_id else q_id
        n = len(matches)
        prev = None
        for mi, bm in enumerate(matches):
            flag = 0 if mi == 0 else 0x100
            if bm.q_frame_shift < 0:
                flag |= 0x10

            # position on reference (search_output.hpp:493-503); for
            # negative subject frames POS must be the LEFTMOST plus-strand
            # base: the rc-frame protein interval [s_start, s_end) covers
            # rc-DNA [3*s_start+|f|-1, 3*s_end+|f|-1), whose plus-strand
            # leftmost coordinate is L - 3*s_end - |f| + 1.  (The reference
            # subtracts from qLength — search_output.hpp:498 — which is a
            # bug producing out-of-range POS.)
            if program.s_translated:
                fmag = abs(bm.s_frame_shift)
                if bm.s_frame_shift < 0:
                    pos0 = bm.s_length - (bm.s_end * 3 + fmag - 1)
                else:
                    pos0 = bm.s_start * 3 + fmag - 1
            else:
                pos0 = bm.s_start

            q_frame_len = (len(q_seq) if not program.q_translated
                           else (len(q_seq) - (abs(bm.q_frame_shift) - 1)) // 3)

            # CIGARs
            prot_cigar = []
            if "OC" in self.tags:
                if program.value in ("blastp", "tblastn"):
                    cigar = []
                    prot_cigar = build_cigar_one(
                        bm, len(q_seq), q_frame_len, False, opt.sam_bam_hard_clip)
                elif program.q_translated:
                    cigar, prot_cigar = build_cigar_two(
                        bm, len(q_seq), q_frame_len, opt.sam_bam_hard_clip)
                else:
                    cigar = build_cigar_one(
                        bm, len(q_seq), q_frame_len, False, opt.sam_bam_hard_clip)
            else:
                if program.value in ("blastp", "tblastn"):
                    cigar = []
                elif program.q_translated:
                    cigar, _ = build_cigar_two(
                        bm, len(q_seq), q_frame_len, opt.sam_bam_hard_clip)
                else:
                    cigar = build_cigar_one(
                        bm, len(q_seq), q_frame_len, False, opt.sam_bam_hard_clip)

            # SEQ (search_output.hpp:533-599)
            write_seq = False
            if opt.sam_bam_seq == "always":
                write_seq = True
            elif opt.sam_bam_seq == "uniq":
                key = (bm.q_frame_shift, bm.q_start, bm.q_end)
                write_seq = key != prev
                prev = key
            seq = "*"
            if program.value == "blastn":
                if write_seq:
                    frame = ctx.query_frame(
                        q_seq, bm.qry_frame_id % ctx.qry_num_frames)
                    if opt.sam_bam_hard_clip:
                        seq = ab.decode(frame[bm.q_start : bm.q_end], ab.DNA5)
                    else:
                        seq = ab.decode(frame, ab.DNA5)
            elif program.q_translated:
                if write_seq:
                    if opt.sam_bam_hard_clip:
                        seq = untranslate_sequence(q_seq, bm.q_start, bm.q_end,
                                                   bm.q_frame_shift)
                    else:
                        seq = untranslate_sequence(q_seq, 0, q_frame_len,
                                                   bm.q_frame_shift)
            # else: protein query -> '*'

            tags = self._tags_for(bm, q_seq, n, prot_cigar, write_seq,
                                  lca_tax, lca_name, q_frame_len)

            if self.bam:
                self._write_bam_record(qname, flag, bm.n_s_id, pos0, cigar,
                                       seq, tags)
            else:
                line = "\t".join([
                    qname, str(flag), self.refs[bm.n_s_id], str(pos0 + 1),
                    "255", cigar_str(cigar), "*", "0", "0", seq, "*",
                ] + [self._sam_tag(t, v, tc) for t, v, tc in tags])
                self.fh.write(line + "\n")

    def _tags_for(self, bm, q_seq, n_matches, prot_cigar, wrote_seq,
                  lca_tax, lca_name, q_frame_len):
        """Ordered (tag, value, typecode) per search_output.hpp:601-719."""
        opt, ctx = self.opt, self.ctx
        out = []
        t = self.tags
        if "ae" in t:
            out.append(("ae", float(f"{bm.e_value:.6g}"), "f"))
        # full-width scores (deviation from the reference's uint8/uint16
        # casts, search_output.hpp:623 — 'ar' wraps at raw score 255
        # there, i.e. for exactly the best hits)
        if "AS" in t:
            out.append(("AS", int(bm.bit_score), "I"))
        if "ar" in t:
            out.append(("ar", int(bm.raw_score), "I"))
        if "ai" in t:
            out.append(("ai", int(bm.identity) & 0xFF, "C"))
        if "ap" in t:
            out.append(("ap", int(bm.similarity) & 0xFFFF, "S"))
        if "qf" in t:
            out.append(("qf", bm.q_frame_shift, "c"))
        if "sf" in t:
            out.append(("sf", bm.s_frame_shift, "c"))
        if "st" in t:
            v = ";".join(str(x) for x in bm.s_tax_ids) if bm.s_tax_ids else "*"
            out.append(("st", v, "Z"))
        if "ls" in t:
            out.append(("ls", lca_name or "*", "Z"))
        if "lt" in t:
            out.append(("lt", int(lca_tax), "I"))
        if "qs" in t:
            if self.ctx.program.value == "blastn" or not wrote_seq:
                out.append(("qs", "*", "Z"))
            else:
                frame = ctx.query_frame(q_seq, bm.qry_frame_id % ctx.qry_num_frames)
                if opt.sam_bam_hard_clip:
                    out.append(("qs", ab.decode(frame[bm.q_start : bm.q_end],
                                                ctx.idx.trans_alph), "Z"))
                else:
                    out.append(("qs", ab.decode(frame, ctx.idx.trans_alph), "Z"))
        if "OC" in t:
            out.append(("OC", cigar_str(prot_cigar), "Z"))
        if "NM" in t:
            out.append(("NM", bm.align_length - bm.num_matches, "I"))
        if "IH" in t:
            out.append(("IH", n_matches, "I"))
        return out

    @staticmethod
    def _sam_tag(tag, value, typecode) -> str:
        if typecode == "f":
            return f"{tag}:f:{value}"
        if typecode == "Z":
            return f"{tag}:Z:{value}"
        return f"{tag}:i:{value}"

    # ---------------- BAM encoding ----------------

    _CIGAR_OP = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6}
    _SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}

    def _write_bam_record(self, qname, flag, ref_id, pos0, cigar, seq, tags):
        name = qname.encode() + b"\x00"
        if len(name) > 255:
            # BAM packs l_read_name as uint8 (and the SAM spec caps
            # QNAME at 254 chars) — fail with the remedy instead of an
            # opaque struct.error after all compute is done
            raise RuntimeError(
                f"query id '{qname[:40]}...' is {len(name) - 1} chars; "
                "BAM limits read names to 254 (rebuild/run with "
                "--truncate-ids or shorten the FASTA ids)")
        n_cigar = len(cigar)
        seq_b = b""
        l_seq = 0
        if seq != "*":
            l_seq = len(seq)
            nib = [self._SEQ_NT16.get(c.upper(), 15) for c in seq]
            if l_seq % 2:
                nib.append(0)
            seq_b = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
        qual_b = b"\xff" * l_seq
        # reg2bin of [pos, pos+1)
        bin_ = _reg2bin(pos0, pos0 + max(1, _ref_span(cigar)))
        rec = struct.pack("<iiBBHHHiiii", ref_id, pos0, len(name), 255, bin_,
                          n_cigar, flag, l_seq, -1, -1, 0)
        rec += name
        for op, n in cigar:
            rec += struct.pack("<I", (n << 4) | self._CIGAR_OP[op])
        rec += seq_b + qual_b
        for tag, value, tc in tags:
            tb = tag.encode()
            if tc == "f":
                rec += tb + b"f" + struct.pack("<f", value)
            elif tc == "Z":
                rec += tb + b"Z" + str(value).encode() + b"\x00"
            elif tc == "c":
                rec += tb + b"c" + struct.pack("<b", value)
            elif tc == "C":
                rec += tb + b"C" + struct.pack("<B", value)
            elif tc == "S":
                rec += tb + b"S" + struct.pack("<H", value)
            else:  # I
                rec += tb + b"I" + struct.pack("<I", value)
        self._bgzf_write(struct.pack("<i", len(rec)) + rec)

    # ---------------- bgzf ----------------

    def _bgzf_write(self, data: bytes) -> None:
        self._bgzf_buf += data
        while len(self._bgzf_buf) >= 0xFF00:
            self._bgzf_flush_block(self._bgzf_buf[:0xFF00])
            self._bgzf_buf = self._bgzf_buf[0xFF00:]

    def _bgzf_flush_block(self, chunk: bytes) -> None:
        from .. import native
        self.fh.write(native.bgzf_compress_block(chunk))

    def write_footer(self) -> None:
        if self.bam:
            if self._bgzf_buf:
                self._bgzf_flush_block(self._bgzf_buf)
                self._bgzf_buf = b""
            # bgzf EOF marker
            self.fh.write(bytes.fromhex(
                "1f8b08040000000000ff0600424302001b0003000000000000000000"))
        self.fh.close()


def _ref_span(cigar) -> int:
    return sum(n for op, n in cigar if op in ("M", "D", "N"))


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


TAG_DESCRIPTIONS = {
    "AS": "bit score",
    "OC": "query protein cigar (* for BLASTN)",
    "NM": "edit distance (in protein space unless BLASTN)",
    "IH": "number of matches this query has",
    "ar": "raw score",
    "ae": "expect value",
    "ai": "% identity (in protein space unless BLASTN) ",
    "ap": "% positive (in protein space unless BLASTN)",
    "qf": "query frame",
    "qs": "query protein sequence (* for BLASTN)",
    "sf": "subject frame",
    "st": "subject taxonomy IDs (* if n/a)",
    "ls": "lowest common ancestor scientific name",
    "lt": "lowest common ancestor taxonomy ID",
}
