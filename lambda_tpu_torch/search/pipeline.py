"""Search pipeline (the index resident on one CUDA device, streamed
through it, or sharded over a (q, db) grid of devices).

Port of ``lambda_tpu/search/pipeline.py``, the equivalent of the
reference's search ``realMain`` + per-batch loop
(``lambda/src/search.cpp:340-477``) and ``iterateMatches*``
(``lambda/src/search_algo.hpp:1178-1385``):

host                                      device
----                                      ------
load index, queries                       k-mer index tensors
frame generation + seed schedule    ->    fused seeding (search/seeding.py)
packed hits + stats vector          <-
widen/merge matches (numpy + C++)   ->    pass 1: K1 (or K3) banded scores
bit-score/e-value filters           <-
pass 2: traceback + alignment stats (host C++),   [LAMBDA_SW_TRACE=device:
                                                    K2 direction codes,
        host walk + per-match stats           <-    walked on the host]
%id filter, record sort/dedup/LCA, m8/m9/m0/SAM/BAM writing

The two-phase iterative search (search0; search_algo.hpp:1391-1460) runs
per batch: phase 1 with cheap seeds, successful queries are written,
survivors re-searched with full sensitivity.  Every program of the JAX
package runs: BLASTP, BLASTX, TBLASTN, TBLASTX, BLASTN and bisulfite
(whose odd subject frames score with the reverse matrix), with seed delta
0-3 (pigeonhole seeding for delta >= 2).  ``--db-stream N`` keeps the
index on the host as N shards streamed through the card per query batch
(search/seeding.py:make_stream_seeder), ``--shard-subset`` searches a
host's slice of a sharded index (tools/merge_m8.py merges the slices),
``--trace-dir`` records a torch.profiler trace of the search loop.
``--db-shards``/``--q-shards`` shard the index and the query batch over a
(q, db) grid of devices in this one process (parallel/mesh.py: the
seeding per cell with its decisions summed over each q row, pass 1 per
cell on the cell's local subject shard; ``SearchContext(devices=...)``
may lay several cells on one card), and ``--distributed ADDR,PID,N``
joins the process to a torch.distributed group (gloo) for a multi-host
run whose hosts each search a ``--shard-subset``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time

import numpy as np
import torch

from .. import __version__, alphabets as ab
from .. import frames as fr
from .. import options as opt_mod
from .. import scoring, statistics
from ..index import artifact
from ..io import fasta
from ..ops import searchsorted as ss, sw_band
from ..output import blast_report, blast_tab, sam_bam
from ..stats import StatsHolder, span, timed
from . import extend, records, seeding


def index_arrays(idx, bucket_m: int, allow_partial: bool = False) -> dict:
    """The numpy arrays of a loaded index that the search keeps on the
    device (any object with the IndexData attributes: the JAX package's
    ``load_index`` result works too).  ``bucket`` is the first-word prefix
    table of ``bucket_m`` characters (None for 0); ``allow_partial``: a
    --shard-subset load, whose k-mer rows are the loaded shards'."""
    kg = idx.get_kmer(allow_partial=allow_partial)
    return dict(
        keys=kg.keys, pos=kg.pos, frame=kg.frame,
        bucket=(ss.prefix_table(kg.keys[:, 0], kg.bits, bucket_m)
                if bucket_m else None),
        sbj_offsets=idx.trans_offsets[:-1], sbj_lens=idx.trans_lengths,
        trans_concat=idx.trans_concat)


def resident_index(arrays: dict, device) -> dict:
    """Upload an index's arrays (see :func:`index_arrays`) as the port's
    device tensors: keys int64 (uint32 word values), pos/frame int32,
    bucket/subject offsets/lengths int64, the translated concat int8."""
    dev = torch.device(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a).astype(dt),
                               device=dev)

    return dict(
        keys=put(arrays["keys"], np.int64),
        pos=put(arrays["pos"], np.int32),
        frame=put(arrays["frame"], np.int32),
        bucket=(put(arrays["bucket"], np.int64)
                if arrays.get("bucket") is not None else None),
        sbj_offsets=put(arrays["sbj_offsets"], np.int64),
        sbj_lens=put(arrays["sbj_lens"], np.int64),
        trans_sbj=put(arrays["trans_concat"], np.int8))


@dataclasses.dataclass
class _SeedDispatch:
    """In-flight seeding dispatch (phase A of process_batch): the host
    inputs needed for a budget-doubling re-dispatch plus the device
    outputs collect_batch pulls."""

    so: opt_mod.SearchOpts
    qry_seqs: list          # padded to the bucketed count Q
    Q: int
    trans: list             # translated query frames
    qlens: np.ndarray       # per-frame lengths (host copy)
    slot_frame: np.ndarray
    slot_begin: np.ndarray
    slot_rem: np.ndarray
    d_red_q: object
    d_trans_q: object
    d_qlens: object
    scale: int = 1          # cursor/hit budget multiplier (retry doubles)
    res2: dict | None = None   # fused seeding outputs (device tensors)
    stream_decided: tuple | None = None  # db-stream global decisions
    stream_outs: list | None = None      # db-stream per-shard pass-B outputs
    mesh_outs: list | None = None        # device mesh per-cell outputs
    # CUDA events around each seeder call not yet read (collect_batch
    # reads them after its stats pull, which has waited for them), and
    # under the mesh those around each cell's passes (stats.card_clock)
    events: list = dataclasses.field(default_factory=list)
    card_events: list = dataclasses.field(default_factory=list)


class SearchContext:
    """Everything that is fixed for a whole run."""

    def __init__(self, opt: opt_mod.LambdaOptions, device="cuda",
                 devices=None):
        """``device``: where the index and the query batches live (the
        mesh's cells: every visible card for 'cuda', else ``device`` in
        every cell).  ``devices``: the mesh's cells explicitly, row-major
        (cell (i, j) at ``i * db_shards + j``); a device may repeat, so
        one card can hold a whole grid."""
        self.opt = opt
        self.device = torch.device(device)
        self.db_shards = max(1, int(getattr(opt, "db_shards", 1)))
        self.q_shards = max(1, int(getattr(opt, "q_shards", 1)))
        # --db-stream N: keep the sharded index HOST-resident and stream
        # the shards one after another through the card per query batch
        # -- the envelope the reference gets from host RAM
        # (search_algo.hpp:126-155: RAM, not accelerator memory, bounds
        # the database).  Output bytes are those of the resident index.
        self.db_stream = max(1, int(getattr(opt, "db_stream", 1)))
        # --shard-subset: the per-host slice of a multi-host deployment
        # (only those k-mer shards are loaded; subjects outside them
        # produce no seeds, and dbTotalLength/e-values stay GLOBAL so
        # per-host outputs merge consistently)
        self.shard_subset = getattr(opt, "shard_subset", None)
        if self.q_shards not in (1, 2, 4, 8, 16):
            raise RuntimeError("--q-shards must be a power of two <= 16 "
                               "(query batches are bucketed in multiples "
                               "of 16).")
        if self.db_stream > 1 and self.db_shards * self.q_shards > 1:
            raise RuntimeError("--db-stream (sequential host-resident "
                               "shards) cannot be combined with the "
                               "--db-shards/--q-shards device mesh.")
        if self.db_stream > 1 and self.shard_subset is not None:
            raise RuntimeError("--db-stream does not support "
                               "--shard-subset; load the full index on "
                               "this host (it only needs host RAM).")
        self.mesh = None
        n_dev = self.q_shards * self.db_shards
        if n_dev > 1:
            from ..parallel import mesh as pmesh

            if devices is None:
                devices = ([torch.device("cuda", k) for k in
                            range(torch.cuda.device_count())]
                           if self.device.type == "cuda"
                           else [self.device] * n_dev)
            if len(devices) < n_dev:
                raise RuntimeError(
                    f"--q-shards {self.q_shards} x --db-shards "
                    f"{self.db_shards} needs {n_dev} devices; only "
                    f"{len(devices)} available.")
            self.mesh = pmesh.Mesh(list(devices)[:n_dev], self.q_shards,
                                   self.db_shards)
            self.device = self.mesh.devices[0]

        self.idx = artifact.load_index(opt.index_file,
                                       shards=self.shard_subset)
        idx = self.idx
        if self.shard_subset is not None and not idx.kmer_shards:
            raise RuntimeError(
                "--shard-subset requires a SHARDED index "
                "(mkindex --shards N).")
        # --- domain/index compatibility checks (search.cpp:189-207)
        dom = opt.domain
        if dom == opt_mod.Domain.PROTEIN and idx.trans_alph != ab.AMINO_ACID:
            raise RuntimeError("ERROR: protein search requires a protein "
                               "index (created by mkindexp).")
        if dom == opt_mod.Domain.NUCLEOTIDE and idx.red_alph != ab.DNA4:
            raise RuntimeError("ERROR: nucleotide search requires a "
                               "nucleotide index (created by mkindexn).")
        if dom == opt_mod.Domain.BISULFITE and idx.red_alph != ab.DNA3BS:
            raise RuntimeError("ERROR: bisulfite search requires a "
                               "bisulfite index (created by mkindexbs).")

        # --- query alphabet (search.cpp:210-217)
        qalph = opt.qry_orig_alphabet
        if dom != opt_mod.Domain.PROTEIN:
            qalph = ab.DNA5
        elif qalph in ("auto", "dna5"):
            first = next(fasta.iter_seqs(opt.query_file), None)
            if first is None:
                from ..misc import QueryException
                raise QueryException("Query file is empty.")
            qalph = artifact.detect_alphabet(first.seq) \
                if opt.qry_orig_alphabet == "auto" else ab.DNA5
        else:
            qalph = ab.AMINO_ACID
        self.qry_orig_alph = qalph

        self.program = opt_mod.blast_program(idx.trans_alph, qalph,
                                             idx.orig_alph)
        self.qry_num_frames = opt_mod.qry_num_frames(self.program,
                                                     idx.red_alph)
        self.sbj_num_frames = opt_mod.sbj_num_frames(self.program,
                                                     idx.red_alph)
        self.bs_mode = idx.red_alph == ab.DNA3BS

        # --- scoring (prepareScoring, search_algo.hpp:161-234); bisulfite
        # scores even subject frames with the forward matrix and odd ones
        # with the reverse matrix
        if idx.trans_alph == ab.AMINO_ACID:
            self.align_fwd = scoring.make_protein_scheme(
                opt.scoring_method, opt.gap_open, opt.gap_extend)
            self.align_rev = self.align_fwd
            stats_kind = f"blosum{opt.scoring_method}"
        elif self.bs_mode:
            self.align_fwd = scoring.make_bisulfite_scheme(
                opt.match, opt.mismatch, opt.gap_open, opt.gap_extend, "fwd")
            self.align_rev = scoring.make_bisulfite_scheme(
                opt.match, opt.mismatch, opt.gap_open, opt.gap_extend, "rev")
            stats_kind = "simple"
        else:
            self.align_fwd = scoring.make_nucleotide_scheme(
                opt.match, opt.mismatch, opt.gap_open, opt.gap_extend)
            self.align_rev = self.align_fwd
            stats_kind = "simple"
        self.ka_params = statistics.get_ka_params(
            stats_kind, opt.gap_open, opt.gap_extend,
            match=opt.match, mismatch=opt.mismatch)
        self.evaluer = statistics.EValuer(
            self.ka_params, idx.db_total_length, self.program.q_translated)

        # device coordinates of the subject concat are int32-bounded in
        # the JAX package, per SHARD under streaming or the mesh; keep the
        # same limit so both accept the same DBs.  Shards split subjects
        # by COUNT (np.array_split: parallel/mesh.py and the mkindex
        # --shards bounds), so bound the MAX per-shard length, not the
        # average.
        n_split = max(self.db_shards, self.db_stream)
        if n_split <= 1:
            max_shard_len = int(idx.db_total_length)
        elif idx.shard_subj_bounds is not None:
            b = np.asarray(idx.shard_subj_bounds, dtype=np.int64)
            tl = np.asarray(idx.trans_lengths, dtype=np.int64)
            cum = np.zeros(len(tl) + 1, np.int64)
            np.cumsum(tl, out=cum[1:])
            fb = (b * idx.sbj_num_frames).astype(np.int64)
            max_shard_len = int(np.max(cum[fb[1:]] - cum[fb[:-1]])) \
                if len(b) > 1 else int(idx.db_total_length)
        else:
            tl = np.asarray(idx.trans_lengths, dtype=np.int64)
            per_subj = tl.reshape(-1, idx.sbj_num_frames).sum(axis=1)
            groups = np.array_split(np.arange(len(per_subj)), n_split)
            max_shard_len = max(
                (int(per_subj[g].sum()) for g in groups if len(g)),
                default=0)
        if max_shard_len >= 2 ** 31:
            raise RuntimeError(
                "database exceeds 2^31 translated characters on at least "
                "one device shard; increase --db-shards/--db-stream (or "
                "split the database).")
        # first-word prefix bucket table (ops/searchsorted.prefix_table)
        km = idx.kmer_meta
        self.bucket_m = ss.pick_bucket_m(
            km.bits, km.chars_per_word,
            idx.kmer.num_positions if idx.kmer is not None
            else max(s.num_positions for s in idx.kmer_shards))
        self._check_device_memory()
        self._d_red_sbj = None
        self.stream_sh = None
        if self.mesh is not None:
            self._mesh_setup()
        elif self.db_stream <= 1:
            d = resident_index(index_arrays(
                idx, self.bucket_m,
                allow_partial=self.shard_subset is not None), self.device)
            self.d_keys, self.d_pos, self.d_frame = d["keys"], d["pos"], \
                d["frame"]
            self.d_bucket = d["bucket"]
            self.d_sbj_offsets = d["sbj_offsets"]
            self.d_sbj_lens = d["sbj_lens"]
            self.d_trans_sbj = d["trans_sbj"]
        else:
            self._stream_setup()

        # prescore matrices over the trans alphabet
        self.d_sub_fwd = torch.as_tensor(
            self.align_fwd.matrix.astype(np.int64), device=self.device)
        self.d_sub_rev = torch.as_tensor(
            self.align_rev.matrix.astype(np.int64), device=self.device)

        # SW padded matrices: int32 for the host pass 2, int8 for K1-K3
        self.sw_fwd = sw_band.extend_matrix(self.align_fwd.matrix)
        self.sw_rev = sw_band.extend_matrix(self.align_rev.matrix)
        self.e8_fwd = sw_band.ext8_from_ext32(self.sw_fwd)
        self.e8_rev = sw_band.ext8_from_ext32(self.sw_rev)

        self.s_windows = extend.SubjectWindows(idx.trans_concat,
                                               idx.trans_offsets)
        self.s_orig_lens = (idx.seq_lengths.astype(np.int64)
                            if idx.seq_lengths is not None
                            else np.array([len(s) for s in idx.seqs],
                                          dtype=np.int64))
        self.trans_lens = idx.trans_lengths.astype(np.int64)
        self.unknown_rank = (ab.AA27_CHAR_TO_RANK[ord("X")]
                             if idx.trans_alph == ab.AMINO_ACID else 4)

        # seed lengths must fit the index's packed-key capacity
        cap = idx.kmer_meta.capacity
        phases = [opt.search_opts] + ([opt.search_opts0]
                                      if opt.iterative_search else [])
        for so in phases:
            if so.seed_length > cap:
                raise RuntimeError(
                    f"--seed-length {so.seed_length} exceeds this index's "
                    f"key capacity ({cap} characters); rebuild the index "
                    "with more --kmer-words or use a shorter seed.")

        self._seeders: dict = {}
        # sticky per-phase budget scale: later batches START at the scale
        # that fit (results are scale-invariant whenever the accepted
        # dispatch did not overflow, so output bytes cannot change)
        self._budget_scale: dict = {}

    def _check_device_memory(self):
        """Pre-flight device-memory estimate (device-side analogue of
        checkRAM, search_algo.hpp:126-155): warn when the resident index
        -- under --db-stream N one shard of it, under the mesh the shards
        of each card's cells -- likely exceeds that card's memory."""
        for dev, need in self.device_memory_needs().items():
            if dev.type != "cuda":
                continue
            _, total = torch.cuda.mem_get_info(dev)
            if need > 0.9 * total and self.opt.verbosity >= 1:
                print(f"WARNING: the device-resident index needs "
                      f"~{need >> 20} MiB of ~{total >> 20} MiB of {dev}'s "
                      "memory; consider --db-stream N or more "
                      "--db-shards.")

    def device_memory_needs(self) -> dict:
        """The index bytes each device will hold: {device: bytes}.  One
        device: int64 keys, int32 pos and frame, the int8 subject concat
        (one shard of them under --db-stream).  The mesh: on each distinct
        device, the db shards of its cells, each padded as ``Mesh.put_db``
        places it -- to the largest shard's k-mer rows, residues (int8
        trans and red) and frames (int64 offsets and lengths), with its
        prefix table -- exact for an artifact built with as many shards,
        the rows of each shard estimated by its residues otherwise."""
        idx = self.idx
        kms = [idx.kmer] if idx.kmer is not None else idx.kmer_shards
        if self.mesh is None:
            need = (sum(k.keys.size * 8 + k.pos.size * 8 for k in kms)
                    + len(idx.trans_concat)) // self.db_stream
            return {self.device: need}
        D = self.db_shards
        offs = np.asarray(idx.trans_offsets, dtype=np.int64)
        rows = None
        if idx.kmer_shards and len(idx.kmer_shards) == D:
            fb = idx.shard_frame_bounds()
            rows = np.array([k.num_positions for k in idx.kmer_shards])
        else:
            fps = max(1, self.sbj_num_frames)
            n_subj = (len(offs) - 1) // fps
            fb = np.r_[0, np.cumsum([len(g) for g in np.array_split(
                np.arange(n_subj), D)])] * fps
        residues = offs[fb[1:]] - offs[fb[:-1]]
        if rows is None:
            n_rows = sum(k.num_positions for k in kms)
            rows = -(-n_rows * residues // max(int(residues.sum()), 1))
        words = idx.kmer_meta.words
        shard = (max(int(rows.max()), 1) * (8 * words + 8)
                 + max(int(residues.max()), 1) * 2
                 + max(int(np.diff(fb).max()), 1) * 16)
        if self.bucket_m:
            shard += ((1 << (idx.kmer_meta.bits * self.bucket_m)) + 1) * 8
        held: dict = {}
        for c, dev in enumerate(self.mesh.devices):
            held.setdefault(dev, set()).add(c % D)
        return {dev: shard * len(js) for dev, js in held.items()}

    def _stream_setup(self):
        """--db-stream N: the index as N host-resident shards, split the
        same way as the device mesh's (subject-contiguous, never splitting
        a subject); a sharded artifact with N shards feeds them directly.
        The host keeps ONE copy: the global k-mer arrays are released (a
        metadata-only stub stays for kmer_meta), and on a CUDA device the
        shard arrays move into pinned host tensors (keys as their int32
        bit pattern: half the bytes of the card's int64 keys) that
        _stream_seed_call uploads per pass.  The subject concat stays on
        the host too: pass 1 and pass 2 gather their windows there."""
        from ..index.build import KmerIndex
        from ..parallel import mesh

        idx = self.idx
        if idx.kmer_shards and len(idx.kmer_shards) == self.db_stream:
            sh = mesh.shard_prebuilt_index(idx, self._reduced_concat())
        else:
            sh = mesh.shard_loaded_index(
                idx.get_kmer(allow_partial=False), idx.trans_concat,
                self._reduced_concat(), idx.trans_offsets,
                idx.trans_lengths, self.db_stream,
                frames_per_subject=self.sbj_num_frames)
        km = idx.kmer_meta
        idx.kmer = KmerIndex(alphabet_size=km.alphabet_size, bits=km.bits,
                             words=km.words,
                             keys=np.zeros((0, km.words), np.uint32),
                             pos=np.zeros(0, np.uint32),
                             frame=np.zeros(0, np.uint32))
        idx.kmer_shards = []
        if self.bucket_m:
            sh["bucket"] = np.stack([
                ss.prefix_table(sh["keys"][i, :, 0], km.bits, self.bucket_m)
                for i in range(sh["keys"].shape[0])])
        sh["keys"] = sh["keys"].view(np.int32)
        pin = self.device.type == "cuda"
        self.stream_base = sh.pop("base").astype(np.int64)
        self.stream_sh = {}
        for name in list(sh):
            t = torch.from_numpy(sh.pop(name))
            self.stream_sh[name] = t.pin_memory() if pin else t
        # host-resident subject tensors (windows are gathered there); the
        # uint8 concat is viewed, not copied
        self.d_trans_sbj = torch.from_numpy(idx.trans_concat.view(np.int8))
        self.d_sbj_offsets = torch.from_numpy(
            idx.trans_offsets[:-1].astype(np.int64))
        self.d_sbj_lens = torch.from_numpy(
            idx.trans_lengths.astype(np.int64))
        self._stream_seeders: dict = {}

    def _mesh_setup(self):
        """--db-shards/--q-shards: the index split into db_shards
        subject-contiguous shards (a sharded artifact with that many shards
        feeds them directly), each shard's tensors placed on every
        distinct device of its db column once (parallel/mesh.py:
        Mesh.put_db), with its first-word prefix table.  The subject
        concat stays on the host too: pass 2 gathers its windows there,
        as under --db-stream."""
        from ..parallel import mesh as pmesh

        idx = self.idx
        if idx.kmer_shards and len(idx.kmer_shards) == self.db_shards:
            sh = pmesh.shard_prebuilt_index(idx, self._reduced_concat())
        else:
            sh = pmesh.shard_loaded_index(
                idx.get_kmer(allow_partial=self.shard_subset is not None),
                idx.trans_concat, self._reduced_concat(), idx.trans_offsets,
                idx.trans_lengths, self.db_shards,
                frames_per_subject=self.sbj_num_frames)
        self.shard_base = sh["base"].astype(np.int64)
        m = self.mesh
        bucket = None
        if self.bucket_m:
            bucket = m.put_db(np.stack([
                ss.prefix_table(sh["keys"][i, :, 0], idx.kmer_meta.bits,
                                self.bucket_m)
                for i in range(sh["keys"].shape[0])]), torch.int64)
        self.d_sh = dict(
            keys=m.put_db(sh["keys"]), pos=m.put_db(sh["pos"]),
            frame=m.put_db(sh["frame"]),
            offsets=m.put_db(sh["offsets"], torch.int64),
            lengths=m.put_db(sh["lengths"], torch.int64),
            trans=m.put_db(sh["trans"]), red=m.put_db(sh["red"]),
            bucket=bucket)
        del sh
        self.d_trans_sbj = torch.from_numpy(idx.trans_concat.view(np.int8))
        self.d_sbj_offsets = torch.from_numpy(
            idx.trans_offsets[:-1].astype(np.int64))
        self.d_sbj_lens = torch.from_numpy(
            idx.trans_lengths.astype(np.int64))
        # the set-up ends with every card's uploads done, so that a clock
        # around it (time_load, the benchmark's index_load_s) holds them
        for d in self.mesh_cards():
            torch.cuda.synchronize(d)

    def mesh_cards(self) -> list:
        """The distinct CUDA devices of the mesh's cells, in cell order
        (none without the mesh or on the CPU)."""
        if self.mesh is None:
            return []
        return list(dict.fromkeys(d for d in self.mesh.devices
                                  if d.type == "cuda"))

    def _reduced_concat(self) -> np.ndarray:
        """Host reduced-alphabet subject concat (redView over the subject,
        shared_definitions.hpp:270-281)."""
        o = self.idx.trans_offsets
        tf = [self.idx.trans_concat[o[i]:o[i + 1]]
              for i in range(len(o) - 1)]
        red = fr.reduce_frames(tf, self.idx.trans_alph, self.idx.red_alph)
        return (np.concatenate(red) if red
                else np.zeros(0, np.uint8)).astype(np.int8)

    @property
    def d_red_sbj(self):
        """Reduced-alphabet subject concat on the device; needed only by
        pigeonhole (delta >= 2) verification on the resident index, built
        on first use."""
        if self._d_red_sbj is None:
            self._d_red_sbj = torch.as_tensor(self._reduced_concat(),
                                              device=self.device)
        return self._d_red_sbj

    def query_frame(self, q_seq: np.ndarray, frame_idx: int) -> np.ndarray:
        """Regenerate one translated frame of a query (used at output time
        for alignment display / SAM).  Frames are cached for the last
        query: m0/SAM emit one row per match."""
        # key the cache on the ARRAY OBJECT (strong reference), not a
        # bare id(): CPython reuses freed addresses, so an id key could
        # silently serve a previous query's frames to a later one
        if getattr(self, "_qf_cache_key", None) is not q_seq:
            self._qf_cache_key = q_seq
            self._qf_cache = fr.query_trans_frames(
                [q_seq], self.qry_orig_alph, self.idx.trans_alph,
                self.idx.red_alph, self.opt.genetic_code)
        return self._qf_cache[frame_idx]

    def subject_frame(self, frame_id: int) -> np.ndarray:
        o = self.idx.trans_offsets
        return self.idx.trans_concat[o[frame_id]: o[frame_id + 1]]

    def alignment_rows(self, bm, q_seq: np.ndarray):
        """Display rows for the m0 report."""
        F = self.qry_num_frames
        qf = self.query_frame(q_seq, bm.qry_frame_id % F)
        sf = self.subject_frame(bm.subj_frame_id)
        q_chars = ab.decode(qf, self.idx.trans_alph)
        s_chars = ab.decode(sf, self.idx.trans_alph)
        use_rev = self.bs_mode and bm.subj_frame_id % 2 == 1
        subst = (self.align_rev if use_rev else self.align_fwd).matrix

        def positive(qi, sj):
            return subst[int(qf[qi]), int(sf[sj])] > 0

        return blast_report.build_alignment_rows(
            bm, q_chars, s_chars, subst, positive,
            3 if self.program.q_translated else 1,
            3 if self.program.s_translated else 1)

    def seeder_for(self, so: opt_mod.SearchOpts, scale: int = 1):
        """Seeder for a phase config; ``scale`` multiplies the cursor/hit
        budgets (overflow retry doubles it)."""
        key = (so.seed_length, so.seed_offset, so.max_seed_dist, scale)
        if key not in self._seeders:
            cfg = seeding.SeedConfig(
                seed_length=so.seed_length,
                seed_offset=so.seed_offset,
                max_seed_dist=so.max_seed_dist,
                half_exact=self.opt.seed_half_exact,
                adaptive=self.opt.adaptive_seeding,
                max_matches=int(self.opt.max_matches),
                pre_scoring=self.opt.pre_scoring,
                pre_scoring_thresh=self.opt.pre_scoring_thresh,
                alphabet_size=ab.ALPHABET_SIZES[self.idx.red_alph],
                bits=self.idx.kmer_meta.bits,
                cpw=self.idx.kmer_meta.chars_per_word,
                words=self.idx.kmer_meta.words,
                max_cursors=4096 * scale,
                max_hits=self.opt.max_hits_per_query_frame * 8 * scale,
                bucket_m=self.bucket_m,
            )
            self._seeders[key] = seeding.make_seeder(cfg)
        return self._seeders[key]

    def stream_seeder_for(self, so: opt_mod.SearchOpts, scale: int = 1):
        """The db-stream passes of a phase config (budgets are PER SHARD,
        like the JAX package's mesh and stream budgets)."""
        key = (so.seed_length, so.seed_offset, so.max_seed_dist, scale)
        if key not in self._stream_seeders:
            self._stream_seeders[key] = seeding.make_stream_seeder(
                self.seeder_for(so, scale).cfg)
        return self._stream_seeders[key]

    def _sharded_scores(self, m, d_trans_q, gf: int, ge: int,
                        stats=None) -> np.ndarray:
        """Pass-1 banded scores over the (q, db) grid
        (extend.score_parts): one part per cell, its q block of query rows
        and its LOCAL subject shard; a match's part is the cell of its
        query block and subject shard, so each cell launches its own rows
        of each (qlen, band, matrix) class, and nothing for a class it
        holds no row of.  The pulls are the span ``time_mesh_gather``."""
        Qm, Dm = self.mesh.shape
        q_rows = int(d_trans_q.shape[0]) // Qm
        trans_q = self.mesh.put_q(d_trans_q)
        parts = [((trans_q[c], *(self.d_sh[k][c] for k in
                                 ("trans", "offsets", "lengths"))),
                  (c // Dm) * q_rows, int(self.shard_base[c % Dm]))
                 for c in range(Qm * Dm)]
        part_of = (m.qry_id // q_rows) * Dm + np.searchsorted(
            self.shard_base, m.subj_id, side="right") - 1
        card_events = [] if stats is not None else None
        scores = extend.score_parts(
            m, parts, part_of, self.e8_fwd, self.e8_rev, gf, ge,
            self.bs_mode, stats=stats, card_events=card_events,
            pull_span="time_mesh_gather")
        if card_events:
            stats.add_card_seconds(card_events)
        return scores

    # -----------------------------------------------------------------
    # per-batch processing (one phase)
    # -----------------------------------------------------------------

    def process_batch(self, qry_seqs: list[np.ndarray],
                      so: opt_mod.SearchOpts, stats: StatsHolder):
        """Seeding + extension for a batch of ORIGINAL queries with the
        given phase options.  Returns dict: local query idx -> [BlastMatch]."""
        return self.collect_batch(
            self.dispatch_seeding(qry_seqs, so, stats), stats)

    def dispatch_seeding(self, qry_seqs: list[np.ndarray],
                         so: opt_mod.SearchOpts, stats: StatsHolder):
        """Phase A of process_batch: build the query frames/seed slots and
        run the fused seeding WITHOUT pulling its results (CUDA launches
        are asynchronous; collect_batch pulls).  Returns the handle
        collect_batch takes."""
        with stats.timed("time_seed_prep"):
            sd = self._prepare_seeding(qry_seqs, so, stats)
        self._seed_device_call(sd, stats)
        return sd

    def _prepare_seeding(self, qry_seqs, so, stats):
        """The host half of :meth:`dispatch_seeding`: frames, seed
        schedule, padding and the int8 uploads."""
        idx, opt = self.idx, self.opt
        cfg = self.seeder_for(so).cfg

        # pad the query list to a bucketed count (multiple of 16)
        n_real = len(qry_seqs)
        Q = -(-extend._bucket(max(n_real, 1)) // 16) * 16
        qry_seqs = list(qry_seqs) + [np.zeros(0, np.uint8)] * (Q - n_real)

        trans = fr.query_trans_frames(qry_seqs, self.qry_orig_alph,
                                      idx.trans_alph, idx.red_alph,
                                      opt.genetic_code)
        red = fr.reduce_frames(trans, idx.trans_alph, idx.red_alph)
        G = len(trans)

        slot_frame, slot_begin, slot_rem, T, sched_st = \
            seeding.compute_seed_slots(trans, self.qry_num_frames,
                                       self.unknown_rank, cfg)
        stats.hits_masked += sched_st[0]
        stats.hits_too_short += sched_st[1]
        # bucket the slot count as well
        pad_t = extend._bucket(T) - T
        if pad_t:
            slot_frame = np.pad(slot_frame, ((0, 0), (0, pad_t)),
                                constant_values=-1)
            slot_begin = np.pad(slot_begin, ((0, 0), (0, pad_t)))
            slot_rem = np.pad(slot_rem, ((0, 0), (0, pad_t)),
                              constant_values=1)

        Lmax = extend._bucket(
            max(max((len(f) for f in trans), default=1), cfg.seed_length + 1))
        # int8 uploads (alphabet ranks are < 30); consumers widen
        red_q = np.zeros((G, Lmax), dtype=np.int8)
        trans_q = np.zeros((G, Lmax), dtype=np.int8)
        qlens = np.zeros(G, dtype=np.int32)
        for g, (tf, rf) in enumerate(zip(trans, red)):
            qlens[g] = len(tf)
            trans_q[g, : len(tf)] = tf
            red_q[g, : len(rf)] = rf

        dev = self.device
        sd = _SeedDispatch(
            so=so, qry_seqs=qry_seqs, Q=Q, trans=trans, qlens=qlens,
            slot_frame=slot_frame, slot_begin=slot_begin, slot_rem=slot_rem,
            d_red_q=torch.as_tensor(red_q, device=dev),
            d_trans_q=torch.as_tensor(trans_q, device=dev),
            d_qlens=torch.as_tensor(qlens, device=dev),
            scale=self._budget_scale.get(
                (so.seed_length, so.seed_offset, so.max_seed_dist), 1))
        return sd

    def _next_scale(self, st2: dict, scale: int) -> int:
        """Budget scale for the overflow re-dispatch: jump straight to the
        power of two that FITS the reported overflow magnitudes.  The
        accepted program is the same whichever path reached it."""
        base_c = 4096
        base_h = int(self.opt.max_hits_per_query_frame) * 8
        need = scale * 2
        if st2["hits_overflow"]:
            need = max(need, -(-(base_h * scale + st2["hits_overflow"])
                               // base_h))
        if st2["cursors_overflow"]:
            need = max(need, -(-(base_c * scale + st2["cursors_overflow"])
                               // base_c))
        p = scale * 2
        while p < need and p < 8:
            p *= 2
        return min(p, 8)

    def _seed_device_call(self, sd: _SeedDispatch, stats: StatsHolder):
        """Run the fused seeding for ``sd`` at its current budget scale; on
        the card between two timing events on the current stream of the
        batch's device (under the mesh the first cell's card alone: each
        cell's passes have events of their own on their card), which
        collect_batch reads."""
        events = None
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            events = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            events[0].record(stream)
        if self.db_stream > 1:
            self._stream_seed_call(sd, stats)
        elif self.mesh is not None:
            self._mesh_seed_call(sd, stats)
        else:
            self._resident_seed_call(sd, stats)
        if events is not None:
            events[1].record(stream)
            sd.events.append(events)

    def _resident_seed_call(self, sd: _SeedDispatch, stats: StatsHolder):
        """The fused seeder on the resident index."""
        seeder = self.seeder_for(sd.so, sd.scale)
        dev = self.device
        with stats.timed("time_seed"):
            sd.res2 = seeder(
                self.d_keys, sd.d_red_q, sd.d_qlens,
                torch.as_tensor(sd.slot_frame, device=dev),
                torch.as_tensor(sd.slot_begin, device=dev),
                torch.as_tensor(sd.slot_rem, device=dev),
                torch.zeros(sd.Q, dtype=torch.int64, device=dev),
                self.d_pos, self.d_frame, self.d_sbj_offsets,
                self.d_sbj_lens, self.d_trans_sbj, sd.d_trans_q,
                self.d_sub_fwd, self.d_sub_rev, self.d_bucket,
                red_sbj=self.d_red_sbj if seeder.pigeon else None,
                stats=stats)

    def _mesh_seed_call(self, sd: _SeedDispatch, stats: StatsHolder):
        """The seeding of one batch over the (q, db) grid
        (parallel/mesh.py:make_sharded_seeder): the query batch in q
        blocks, each cell's tensors resident, nothing uploaded per pass;
        budgets per cell."""
        from ..parallel import mesh as pmesh

        m = self.mesh
        step = pmesh.make_sharded_seeder(m, self.seeder_for(sd.so, sd.scale))
        with stats.timed("time_seed"):
            outs = step(
                *(self.d_sh[k] for k in ("keys", "pos", "frame", "offsets",
                                         "lengths", "trans", "red")),
                m.put_q(sd.d_red_q), m.put_q(sd.d_qlens),
                m.put_q(sd.slot_frame), m.put_q(sd.slot_begin),
                m.put_q(sd.slot_rem), m.put_q(np.zeros(sd.Q, np.int64)),
                m.put_q(sd.d_trans_q), m.put_all(self.d_sub_fwd),
                m.put_all(self.d_sub_rev), self.d_sh["bucket"], stats=stats,
                card_events=sd.card_events)
            sd.mesh_outs = [{k: r[k] for k in ("packed", "stats_vec")}
                            for r in outs]

    def _shard_tensors(self, i: int, sync: bool, stats: StatsHolder):
        """Shard ``i`` on the device: (keys, pos, frame, offsets, lengths,
        trans, red, bucket); keys arrive as the int32 bit pattern and are
        widened there to the int64 uint32 values.  The upload is the span
        ``time_stream_upload`` (with ``sync``: the copies alone, else the
        host's enqueue time)."""
        dev = self.device
        with stats.timed("time_stream_upload"):
            up = {n: x[i].to(dev, non_blocking=True)
                  for n, x in self.stream_sh.items()}
            if sync:
                torch.cuda.synchronize(dev)
        keys = up["keys"].to(torch.int64) & 0xFFFFFFFF
        bkt = up["bucket"].to(torch.int64) if "bucket" in up else None
        return (keys, up["pos"], up["frame"], up["offsets"].to(torch.int64),
                up["lengths"].to(torch.int64), up["trans"], up["red"], bkt)

    def _stream_seed_call(self, sd: _SeedDispatch, stats: StatsHolder):
        """Database-streaming seeding of one batch: pass A per shard
        (local count curves / verified counts) accumulated on the device,
        one global decide, pass B per shard with the decisions forced
        (seeding.make_stream_seeder).  Shard tensors are uploaded per pass
        and freed after use: the card holds one shard plus the batch's
        tensors, never the whole index.

        LAMBDA_STREAM_SYNC=0 skips the per-shard synchronisation that
        bounds how many shard uploads can be in flight."""
        so = sd.so
        strm = self.stream_seeder_for(so, sd.scale)
        D = self.stream_sh["keys"].shape[0]
        dev = self.device
        sync = dev.type == "cuda" and \
            os.environ.get("LAMBDA_STREAM_SYNC", "1") != "0"
        slots = [torch.as_tensor(x, device=dev)
                 for x in (sd.slot_frame, sd.slot_begin, sd.slot_rem)]
        slot_args = (sd.d_red_q, sd.d_qlens, *slots)
        h0 = torch.zeros(sd.Q, dtype=torch.int64, device=dev)

        with stats.timed("time_seed"):
            if sd.stream_decided is None:
                acc = None
                for i in range(D):
                    keys, pos, frame, offs, lens, trans, red, bkt = \
                        self._shard_tensors(i, sync, stats)
                    if strm["pigeon"]:
                        c = strm["pass_a"](
                            keys, *slot_args, h0, pos, frame, offs, lens,
                            trans, sd.d_trans_q, red, self.d_sub_fwd,
                            self.d_sub_rev, bkt, stats=stats)
                    else:
                        c = strm["pass_a"](keys, *slot_args, bkt,
                                           stats=stats)
                    acc = c if acc is None else acc + c
                    del keys, pos, frame, offs, lens, trans, red, bkt, c
                    if sync:
                        torch.cuda.synchronize(dev)
                sd.stream_decided = strm["decide"](acc, sd.d_qlens, *slots,
                                                   h0, stats=stats)
                del acc
            if strm["pigeon"]:
                L_d, keep_d = sd.stream_decided
                forced = (keep_d, L_d)
            else:
                forced = sd.stream_decided
            outs = []
            for i in range(D):
                keys, pos, frame, offs, lens, trans, red, bkt = \
                    self._shard_tensors(i, sync, stats)
                res = strm["pass_b"](
                    keys, *slot_args, h0, pos, frame, offs, lens, trans,
                    sd.d_trans_q, red, self.d_sub_fwd, self.d_sub_rev,
                    *forced, bkt, stats=stats)
                outs.append({k: res[k] for k in ("packed", "stats_vec")})
                del keys, pos, frame, offs, lens, trans, red, bkt, res
                if sync:
                    torch.cuda.synchronize(dev)
            sd.stream_outs = outs

    def collect_batch(self, sd: _SeedDispatch, stats: StatsHolder):
        """Phase B of process_batch: pull the seeding results (retrying
        with doubled budgets on overflow), then extension + the host
        tail.  Returns dict: local query idx -> [BlastMatch]."""
        opt = self.opt
        F = self.qry_num_frames
        so = sd.so
        qry_seqs, trans, qlens = sd.qry_seqs, sd.trans, sd.qlens

        # ONE small stats transfer decides the retry (per shard under
        # streaming); the hit payload moves to the host only after the
        # budgets are accepted, as a bucketed slice of the 16-byte packed
        # rows
        mesh_stats = stats if self.mesh is not None else None
        while True:
            # per shard (streaming), per cell (mesh) or the one resident
            # seeder call
            parts = sd.stream_outs or sd.mesh_outs or [sd.res2]
            with stats.timed("time_locate"), timed(mesh_stats,
                                                   "time_mesh_gather"):
                svs = [r["stats_vec"].cpu().numpy() for r in parts]
            sv = np.stack(svs).astype(np.int64).sum(axis=0)
            stats.seed_syncs += len(parts)
            # the pull waited for the stream, so the seeder calls' events
            # are complete: reading them adds no synchronisation
            for start, end in sd.events:
                stats.dev_seed_s += start.elapsed_time(end) / 1e3
            sd.events.clear()
            stats.add_card_seconds(sd.card_events)
            st2 = dict(hits_located=int(sv[0]), hits_overflow=int(sv[1]),
                       failed_prescore=int(sv[2]),
                       cursors_overflow=int(sv[3]))
            n_sel = int(sv[4])
            if (st2["hits_overflow"] or st2["cursors_overflow"]) \
                    and sd.scale < 8:
                sd.scale = self._next_scale(st2, sd.scale)
                if self.db_stream > 1 and self.seeder_for(so).pigeon:
                    # pigeonhole pass A's counts were budget-truncated:
                    # the decisions are taken again at the new scale (the
                    # curves of delta <= 1 have no budget)
                    sd.stream_decided = None
                self._seed_device_call(sd, stats)
                continue
            break
        key_so = (so.seed_length, so.seed_offset, so.max_seed_dist)
        if sd.scale > self._budget_scale.get(key_so, 1):
            self._budget_scale[key_so] = sd.scale
        stats.hits_after_seeding += st2["hits_located"]
        stats.hits_failed_pre_extend += st2["failed_prescore"]
        stats.hits_overflow += st2["hits_overflow"]
        stats.cursors_overflow += st2["cursors_overflow"]

        if n_sel == 0:
            return {}
        # the packed rows per part (per cell in cell order: the JAX mesh's
        # (q, db, hit) order), concatenated; local subject-frame ids ->
        # global, and under the mesh block-local query-frame ids -> batch
        # rows
        q_base = s_base = np.zeros(len(parts), np.int64)
        if self.mesh is not None:
            Qm, Dm = self.mesh.shape
            s_base = np.tile(self.shard_base, Qm)
            q_base = np.repeat(np.arange(Qm) * (len(trans) // Qm), Dm)
        elif sd.stream_outs:
            s_base = self.stream_base
        rows = []
        with stats.timed("time_locate"), timed(mesh_stats,
                                               "time_mesh_gather"):
            for i, r in enumerate(parts):
                n_i = int(svs[i][4])
                if n_i == 0:
                    continue
                nb = min(extend._bucket(n_i), int(r["packed"].shape[0]))
                p = r["packed"][:nb].cpu().numpy()[:n_i].astype(np.int64)
                stats.seed_syncs += 1
                p[:, 0] += int(s_base[i])
                p[:, 3] += int(q_base[i]) << 8
                rows.append(p)
        packed = np.concatenate(rows, axis=0)
        seed_len = packed[:, 3] & 0xFF
        stats.add_seed_lens(seed_len)
        m = extend.MatchBatch(
            qry_id=packed[:, 3] >> 8,
            subj_id=packed[:, 0],
            qry_start=packed[:, 2],
            qry_end=packed[:, 2] + seed_len,
            subj_start=packed[:, 1],
            subj_end=packed[:, 1] + seed_len,
        )

        # widen + merge (search_algo.hpp:1136-1175)
        with stats.timed("time_merge"):
            m = extend.widen_and_merge(m, qlens.astype(np.int64),
                                       self.trans_lens, stats)
        if len(m) == 0:
            return {}

        # --- pass 1: score only (K1); under --db-stream the subject
        # windows are gathered from the host concat and uploaded, under
        # the mesh each cell gathers them from its local subject shard
        gf = self.align_fwd.dp_gap_first
        ge = self.align_fwd.dp_gap_extend
        with stats.timed("time_extend"):
            if self.mesh is not None:
                scores = self._sharded_scores(m, sd.d_trans_q, gf, ge,
                                              stats=stats)
            else:
                scores = extend.sw_scores_device(
                    m, sd.d_trans_q, self.d_trans_sbj, self.d_sbj_offsets,
                    self.d_sbj_lens, self.e8_fwd, self.e8_rev, gf, ge,
                    self.bs_mode, stats=stats)

        # --- bit-score / e-value filters (search_algo.hpp:1252-1283)
        with stats.timed("time_records"):
            orig_qlens = np.array([len(s) for s in qry_seqs], dtype=np.int64)
            match_qlens = orig_qlens[m.qry_id // F]
            keep = np.ones(len(m), dtype=bool)
            if opt.min_bit_score >= 0:
                fail_bit = self.evaluer.bit_score_v(scores) \
                    < opt.min_bit_score
                stats.hits_failed_bit_score += int(fail_bit.sum())
                keep &= ~fail_bit
            if opt.max_e_value >= 0:
                e_values = self.evaluer.e_value_v(scores, match_qlens)
                fail_e = keep & (e_values > opt.max_e_value)
                stats.hits_failed_e_value += int(fail_e.sum())
                keep &= ~fail_e
            idxs = np.nonzero(keep)[0]
            if len(idxs) == 0:
                return {}
            m2 = m.take(idxs)

        # --- pass 2: traceback + inline alignment stats (host C++), or
        # K2 + a host walk under LAMBDA_SW_TRACE=device (astats None; its
        # per-match stats below are timed into the same bucket, so
        # time_extend_trace covers the same work on both paths)
        with stats.timed("time_extend_trace"):
            scores2b, traces, astats = extend.trace_pass(
                m2, trans, self.s_windows, self.sw_fwd, self.sw_rev, gf, ge,
                self.bs_mode, resident=(sd.d_trans_q, self.d_trans_sbj,
                                        self.d_sbj_offsets, self.d_sbj_lens))

        trace_s = stats.time_extend_trace
        with stats.timed("time_records"):
            out = self._records(m2, traces, scores2b, astats, trans,
                                orig_qlens, stats)
        # the per-match stats of the device traceback are pass 2's
        # (time_extend_trace): the top-level buckets do not overlap
        stats.time_records -= stats.time_extend_trace - trace_s
        return out

    def _records(self, m2, traces, scores2b, astats, trans, orig_qlens,
                 stats: StatsHolder) -> dict:
        """The records of pass 2's alignments (alignment stats computed
        here where ``astats`` is None) that pass the %-identity filter:
        local query idx -> [BlastMatch]."""
        idx, opt = self.idx, self.opt
        F = self.qry_num_frames
        out: dict[int, list[records.BlastMatch]] = {}
        for i in range(len(m2)):
            if traces[i] is None:
                continue
            q0, s0, ops = traces[i]
            qry_id = int(m2.qry_id[i])
            subj_id = int(m2.subj_id[i])
            n_q = qry_id // F
            n_s = subj_id // self.sbj_num_frames
            qfs, sfs = records.set_frames(qry_id, subj_id, self.program,
                                          idx.red_alph)
            consumed_q = sum(r for op, r in ops if op in ("M", "I"))
            consumed_s = sum(r for op, r in ops if op in ("M", "D"))
            bm = records.BlastMatch(
                n_q_id=n_q,
                n_s_id=n_s,
                q_frame_shift=qfs,
                s_frame_shift=sfs,
                q_length=int(orig_qlens[n_q]),
                s_length=int(self.s_orig_lens[n_s]),
                q_start=int(m2.qry_start[i]) + q0,
                q_end=int(m2.qry_start[i]) + q0 + consumed_q,
                # extension windows are virtual: origin = d_lo
                s_start=int(m2.d_lo[i]) + s0,
                s_end=int(m2.d_lo[i]) + s0 + consumed_s,
                raw_score=int(scores2b[i]),
                ops=ops,
                qry_frame_id=qry_id,
                subj_frame_id=subj_id,
            )
            if astats is not None:
                st8 = astats[i]
                bm.align_length = int(st8[0])
                bm.num_matches = int(st8[1])
                bm.num_mismatches = int(st8[2])
                bm.num_positives = int(st8[3])
                bm.num_gap_opens = int(st8[4])
                bm.num_gaps = int(st8[5])
                bm.num_insertions = int(st8[6])
                bm.num_deletions = int(st8[7])
                bm.identity = (100.0 * bm.num_matches / bm.align_length
                               if bm.align_length else 0.0)
                bm.similarity = (100.0 * bm.num_positives / bm.align_length
                                 if bm.align_length else 0.0)
            else:
                use_rev = self.bs_mode and subj_id % 2 == 1
                sch = self.align_rev if use_rev else self.align_fwd
                with stats.timed("time_extend_trace"):
                    records.compute_alignment_stats(
                        bm, trans[qry_id],
                        self.s_windows.concat[
                            idx.trans_offsets[subj_id]:
                            idx.trans_offsets[subj_id + 1]],
                        sch.matrix, self.bs_mode)

            # %identity filter (search_algo.hpp:1310-1315)
            if bm.identity < opt.id_cutoff:
                stats.hits_failed_percent_ident += 1
                continue

            bm.bit_score = self.evaluer.bit_score(bm.raw_score)
            bm.e_value = self.evaluer.e_value(bm.raw_score, bm.q_length)
            if opt.has_s_tax_ids and idx.s_tax_ids:
                bm.s_tax_ids = idx.s_tax_ids[n_s]
            out.setdefault(n_q, []).append(bm)
        return out


# --trace-dir's per-process call number: a resident process's calls
# write traces of their own
_TRACE_CALLS = itertools.count()

# seconds a --distributed rendezvous may take (jax.distributed.initialize's
# default initialization timeout)
DIST_TIMEOUT_S = 300


def run_search(opt: opt_mod.LambdaOptions, device="cuda",
               devices=None) -> StatsHolder:
    """The search of ``opt`` on ``device`` (``devices``: the mesh's cells,
    see SearchContext).  ``opt.distributed`` = "ADDR,PID,N" first joins
    this process to a torch.distributed group (gloo, rendezvous at
    tcp://ADDR) as rank PID of N -- the counterpart of the JAX package's
    jax.distributed.initialize; hosts share no runtime state, so the
    search itself uses no collective (each host searches its
    --shard-subset and tools/merge_m8.py merges the outputs).  A
    rendezvous that does not complete within DIST_TIMEOUT_S raises
    (RuntimeError).  The group is destroyed when the search ends."""
    dist = getattr(opt, "distributed", "")
    if not dist:
        return _run_search(opt, device, devices)
    import datetime

    import torch.distributed as tdist

    addr, pid, n = dist.rsplit(",", 2)
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", rank=int(pid),
        world_size=int(n),
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        return _run_search(opt, device, devices)
    finally:
        tdist.destroy_process_group()


def _run_search(opt: opt_mod.LambdaOptions, device, devices) -> StatsHolder:
    from .. import misc

    if not os.path.exists(opt.query_file):
        raise misc.QueryException(
            f"could not open the query file at '{opt.query_file}'.")

    if opt.verbosity >= 2:
        misc.print_search_options(opt)
    misc.check_ram(opt.index_file, opt.query_file, opt.lazy_qry_file,
                   opt.verbosity)

    stats = StatsHolder()
    misc.my_print(opt.verbosity, 1, "Loading Database Index... ", end="")
    t0 = time.time()
    with stats.timed("time_load"):
        ctx = SearchContext(opt, device, devices)
    idx = ctx.idx
    misc.my_print(opt.verbosity, 1, "done.")
    misc.my_print(opt.verbosity, 2,
                  f"    # original subjects:   {idx.num_subjects}\n"
                  f"    # translated subjects: {len(idx.trans_frames)}\n"
                  f"    size of search space:  {idx.db_total_length}\n"
                  f"    has taxonomic IDs:     {int(idx.has_s_tax_ids)}\n"
                  f"    has taxonomic tree:    {int(idx.has_tax_tree)}\n"
                  f"Runtime: {time.time() - t0:.2f}s\n")

    # query loading: eager reads everything up front (loadQuery,
    # search_algo.hpp:332-361); lazy streams and only counts first
    if opt.lazy_qry_file:
        misc.my_print(opt.verbosity, 1, "Counting Query Sequences... ", end="")
        with stats.timed("time_read"):
            query_total = fasta.count_seqs(opt.query_file)
        from ..io.async_buffer import async_input_buffer
        query_stream = async_input_buffer(
            fasta.iter_seqs(opt.query_file),
            capacity=opt.query_batch_size * 4)
    else:
        misc.my_print(opt.verbosity, 1, "Loading Query Sequences... ", end="")
        with stats.timed("time_read"):
            _all_queries = fasta.read_fasta(opt.query_file)
        query_total = len(_all_queries)
        query_stream = iter(_all_queries)
    misc.my_print(opt.verbosity, 1, "done.")

    if opt.has_s_tax_ids and not idx.has_s_tax_ids:
        raise RuntimeError(
            "You requested printing of taxonomic IDs and/or taxonomic binning, "
            "but the index does not contain taxonomic information.")
    if opt.compute_lca and not idx.has_tax_tree:
        raise RuntimeError(
            "You requested taxonomic binning, but the index does not contain "
            "a taxonomic tree.")

    program_upper = ctx.program.value.upper()
    version_string = f"{program_upper} 2.2.26+"
    if opt.version_to_output_file:
        version_string += (f" [created by LAMBDA-TPU-TORCH-{__version__}, "
                           "see https://github.com/seqan/lambda for the "
                           "original]")
    if opt.out_file_format == 0:
        writer = blast_tab.BlastTabWriter(
            opt.output, opt.columns, opt.blast_tabular_with_comments,
            version_string, opt.index_file)
    elif opt.out_file_format == -1:
        matrix_name = (f"BLOSUM{opt.scoring_method}"
                       if idx.trans_alph == ab.AMINO_ACID
                       else f"blastn matrix {opt.match} {opt.mismatch}")
        writer = blast_report.BlastReportWriter(
            opt.output, program_upper, version_string, opt.index_file,
            db_num_seqs=len(idx.trans_frames),
            db_total_length=idx.db_total_length,
            matrix_name=matrix_name,
            gap_open=opt.gap_open, gap_extend=opt.gap_extend)
    elif opt.out_file_format in (1, 2):
        writer = sam_bam.SamBamWriter(
            opt.output, bam=opt.out_file_format == 2, opt=opt, ctx=ctx)
    else:
        raise NotImplementedError(f"output format {opt.out_file_format}")
    writer.write_header()

    def write_query_records(q_global_id: str, q_seq: np.ndarray,
                            matches: list):
        # gate + qrysWithHit on PRE-cutoff matches, like the reference
        # (_writeRecord, search_algo.hpp:824-826)
        if not matches:
            return
        with stats.timed("time_write"):
            matches = records.sort_dedup_cutoff(matches, opt.max_matches,
                                                stats)
            stats.qrys_with_hit += 1
            stats.pairs += len({m.n_s_id for m in matches})
            lca_tax, lca_name = 0, ""
            if opt.compute_lca:
                lca_tax, lca_name = records.record_lca(
                    matches, idx.s_tax_ids, idx.taxon_parents,
                    idx.taxon_heights, idx.taxon_names)
            if opt.out_file_format == 0:
                fields = [blast_tab.fields_for_match(
                    bm, q_global_id, idx.ids[bm.n_s_id], ctx.program,
                    lca_id=lca_name, lca_tax_id=lca_tax) for bm in matches]
                if getattr(opt, "merge_annotations", False):
                    # internal multi-host column: subject db position +
                    # frame-space coordinates + raw score let merge_m8
                    # reproduce the exact single-host total order
                    for f, bm in zip(fields, matches):
                        f["_merge_annot"] = (
                            f"X:{bm.n_s_id}:{bm.q_start}:{bm.q_end}:"
                            f"{bm.s_start}:{bm.s_end}:{bm.q_frame_shift}:"
                            f"{bm.s_frame_shift}:{bm.raw_score}")
                writer.write_record(q_global_id, fields)
            elif opt.out_file_format == -1:
                rows = [ctx.alignment_rows(bm, q_seq) for bm in matches]
                writer.write_record(
                    q_global_id, len(q_seq), matches, idx.ids,
                    blast_tab.format_evalue, blast_tab.format_bitscore, rows)
            else:
                writer.write_record(q_global_id, q_seq, matches,
                                    lca_tax=lca_tax, lca_name=lca_name)

    # --trace-dir: a torch.profiler trace of the search loop (host and,
    # on the card, device activity), exported into the directory as a
    # chrome trace when the loop ends
    profile_dir = getattr(opt, "profile_dir", "")
    profiler = None
    if profile_dir:
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if ctx.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.__enter__()
            misc.my_print(opt.verbosity, 1, f"Profiling to {profile_dir}")
        except Exception as e:
            print(f"WARNING: profiler unavailable: {e}")
            profiler = None

    misc.my_print(opt.verbosity, 1,
                  "Searching and extending hits on-line...progress:")
    progress = misc.ProgressBar(opt.verbosity >= 1)
    done = 0

    def batches():
        # the read and encode of a batch is the span time_read; it is
        # closed before the yield, which hands the batch to the search
        size = max(opt.query_batch_size, 1)
        while True:
            with stats.timed("time_read"):
                recs = list(itertools.islice(query_stream, size))
                ids = [rec.id for rec in recs]
                seqs = [ab.encode(rec.seq, ctx.qry_orig_alph) for rec in recs]
            if not recs:
                return
            yield ids, seqs

    # the first-pass options (phase 1 cheap seeds if iterative)
    so_first = opt.search_opts0 if opt.iterative_search \
        else opt.search_opts

    def finish_batch(batch_ids, batch_seqs, sd):
        res1 = ctx.collect_batch(sd, stats)
        if opt.iterative_search:
            # phase-2 the phase-1 losers, then write EVERYTHING in query
            # order (output bytes must not depend on the batch size)
            successful = set(q for q, ms in res1.items() if ms)
            remaining = [q for q in range(len(batch_seqs))
                         if q not in successful]
            if remaining:
                with stats.timed("time_phase2"):
                    res2 = ctx.process_batch(
                        [batch_seqs[q] for q in remaining], opt.search_opts,
                        stats)
                for qi, ms in res2.items():
                    res1[remaining[qi]] = ms
        for q, ms in sorted(res1.items()):
            write_query_records(batch_ids[q], batch_seqs[q], ms)
        nonlocal done
        done += len(batch_ids)
        progress.update(done, query_total)

    # one-deep seeding prefetch: batch k+1's (phase-1) seeding is launched
    # BEFORE batch k's hits are pulled, so the device seeds k+1 while the
    # host runs k's tail.  Each batch's computation is unchanged and
    # outputs are written in order, so the bytes are the same.  Under a
    # profiler, a batch's dispatch and its finish are spans "batch <k>".
    pending = None
    try:
        for k, (batch_ids, batch_seqs) in enumerate(batches()):
            with span(f"batch {k}"):
                sd = ctx.dispatch_seeding(batch_seqs, so_first, stats)
            if pending is not None:
                with span(f"batch {k - 1}"):
                    finish_batch(*pending)
            pending = (batch_ids, batch_seqs, sd)
        if pending is not None:
            with span(f"batch {k}"):
                finish_batch(*pending)
    finally:
        # the trace is written even when a batch raises (the profile
        # would otherwise be lost); the footer only on success -- a
        # truncated output must not look complete
        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(
                profile_dir, f"lambda_search.{os.getpid()}."
                f"{next(_TRACE_CALLS)}.pt.trace.json"))
    progress.finish()
    writer.write_footer()
    stats.read_device_counters()
    cards = ctx.mesh_cards()
    if cards:
        stats.card_mem_peak_bytes = max(
            torch.cuda.max_memory_allocated(d) for d in cards)
    return stats
