"""The SAM and BAM writers of the port against the JAX package's CLI, on
the fixtures of tests/test_torch_output.py: byte-equal SAM (with the
reference header and every tag, and with hard and soft clips under every
``--sam-bam-seq`` choice) and byte-equal BAM."""

import pytest

from tests.test_torch_output import (  # noqa: F401  (out_cases: fixture)
    FIXTURES, _both, _port_names, _tags, out_cases)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_sam_matches_jax(out_cases, name):
    want, got = _both(out_cases, name, "out.sam", "--sam-with-refheader",
                      "--sam-bam-tags", _tags(name), "-n", "8")
    assert b"\n@PG\t" in want
    assert _port_names(got) == want


@pytest.mark.parametrize("clip", ["hard", "soft"])
@pytest.mark.parametrize("seq", ["always", "uniq", "never"])
@pytest.mark.parametrize("name", ["blastx_tax", "blastn_random",
                                  "bs_random"])
def test_sam_clip_and_seq_match_jax(out_cases, name, seq, clip):
    want, got = _both(out_cases, name, "out.sam", "--sam-bam-clip", clip,
                      "--sam-bam-seq", seq, "--sam-bam-tags", _tags(name),
                      "--version-to-outputfile", "0", "-n", "8")
    assert got == want


@pytest.mark.parametrize("name", list(FIXTURES))
def test_bam_matches_jax(out_cases, name):
    """BAM byte for byte: both packages compress each BGZF block with
    the same C++ source."""
    want, got = _both(out_cases, name, "out.bam", "--sam-bam-tags",
                      _tags(name), "--sam-bam-seq", "always",
                      "--sam-bam-clip", "soft",
                      "--version-to-outputfile", "0", "-n", "8")
    assert got == want
