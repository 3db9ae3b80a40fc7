"""The check's control and faults, on a tiny run of the harness on the
CPU (the look for a card skipped, the rest of a run driven): sound runs
come out correct; the control run (the reference in 8-bit arithmetic in
the program's place), and the program broken underneath the timed path,
do not.  The cells' one-card runs have no exchange between chips to
leave out."""

import contextlib
import types

import numpy as np
import pytest
import torch

from benchmark.harness import cell

CELLS = ["blastx_sprot_half.reads150", "blastp_sprot_half.proteome",
         "blastp_sprot_half.interactive", "blastp_sprot_half.dark"]


def run(spec, name, seed=2 ** 40 + 3, control=False):
    return cell.run(spec, name, seed, 0.2, False, device="cpu",
                    control=control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct_and_the_control_is_not(tiny_spec, name):
    r = run(tiny_spec, name)
    assert r["correct"], r["checks"]
    assert r["detail"]["sampled"] > 0
    # the tiny dark pool holds two planted proteins, none a sentinel
    assert r["detail"]["sentinels"] > 0 or name.endswith("dark")
    c = run(tiny_spec, name, control=True)
    assert not c["correct"], c["checks"]
    # the same sample: the program's own readings beside the control's
    assert c["detail"]["program"] == {
        k: r["checks"][k]["value"] for k in c["detail"]["program"]}


@contextlib.contextmanager
def patched(obj, attr, make):
    old = getattr(obj, attr)
    setattr(obj, attr, make(old))
    try:
        yield
    finally:
        setattr(obj, attr, old)


def altered_scores(old):
    """Pass 2 reports each score 3 above what it computed."""
    def f(*a, **kw):
        scores, traces, stats = old(*a, **kw)
        return np.asarray(scores) + 3, traces, stats
    return f


def a_fifth_altered(old):
    """Pass 2 reports the score of every fifth alignment it traced 3
    above what it computed: a fault of a minority of the records, as of
    one shape class of the kernels or one slot."""
    def f(*a, **kw):
        scores, traces, stats = old(*a, **kw)
        scores = np.array(scores, copy=True)
        scores[::5] += 3
        return scores, traces, stats
    return f


def half_the_batch(old):
    """The search's view of the FASTA reader: every other query of a file
    left out."""
    def read_fasta(path, *a, **kw):
        return old.read_fasta(path, *a, **kw)[::2]
    return types.SimpleNamespace(**{**vars(old), "read_fasta": read_fasta})


def unchanged(old):
    """The batch step returns without a hit, its state as it came."""
    def f(self, *a, **kw):
        return {}
    return f


@pytest.mark.parametrize("name", ["blastx_sprot_half.reads150",
                                  "blastp_sprot_half.proteome"])
@pytest.mark.parametrize("fault", ["altered", "fifth", "half",
                                   "unchanged"])
def test_a_broken_timed_path_is_not_correct(tiny_spec, name, fault):
    from lambda_tpu_torch.search import extend, pipeline

    with contextlib.ExitStack() as stack:
        if fault == "altered":
            stack.enter_context(patched(extend, "trace_pass",
                                        altered_scores))
        elif fault == "fifth":
            stack.enter_context(patched(extend, "trace_pass",
                                        a_fifth_altered))
        elif fault == "half":
            stack.enter_context(patched(pipeline, "fasta", half_the_batch))
        else:
            stack.enter_context(patched(pipeline.SearchContext,
                                        "collect_batch", unchanged))
            stack.enter_context(patched(pipeline.SearchContext,
                                        "process_batch", unchanged))
        r = run(tiny_spec, name)
    assert not r["correct"], r["checks"]
    if fault == "fifth":
        # caught by the score's limit itself, nothing else reads it
        score = r["checks"]["score_off_pct"]
        assert score["value"] > score["limit"], r["checks"]
    if fault == "half":
        # the left-out queries' sentinels are missed: about half of them
        miss = r["checks"]["sentinels_missed_pct"]
        assert miss["value"] > 10 * miss["limit"], r["checks"]


@pytest.mark.cuda
def test_a_tiny_run_on_the_card(tiny_spec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = cell.run(tiny_spec, "blastp_sprot_half.proteome", 5, 0.5, True,
                 device="cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert r["metrics"]["launches_per_kq"]["value"] > 0
