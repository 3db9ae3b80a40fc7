"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the program."""

import subprocess
import sys
import textwrap

from conftest import ROOT


def run_py(code: str) -> str:
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT / "benchmark"))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["lambda_tpu_torch_x"] = sys.modules["sys"]
        assert "lambda_tpu" not in run.forbidden_modules()
        sys.modules["lambda_tpu.ops"] = sys.modules["sys"]
        sys.modules["jaxlib"] = sys.modules["sys"]
        assert run.forbidden_modules() == ["jaxlib", "lambda_tpu"]
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_a_run_of_a_cell_loads_no_jax(tmp_path):
    out = run_py(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(ROOT / 'benchmark')!r})
        sys.path.insert(0, {str(ROOT / 'benchmark/tests')!r})
        from pathlib import Path
        from conftest import make_tiny
        from benchmark.harness import cell
        from benchmark.harness.spec import Spec
        import run
        p = make_tiny(Path({str(tmp_path)!r}))
        r = cell.run(Spec(p, bench_dir=p.parent),
                     "blastp_sprot_half.proteome", 3, 0.1, False, "cpu")
        assert "lambda_tpu_torch" in sys.modules
        print(r["correct"], run.forbidden_modules())
    """)
    assert out == "True []"


def test_the_reference_loads_nothing_of_the_program():
    out = run_py(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import benchmark.reference.judge, benchmark.reference.align
        import benchmark.reference.stats, benchmark.reference.tables
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"lambda_tpu_torch", "lambda_tpu", "jax"}}))
    """)
    assert out == "[]"
