"""The port imports neither JAX nor the JAX package, and its copies of the
JAX package's host modules are held against their originals."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lambda_tpu_torch\n"
        "for m in pkgutil.walk_packages(lambda_tpu_torch.__path__,\n"
        "                               'lambda_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'lambda_tpu' or n.startswith('lambda_tpu.'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('lambda_tpu_torch.')]))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


# modules copied from lambda_tpu with one change: citations of the
# upstream seqan/lambda sources name them by their repository path
VERBATIM = ["alphabets", "frames", "options", "scoring", "statistics",
            "io/__init__", "io/fasta", "io/async_buffer",
            "index/taxonomy", "search/records",
            "output/blast_tab", "output/blast_report",
            "tools/__init__", "tools/merge_m8"]


UPSTREAM = (b"/" + b"root/reference/src/", b"lambda/src/")


def _as_copied(path: Path) -> bytes:
    return path.read_bytes().replace(*UPSTREAM)


@pytest.mark.parametrize("name", VERBATIM)
def test_verbatim_copies_equal_their_originals(name):
    assert (REPO / "lambda_tpu_torch" / f"{name}.py").read_bytes() == \
        _as_copied(REPO / "lambda_tpu" / f"{name}.py")


def test_sam_bam_copy_differs_only_in_its_bgzf_flush():
    """output/sam_bam.py is the JAX package's module, but for the
    docstring, the zlib import and the body of ``_bgzf_flush_block``
    (the port's BGZF encoder never returns None, so the zlib branch
    went)."""
    import ast

    def parts(path):
        tree = ast.parse(path.read_text())
        out = []
        for node in tree.body[1:]:                   # after the docstring
            if isinstance(node, ast.Import):
                node.names = [a for a in node.names if a.name != "zlib"]
                if not node.names:
                    continue
            if isinstance(node, ast.ClassDef):
                node.body = [n for n in node.body if getattr(
                    n, "name", "") != "_bgzf_flush_block"]
            out.append(ast.dump(node))
        return out

    port = REPO / "lambda_tpu_torch" / "output" / "sam_bam.py"
    assert parts(port) == parts(REPO / "lambda_tpu" / "output" / "sam_bam.py")
    assert "import zlib" not in port.read_text()


def test_stats_copy_differs_only_in_its_spans():
    """stats.py's StatsHolder is the JAX package's with the port's spans
    and counters after its fields: the JAX fields come first, in order,
    with the same defaults, and ``__iadd__`` gives the same results on
    them."""
    import dataclasses

    from lambda_tpu.stats import StatsHolder as JStats
    from lambda_tpu_torch.stats import StatsHolder as TStats

    jf = [(f.name, f.default) for f in dataclasses.fields(JStats)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TStats)]
    assert len(tf) > len(jf) and tf[:len(jf)] == jf
    rng = np.random.default_rng(5)
    values = [{n: type(d)(rng.integers(0, 1000)) for n, d in jf}
              for _ in range(2)]
    j, t = JStats(**values[0]), TStats(**values[0])
    j += JStats(**values[1])
    t += TStats(**values[1])
    assert {n: getattr(t, n) for n, _ in jf} == dataclasses.asdict(j)


def test_bgzf_block_matches_jax_package():
    """The port's BGZF binding writes the JAX package's block: one gzip
    member with the BC extra field holding the block size."""
    import gzip

    from lambda_tpu import native as jn
    from lambda_tpu_torch import native as tn

    rng = np.random.default_rng(4)
    for n in (1, 1000, 0xFF00):
        data = bytes(rng.integers(0, 8, n).astype(np.uint8))
        blk = tn.bgzf_compress_block(data)
        assert blk == jn.bgzf_compress_block(data)
        assert gzip.decompress(blk) == data
        assert blk[12:14] == b"BC" and \
            int.from_bytes(blk[16:18], "little") == len(blk) - 1
    with pytest.raises(RuntimeError):
        tn.bgzf_compress_block(bytes(70000))


def test_native_copy_equals_original_source():
    assert (REPO / "lambda_tpu_torch" / "csrc" / "host"
            / "lambda_native.cpp").read_bytes() == \
        _as_copied(REPO / "native" / "lambda_native.cpp")


def test_native_helpers_match_jax_package():
    """The port's native loader (required, own build directory) gives the
    same results as the JAX package's on the helpers the port calls."""
    from lambda_tpu import native as jn
    from lambda_tpu_torch import native as tn

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 32, (500, 4), dtype=np.uint64) \
        .astype(np.uint32)
    keys[300:] = keys[:200]          # duplicate rows: the sort is stable
    order = tn.sort_rows_u32(keys)
    np.testing.assert_array_equal(order, jn.sort_rows_u32(keys))
    np.testing.assert_array_equal(tn.take_rows_u32(keys, order),
                                  jn.take_rows_u32(keys, order))
    offsets = np.array([0, 100, 350, 500], np.int64)
    np.testing.assert_array_equal(tn.take_frame_of_pos(offsets, order),
                                  jn.take_frame_of_pos(offsets, order))
    concat = rng.integers(0, 10, 500).astype(np.uint8)
    np.testing.assert_array_equal(
        tn.pack_position_keys(concat, offsets, 4, 4),
        jn.pack_position_keys(concat, offsets, 4, 4))
    data = bytes(rng.integers(0, 4, 5000).astype(np.uint8))
    assert tn.gzip_compress(data) == jn.gzip_compress(data)
    assert tn.BUILD_DIR == REPO / "build" / "lambda_tpu_torch"


def test_misc_gz_writer_matches_jax_package(tmp_path):
    import gzip

    from lambda_tpu import misc as jm
    from lambda_tpu_torch import misc as tm

    text = "".join(f"q{i}\ts{i}\t{i * 0.5:.2f}\n" for i in range(3000))
    for mod, name in ((jm, "jax.m8.gz"), (tm, "port.m8.gz")):
        with mod.open_output(tmp_path / name) as fh:
            fh.write(text)
    assert (tmp_path / "port.m8.gz").read_bytes() == \
        (tmp_path / "jax.m8.gz").read_bytes()
    assert gzip.decompress((tmp_path / "port.m8.gz").read_bytes()).decode() \
        == text


@pytest.mark.parametrize("module,counters", [
    ("lambda_tpu_torch.ops.sw_band",
     ("launches", "launches_dirs", "launches_sub")),
    ("lambda_tpu_torch.ops.sw_rect", ("launches",)),
    ("lambda_tpu_torch.search.extend", ()),
    ("lambda_tpu_torch.parallel.mesh", ()),
    ("lambda_tpu_torch.search.pipeline", ()),
])
def test_kernel_modules_import_alone_without_jax(module, counters):
    """Each kernel module (K1-K4), the extension module, the device mesh
    and the pipeline import on their own with no JAX and nothing of
    lambda_tpu, and the kernel modules hold an integer launch counter per
    kernel."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        f"for c in {counters!r}:\n"
        "    assert isinstance(getattr(m, c), int), c\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'lambda_tpu' or n.startswith('lambda_tpu.'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("D", [0, 7, 23, 39, 127, 255, 1023, 2047])
def test_lane_plan_copy_matches_jax_package(monkeypatch, D):
    """ops/sw_band.py keeps its own copy of the lane plan's geometry and
    column chunk (the X-drop checkpoints) and of the LAMBDA_SWB_BT and
    LAMBDA_SW_XDROP latches; they equal the JAX package's."""
    from lambda_tpu.ops import sw_band as jsw
    from lambda_tpu_torch.ops import sw_band as tsw

    assert (tsw._BT_CAP, tsw._XDROP) == (jsw._BT_CAP, jsw._XDROP)
    assert tsw._lane_geometry(D) == jsw._lane_geometry(D)
    for Ns in (D + 1, D + 16, D + 151, D + 8192):
        assert tsw.plan_nc(Ns, D) == jsw._plan(Ns, D, layout="lane")[3]


def test_band_core_header_is_shared_and_hashed(monkeypatch, tmp_path):
    """K1 and K2 compile the one band core, csrc/band_warp.cuh, and a
    change to it changes both libraries' build key."""
    from lambda_tpu_torch.ops import _build

    csrc = REPO / "lambda_tpu_torch" / "csrc"
    for name in ("sw_band", "sw_band_dirs"):
        assert '#include "band_warp.cuh"' in (csrc / f"{name}.cu").read_text()
    core = (csrc / "band_warp.cuh").read_text()
    for dpx in ("__viaddmax_s32(", "__viaddmax_s32_relu(", "__vimax3_s32("):
        assert dpx in core
    assert core.count("__syncthreads()") == 1      # the prologue only
    for f in csrc.glob("*"):
        if f.is_file():
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = {n: _build.build_key(n) for n in ("sw_band", "sw_band_dirs")}
    (tmp_path / "band_warp.cuh").write_text(core + "\n// changed\n")
    after = {n: _build.build_key(n) for n in ("sw_band", "sw_band_dirs")}
    assert all(before[n] != after[n] for n in before)
