"""One torch intra-op thread per test process.

The suite runs under pytest-xdist with six workers, and each worker's
torch would start one intra-op thread per core: on an 8-core host that
is 48 threads on 8 cores.  The port's CPU tests run the plain versions
of its kernels as many small torch ops, which slow down badly when
their threads fight over the cores.  On an 8-core host with six
workers, six port test files (test_torch_mesh_cards, test_torch_mesh,
test_torch_e2e, test_torch_stream, test_torch_modes, test_torch_golden;
87 tests) took 313.8 s with torch's default thread count and 100.8 s
with one thread per process; test_torch_mesh_cards.py's prebuilt-shards
case alone went from 276.9 s to 31.4 s.

pytest imports every test module while it collects, and every xdist
worker collects the whole suite before it runs a test, so setting the
count here holds in every worker (and without xdist) for every test.
The native helpers' OpenMP regions share torch's OpenMP runtime, so
they run on one thread too.  Results do not depend on the thread count:
the tests hold the port byte-equal to the JAX package either way, and
the CLI subprocesses of the golden tests set their own OMP_NUM_THREADS.
"""

import torch

torch.set_num_threads(1)


def test_each_test_process_runs_one_torch_thread():
    assert torch.get_num_threads() == 1
