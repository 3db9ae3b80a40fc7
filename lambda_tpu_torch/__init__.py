"""lambda_tpu_torch: the PyTorch/CUDA port of lambda-tpu for NVIDIA Hopper.

The same BLAST-compatible local aligner as the JAX package ``lambda_tpu``
(which stays the reference), running on one CUDA device: the sorted k-mer
index and the query batches live in device memory, seeding is torch
tensor code, the pass-1 banded Smith-Waterman scores come from a CUDA
kernel written for ``sm_90a`` (ops/sw_band.py, csrc/sw_band.cu), and the
pass-2 traceback runs in the host C++ helpers (native.py).  The package
imports nothing of ``lambda_tpu`` and no JAX: the host modules it shares
in function are its own copies.

Ported so far: the six subcommands (cli.py: mkindexp/mkindexn/mkindexbs,
searchp/searchn/searchbs), so BLASTP, BLASTX, TBLASTN, TBLASTX, BLASTN and
bisulfite search with m8/m9/m0/SAM/BAM output, on one device.  Entry
points run on the card unless the caller passes ``device="cpu"``; on the
CPU every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"

PROGRAM_NAME = "lambda-tpu-torch"
