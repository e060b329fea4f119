"""goctr_tpu_torch — the PyTorch/CUDA port of goctr_tpu for one NVIDIA H100.

The JAX package `goctr_tpu` stays the reference; this package grows beside
it slice by slice and never imports it (nor JAX). Every Pallas kernel of
the reference becomes a kernel written by hand for Hopper (CUDA C++ under
`csrc/`, built for sm_90a at first use); plain tensor code is PyTorch.

Layer map (mirrors goctr_tpu; only the ported slices exist):
  core/      — dtype policy, device resolution, the (data, model) mesh
               (1×1 so far)
  ops/       — activations + the hand kernels (`ops/kernels/`) with their
               plain PyTorch versions and the packed-table layouts
  models/    — shared init helpers, parameter (de)flattening, sparse
               checkpoints, the dense rankers and their trainer, the
               sklearn-style MLPClassifier / MLPRegressor and Neural
  optim/     — the minibatch solvers and the full-batch lbfgs, bfgs, cg
  embedding/ — item2vec: dictionary, Huffman paths, word2vec on the card,
               the embedding map's text files, search and its console
  parallel/  — SparseCTR (DIN or mean pool + tower), its lookups, the
               scanned trainer and the mesh trainer with their results
               and checkpoints
  serve/     — device-resident scorer, micro-batcher, HTTP API
  convert.py — carries JAX-side parameters (as numpy) into the port

Entry points take `device=` and default to "cuda"; without a card they
raise. Pass device="cpu" to run the plain versions on the CPU.
"""

__version__ = "0.1.0"
