"""goctr_tpu_torch — the PyTorch/CUDA port of goctr_tpu for one NVIDIA H100.

The JAX package `goctr_tpu` stays the reference; this package grows beside
it slice by slice and never imports it (nor JAX). Every Pallas kernel of
the reference becomes a kernel written by hand for Hopper (CUDA C++ under
`csrc/`, built for sm_90a at first use); plain tensor code is PyTorch.

Layer map (mirrors goctr_tpu; only the ported slices exist):
  core/      — device resolution, the (data, model) mesh over
               torch.distributed ranks (NCCL or gloo) and its launcher,
               config, metrics, named generators (prng), profiling
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
               and checkpoints; mesh_cases (rank programs that hold a
               (d, m) run to the 1×1 run)
  serve/     — device-resident scorer, micro-batcher, HTTP API
  data/      — schema scanners, the MovieLens and ML-20M-statistics
               fixtures, MovielensRec, sample files
  features/  — hashing, encoders, scalers, normalizers, text, the
               user-behavior cache, sklearn-style preprocessing (host)
  recommend/ — Train / BatchPredict / Rank over a feature provider
  native/, utils/ — the host C tier (FNV, row gathers), helpers
  examples/  — futuresales, scaling (python -m goctr_tpu_torch.examples.*)
  dryrun.py  — entry() and dryrun_multichip(n) (__graft_entry__.py's)
  convert.py — carries JAX-side parameters (as numpy) into the port

Entry points take `device=` and default to "cuda"; without a card they
raise. Pass device="cpu" to run the plain versions on the CPU.
"""

__version__ = "0.1.0"
