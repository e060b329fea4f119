"""Native (C) host tier: compiled hashing and row-assembly functions for
the host feature pipeline, loaded with ctypes, with NumPy/Python paths
where no C compiler is found (port of goctr_tpu/native/). Host code only:
the card's kernels live in csrc/."""
from goctr_tpu_torch.native.build import get_lib, native_available
from goctr_tpu_torch.native.hashing import (
    fnv1_32_batch, fnv1a_32_batch, hash_bucket_batch, multihot_batch,
    gather_rows_concat,
)
