from goctr_tpu_torch.features.hashing import (
    fnv32, fnv32a, hash_bucket, hash_onehot, simple_onehot,
    string_split_multihot, hash_bucket_batch,
)
from goctr_tpu_torch.features.ubcache import TimeSeq, UserBehaviorCache
