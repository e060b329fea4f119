from goctr_tpu_torch.features.hashing import (
    fnv32, fnv32a, hash_bucket, hash_onehot, simple_onehot,
    string_split_multihot, hash_bucket_batch,
)
from goctr_tpu_torch.features.encoders import OneHotEncoder, OrdinalEncoder
from goctr_tpu_torch.features.scalers import (
    Identity, MinMaxScaler, MaxAbsScaler, StandardScaler, QuantileScaler,
)
from goctr_tpu_torch.features.discretization import KBinsDiscretizer
from goctr_tpu_torch.features.normalizers import (
    SampleNormalizerL1, SampleNormalizerL2, normalize_l1, normalize_l2,
)
from goctr_tpu_torch.features.text import CountVectorizer, TFIDFVectorizer
from goctr_tpu_torch.features.struct_transformer import StructTransformer
from goctr_tpu_torch.features.ubcache import TimeSeq, UserBehaviorCache
