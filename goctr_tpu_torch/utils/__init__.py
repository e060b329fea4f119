from goctr_tpu_torch.utils.util import (
    concat_slices, top_n_occurrences, parse_int64_seq, accuracy, roc_auc,
)
