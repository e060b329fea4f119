from goctr_tpu_torch.parallel.embedding import (
    EmbeddingSpec, init_table, sharded_lookup, sharded_pooled_lookup,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR, SparseBatch
from goctr_tpu_torch.parallel.train import make_sharded_train_step
from goctr_tpu_torch.parallel.scanned import (
    TableOptConfig, TrainedScanned, train_sparse_scanned,
)
