from goctr_tpu_torch.ops.activations import (
    ACTIVATIONS, cosine_similarity, euclidean_distance, prelu,
)
from goctr_tpu_torch.ops.losses import (
    binary_cross_entropy, bce_with_logits, mse, rms,
)
