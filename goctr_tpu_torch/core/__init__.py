from goctr_tpu_torch.core.meshes import (
    MeshSpec, data_axis, make_mesh, model_axis)
from goctr_tpu_torch.core.prng import PRNGPool
