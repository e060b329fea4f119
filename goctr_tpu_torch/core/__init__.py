from goctr_tpu_torch.core.meshes import MeshSpec, make_mesh
from goctr_tpu_torch.core.prng import PRNGPool
