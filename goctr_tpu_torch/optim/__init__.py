from goctr_tpu_torch.optim.optimizers import (FULLBATCH_SOLVERS, SOLVERS,
                                              fullbatch_minimize, make_solver)
from goctr_tpu_torch.optim.schedules import make_schedule
