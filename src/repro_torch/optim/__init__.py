"""Inner optimizers and LR schedules (mirrors ``repro/optim``)."""
from repro_torch.optim.optimizers import Optimizer, adamw  # noqa: F401
