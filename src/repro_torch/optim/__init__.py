from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, chain,
                                          clip_by_global_norm, momentum, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)
