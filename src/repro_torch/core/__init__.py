"""AFTO core: mu-cuts and the federated trilevel loop (Alg. 1)."""
from repro_torch.core.types import (AFTOState, FlatCuts, FlatSpec, Hyper,
                                    InnerState2, InnerState3, StaleView,
                                    TrilevelProblem)
from repro_torch.core.afto import (afto_step, afto_step_aux,
                                   afto_step_from_grads, cut_refresh,
                                   init_state, local_f1_grads)
from repro_torch.core.engine import (RunResult, SweepResult, record_slots,
                                     run_chunked, run_scanned, run_swept)
from repro_torch.core.runner import RunSpec, run
from repro_torch.core.scheduler import (Schedule, StragglerConfig,
                                        StragglerScheduler)
from repro_torch.core.stationarity import stationarity_gap_sq
from repro_torch.core.weakly_convex import (curvature_along, estimate_mu,
                                            first_order_gap)
