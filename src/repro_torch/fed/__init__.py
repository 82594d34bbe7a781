"""Federation: the LLM trilevel step (`fed.trilevel_llm`), the count
sketch of its cuts (`fed.sketch`), the worker-mesh layout
(`fed.sharding`) and the asynchronous master/worker runtime
(`fed.runtime`).  The LLM half of the reference's `fed/sharding.py`
(`param_specs`, `batch_spec`, `cache_specs`, `data_axis`, `to_named`)
is not ported yet (ROADMAP.md Queue 1, item 9)."""
from repro_torch.fed.sketch import sketch, sketch_dot, unsketch
from repro_torch.fed.trilevel_llm import (FedHyper, FedLLMState, LLMCutSet,
                                          afto_llm_step, cut_refresh_llm,
                                          init_fed_state, plain_train_step)
