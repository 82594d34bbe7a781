"""Federation: the LLM trilevel step (`fed.trilevel_llm`), the count
sketch of its cuts (`fed.sketch`), the worker-mesh layout
(`fed.sharding`), the LLM step and refresh on a worker mesh
(`fed.trilevel_llm_sharded`) and the asynchronous master/worker runtime
(`fed.runtime`).  The reference's `fed/sharding.py to_named` (placing
tensors by the LLM specs on a device mesh) is not ported: a worker
mesh of the port is a group of processes."""
from repro_torch.fed.sketch import sketch, sketch_dot, unsketch
from repro_torch.fed.trilevel_llm import (FedHyper, FedLLMState, LLMCutSet,
                                          afto_llm_step, cut_refresh_llm,
                                          init_fed_state, plain_train_step)
