"""Datasets with the paper's shapes, data streams and the batch loader."""
from repro_torch.data.loader import ShardedLoader, shard_batch
from repro_torch.data.stream import (Stream, StreamSpec, batch_at,
                                     make_stream, next_batch, normal_like,
                                     problem_stream, worker_key, zipf_tokens)
