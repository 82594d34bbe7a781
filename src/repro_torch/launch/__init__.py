"""Entry points of the port: `serve` (LLM prefill + greedy decode)."""
