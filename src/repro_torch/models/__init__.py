"""Networks of the paper's experiments."""
