"""Networks of the paper's experiments (`simple`) and the LLM serving
path (`config`, `layers`, `attention`, `xlstm`, `transformer`)."""
