"""Training and LM serving steps (port of `repro.train`: AdamW, the train
step with microbatch accumulation, prefill/decode/greedy generation)."""
