"""Runtime of the port: serving (prefill/decode steps, HeMT batching) and
HeMT-DP training (train/grain/apply steps, ``HeMTTrainer``)."""
