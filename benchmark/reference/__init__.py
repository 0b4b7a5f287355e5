"""The plain reference the benchmark holds the receiver against: float64
PyTorch, no kernel and nothing of `sdr_tpu_torch`."""
