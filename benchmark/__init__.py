"""Benchmark of the PyTorch + CUDA receiver (`sdr_tpu_torch`).

Entry point: `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`; the cells are in BENCHMARK.json at the root
of the repository.  Nothing here imports jax or the JAX package.
"""
