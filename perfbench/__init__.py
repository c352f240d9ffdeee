"""The benchmark of ``whisperseg_torch`` on one NVIDIA H100: one command
(``perfbench/run.py``), driven by BENCHMARK.json and the data files of this
folder. It imports neither JAX nor the JAX package."""
