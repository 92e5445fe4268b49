"""The benchmark of the PyTorch/CUDA port, `voxtral_tpu_torch`, on NVIDIA
H100s: `python3 -m h100_bench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` (run.py).  It imports neither JAX nor the JAX package."""
