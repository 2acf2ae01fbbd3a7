"""The benchmark of the PyTorch and CUDA port (``infinistore_tpu_torch``) on
one NVIDIA H100: multi-turn chat sessions through the port's engine and its
KV store. ``python3 -m h100bench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the root of
the repository names the cells, configurations, traffic mixes and metrics,
each a file of its own under this directory. It imports nothing of the JAX
package."""
