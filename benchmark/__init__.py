"""The benchmark of the PyTorch/CUDA port (``tfidf_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on this machine's
GPU. The harness, the traffic, the per-layer readers, the frozen cost
model and the plain reference live here, apart from the program, which
supplies only the system under test and its spans, counters and kernel
names. Nothing here imports JAX or the JAX package (``tfidf_tpu``).
"""
