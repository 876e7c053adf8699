"""The benchmark of superman_tpu_torch, the port on one NVIDIA H100.

    python3 -m permbench --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

See harness.py for a run, BENCHMARK.json for the cells and PERF.md for
why each exists.  Nothing here imports jax or the JAX package.
"""
