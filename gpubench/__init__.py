"""The benchmark of ``repurpose_tpu_torch`` on one NVIDIA H100 or four:
``python -m gpubench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` (``gpubench/run.py``). Nothing here imports JAX, Flax, Optax or the
JAX package ``repurpose_tpu``; ``gpubench/reference/`` imports nothing of
the port either."""
