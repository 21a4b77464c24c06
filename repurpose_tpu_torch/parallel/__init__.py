"""Parallelism of the port (``repurpose_tpu/parallel/``): the process mesh
and its point-to-point hop (``mesh.py``), the Megatron TP rules, ZeRO-1's
partition and the batch slicing (``sharding.py``), the GPipe and 1F1B
pipeline schedules (``pipeline.py``, ``pipeline_1f1b.py``), and a
multi-process dry run (``dryrun.py``). Ring attention, the ``seq`` axis's
kernel of work, is ``ops/ring_attention.py``."""
