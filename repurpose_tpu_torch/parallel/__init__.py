"""Data and tensor parallelism of the port (``repurpose_tpu/parallel/``):
the process mesh (``mesh.py``), the Megatron TP rules, ZeRO-1's partition
and the batch slicing (``sharding.py``), and a multi-process dry run
(``dryrun.py``)."""
