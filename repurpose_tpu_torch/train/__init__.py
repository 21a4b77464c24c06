"""Training on one card or a mesh of ranks: ``python -m repurpose_tpu_torch.train`` (see
``__main__``), the ``Trainer`` (``loop``), the step (``step``), the optimizer
and state (``state``), the schedule and checkpoints."""
