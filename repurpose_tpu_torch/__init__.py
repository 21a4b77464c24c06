"""PyTorch / CUDA port of repurpose_tpu for NVIDIA Hopper (H100).

The serving path (MMCT forward -> decode -> Soft-NMS, ``infer.py``) and the
training path (focal loss, Adam, the ``Trainer`` and ``python -m
repurpose_tpu_torch.train``) run here in PyTorch; the attention forward and
backward are CUDA C++ kernels written for ``sm_90a`` (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, bound in ``native.py``). The JAX package
``repurpose_tpu`` stays the reference: this package imports nothing of it,
and none of JAX, Flax or Optax.

Entry points default to ``device="cuda"`` and raise when CUDA is absent,
unless the caller asks for ``device="cpu"`` (as the CPU tests do). On a CPU
tensor each kernel wrapper takes its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.

TF32 is switched off on import (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so float32 matrix products on the card
run in full float32, as the reference's float32 parity mode requires.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. Raises for CUDA when no card is
    visible: a CUDA caller never silently lands on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
