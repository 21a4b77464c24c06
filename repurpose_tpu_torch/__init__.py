"""PyTorch / CUDA port of repurpose_tpu for NVIDIA Hopper (H100).

The serving path (MMCT forward -> decode -> Soft-NMS, ``infer.py``) and the
training path (focal loss, Adam, the ``Trainer`` and ``python -m
repurpose_tpu_torch.train``) run here in PyTorch, up to the long-video
buckets of ``configs/longvideo.yaml`` (T to 32768, remat for training); the
attention forward and backward are CUDA C++ kernels written for ``sm_90a``
(``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` up to T = 2048,
``csrc/flash_fwd_stream.cu`` and ``csrc/flash_bwd_stream.cu`` past it, bound
in ``native.py``). ``tools/`` ports the two bench tools whose Pallas kernels
lie outside the JAX package (``csrc/flash_fwd_nt.cu``,
``csrc/int8_matmul.cu``). ``extractors/`` and ``preprocessing/`` port the
feature extractors (CLIP ViT-B/32, CNN14, MiniLM-L6, Whisper ASR with its
word aligner) and the preprocessing drivers and CLI (``python -m
repurpose_tpu_torch.preprocess``) in plain PyTorch, as the JAX package
runs them in XLA. The JAX package
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
