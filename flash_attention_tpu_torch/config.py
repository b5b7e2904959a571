"""Global configuration for the PyTorch/CUDA port.

Where the JAX package ran its Pallas kernels in interpret mode off the TPU
(`flash_attention_tpu/config.py::use_interpret`), this port has no interpret
mode: a kernel wrapper looks at the device of the tensor it was given.  A
CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
kernel's plain PyTorch version; anything else raises.
"""

from __future__ import annotations

import os

import torch

# Kernels are compiled on first use into this directory, relative to the
# checkout (the package's parent), which `.gitignore` lists under `build/`.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")


def kernel_route(*tensors: torch.Tensor) -> str:
    """"cuda" when every tensor lies on a CUDA device, "plain" when every
    tensor lies on the CPU; raises for a mix or for any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"cpu"}:
        return "plain"
    raise ValueError(f"tensors on unsupported or mixed devices: {sorted(kinds)}")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device a module or engine was asked for; None means the card
    ("cuda").  "cuda" without a usable card raises: the port runs on the
    CPU only when the caller asks for it, never in the card's place."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for device 'cuda' (the default); pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
