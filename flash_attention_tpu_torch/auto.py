"""Import-with-side-effect auto-integration.

``import flash_attention_tpu_torch.auto`` patches
``torch.nn.functional.scaled_dot_product_attention`` to route onto the
flash kernels where they compute the same thing (`ops/sdpa.py`).
"""

from .ops.sdpa import install_patch

install_patch()
