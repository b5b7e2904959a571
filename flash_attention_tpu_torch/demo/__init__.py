"""Demos of the PyTorch/CUDA port (`python -m flash_attention_tpu_torch.demo.train`)."""
