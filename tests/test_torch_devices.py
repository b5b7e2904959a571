"""The port's entry points run on the card unless the caller asks for the
CPU: with no device argument each builds on "cuda", and raises where there
is no card; with device="cpu" each builds on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import TORCH_CFG, numpy_params
from flash_attention_tpu_torch.data import loader as tloader
from flash_attention_tpu_torch.inference import kv_cache as tkv
from flash_attention_tpu_torch.models import gpt as tgpt
from flash_attention_tpu_torch.training import Trainer, TrainerConfig

CFG = dataclasses.replace(TORCH_CFG, n_layer=1)

# name: a call of the entry point with the given keyword arguments, giving
# a tensor whose device says where it built
ENTRY_POINTS = {
    "GPT": lambda **kw: tgpt.GPT(CFG, **kw).wte,
    "params_from_jax": lambda **kw: tgpt.params_from_jax(numpy_params(0), TORCH_CFG, **kw).wte,
    "Trainer": lambda **kw: Trainer(CFG, TrainerConfig(max_iters=1), **kw).model.wte,
    "init_cache": lambda **kw: tkv.init_cache(1, 2, 4, 16, 16, quant_dtype=torch.int8, **kw).k_scale,
    "identity_page_indices": lambda **kw: tkv.identity_page_indices(2, 256, 64, **kw),
    "batch_iterator": lambda **kw: next(tloader.batch_iterator(np.arange(300, dtype=np.uint16), 2, 16, **kw))[0],
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
    assert ENTRY_POINTS[entry](device="cpu").device.type == "cpu"
