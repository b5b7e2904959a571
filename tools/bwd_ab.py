"""Time the flash-attention backward, the fp32 forward and a traced GPT-2
training step of one checkout of the PyTorch port on the card, for an A/B
between checkouts.

    python3 tools/bwd_ab.py <checkout dir> <label> [--backward-only | --fp32-only]

Imports `flash_attention_tpu_torch` from <checkout dir>, builds its kernels
there (its own build/torch_kernels/), and prints lines of results, the last
`RESULT {json}`:

* the backward at h12 L1024 causal, bf16 at b1 and b8 at D64 and b8 at
  D128, and fp32 at b8 at D64 and D128 (the rows "..._fp32"), as device
  time (a CUDA graph of 20 calls between CUDA events): di (the pre-pass
  kernel where the checkout has one, else the eager reduction `_bwd_args`
  ran before it), K2, K3, the whole backward as the autograd Function runs
  it (`_launch_bwd`), and torch SDPA's backward in the same dtype; the
  fp32 rows also time the forward: K1 without and with lse (`_launch`),
  K4 on int8 and fp8 K/V (`quant.kv._launch`), and torch SDPA's fp32
  forward;
* with --fp32-only, the fp32 rows alone;
* unless --backward-only or --fp32-only: GPT-2 124M training at b8 x T1024 (bf16
  compute, fp32 master weights): 5 warm-up steps, the median wall time of
  15 more, then torch.profiler over 3 more: device-busy ms a step and
  kernel ms a step by kind.

The timer is the checkout's `flash_attention_tpu_torch.utils.measure.
graph_ms`, the gradient call and the trace this checkout's `chip_smoke.py`
(`_grad_fn`, `_trace_steps`, which reads `utils.profiling.device_time`),
so the checkout must have `utils/measure.py` and `utils/profiling.py`, and
two checkouts are measured alike where those files agree.  Compare two
checkouts in one call, in turns (A, B, B, A): times on the host's clock
spread between calls and between processes, and one process cannot import
two checkouts' packages.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
import sys
import time

tree, label = sys.argv[1], sys.argv[2]
fp32_only = "--fp32-only" in sys.argv[3:]
backward_only = "--backward-only" in sys.argv[3:] or fp32_only
sys.path.insert(0, os.path.abspath(tree))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the checkout under test first: chip_smoke.py's own imports then resolve to it
FA = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
QK = importlib.import_module("flash_attention_tpu_torch.quant.kv")
if not FA.__file__.startswith(os.path.abspath(tree)):
    raise RuntimeError(f"imported {FA.__file__}, not the checkout in {tree}")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from flash_attention_tpu_torch.data import CharTokenizer, batch_iterator, synthetic_corpus  # noqa: E402
from flash_attention_tpu_torch.kernels import _build  # noqa: E402
from flash_attention_tpu_torch.models.gpt import GPT2_124M  # noqa: E402
from flash_attention_tpu_torch.training import Trainer, TrainerConfig  # noqa: E402
from flash_attention_tpu_torch.utils.measure import graph_ms  # noqa: E402


def backward_times(gen) -> dict:
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)
    out = {}
    shapes = ((1, 64, torch.bfloat16), (8, 64, torch.bfloat16), (8, 128, torch.bfloat16),
              (8, 64, torch.float32), (8, 128, torch.float32))
    for b, d, dtype in shapes[3:] if fp32_only else shapes:
        q, k, v, do = (torch.randn((b, 12, 1024, d), generator=gen).to("cuda", dtype) for _ in range(4))
        with torch.no_grad():
            o, lse = FA.flash_attention_with_lse(q, k, v)
        spec = FA._Spec(causal=True, sm_scale=d ** -0.5, window=None,
                        blocks=FA.default_blocks(1024, 1024, d, dtype=dtype))
        args = FA._bwd_args(q, k, v, o, lse, do, None, spec, None)
        row = {}
        if hasattr(FA, "_launch_bwd_prep"):
            FA._launch_bwd_prep(args)
            row["di"] = graph_ms(lambda: FA._launch_bwd_prep(args))
        else:  # di as the checkout's _bwd_args computes it
            row["di"] = graph_ms(lambda: (o.float() * do.float()).sum(-1).contiguous())
        row["k2"] = graph_ms(lambda: FA._launch_bwd_dkv(args))
        row["k3"] = graph_ms(lambda: FA._launch_bwd_dq(args))
        row["backward"] = graph_ms(lambda: FA._launch_bwd(q, k, v, o, lse, do, None, spec, None))
        row["sdpa_backward"] = graph_ms(smoke._grad_fn(sdpa, q, k, v, do))
        if dtype == torch.float32:
            with torch.no_grad():
                row["k1"] = graph_ms(lambda: FA._launch(q, k, v, spec, None, False), calls=5, runs=5)
                row["k1_lse"] = graph_ms(lambda: FA._launch(q, k, v, spec, None, True), calls=5, runs=5)
                for name, qdt in (("k4_int8", torch.int8), ("k4_fp8", torch.float8_e4m3fn)):
                    kv = QK.quantize_kv(k, v, dtype=qdt)
                    row[name] = graph_ms(lambda: QK._launch(q, kv, True, d ** -0.5, None, None), calls=5, runs=5)
                row["sdpa_forward"] = graph_ms(lambda: sdpa(q, k, v), calls=5, runs=5)
        tag = f"b{b}_d{d}" + ("_fp32" if dtype == torch.float32 else "")
        out[tag] = row
        print(label, f"{tag} device ms", {key: round(x, 4) for key, x in row.items()}, flush=True)
    return out


def training_times(smi: str, seed: int = 0) -> dict:
    text = synthetic_corpus()
    data = CharTokenizer(text).encode(text)
    trainer = Trainer(GPT2_124M, TrainerConfig(max_iters=5, log_interval=1, learning_rate=6e-4, warmup_iters=5),
                      seed=seed, device="cuda")
    batches = batch_iterator(data, 8, 1024, seed=seed, device="cuda")
    trainer.fit(batches, log=lambda line: None)  # warm-up
    trainer.tcfg.max_iters = 20
    history = trainer.fit(batches, log=lambda line: None)
    walls = np.diff([r["wall_s"] for r in history[-15:]]) * 1e3  # wall_s restarts with each fit
    med = float(np.median(walls))
    out = dict(step_wall_median_ms=med, step_wall_min_ms=float(walls.min()), step_wall_max_ms=float(walls.max()),
               **smoke._trace_steps(trainer, batches, smi, med))
    print(label, "training", out, flush=True)
    return out


def main() -> None:
    name, smi = smoke.phase_device()
    t0 = time.perf_counter()
    _build.library()
    res = {"label": label, "checkout": tree, "device": name, "smi": smi, "build_s": time.perf_counter() - t0}
    res["backward"] = backward_times(torch.Generator().manual_seed(11))
    if not backward_only:
        res["training"] = training_times(smi)
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
