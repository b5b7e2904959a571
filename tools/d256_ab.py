"""Time one checkout's kernels at head dims 256 and above, and its D256
training step, on the card, for an A/B between checkouts or between builds
of one checkout.

    python3 tools/d256_ab.py <checkout dir> <label> [--head-dims 256 512 1024] [--dtype float32]
        [--build-only]

Imports `flash_attention_tpu_torch` from <checkout dir> and builds its
kernels there (its own build/torch_kernels/); --build-only stops after the
build, so that several checkouts can build at once before the timings.
Then it prints lines of results, the last `RESULT {json}`:

* for each head dim of --head-dims (256 when not given), after K1 and K4
  (int8 K/V) are held against their plain versions at b1 h2 L300 (2e-2),
  and the grads of K1 + pre-pass + K2 + K3 against the plain backward
  there (2e-2 x max |grad|):
  at b8 h12 L1024 bf16 causal, device time (a CUDA graph of calls between
  CUDA events, the checkout's `utils.measure.graph_ms`) of K1 without and
  with lse, K4 over int8 K/V, torch SDPA's forward, the backward's
  pre-pass, K2 and K3, and torch SDPA's whole backward (`sdpa_bwd`); K1's
  and K4's beside their share of the bound (`utils.measure.floor_ms`), and
  pre-pass + K2 + K3 against SDPA's backward;
* when 256 is among the head dims, `chip_smoke.py`'s d256-path model (a
  GPT at GPT-2's width with 3 heads of 256, 2 layers) trained at b4 x
  T1024 in bf16: the median wall time of 10 steps after 3 warm-up steps.

With --dtype float32 it times the fp32 kernels (the 3xTF32 K1, K4, K2 and
K3): at each head dim, K1 (output and lse) is held against its plain
version at 1e-5 and K4 over int8 and fp8 K/V at 5e-5 (b1, GQA 4/2, L300),
each launching once under its KERNEL_LAUNCHES key, and the grads of K1 +
pre-pass + K2 + K3 against the plain backward at 1e-4 (b1, GQA 4/2, q300
x kv300 and q129 x kv257 with window 100, K2 and K3 launching once each);
then at b8 h12 L1024 fp32 causal the device time of K1 without and with
lse, K4 over int8 and over fp8, and torch SDPA's fp32 forward, beside the
3xTF32 bound; and of the pre-pass, K2, K3 and torch SDPA's fp32 whole
backward, K2 and K3 beside their 3xTF32 bounds and pre-pass + K2 + K3
against SDPA's backward.

Compare in one call, in turns (A, B, B, A): times on the host's clock
spread between calls and between processes, and one process cannot import
two checkouts' packages.  The checkout must have `utils/measure.py`; two
checkouts are timed alike where that file agrees.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import json
import os
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("tree")
ap.add_argument("label")
ap.add_argument("--head-dims", type=int, nargs="+", default=[256])
ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
ap.add_argument("--build-only", action="store_true")
args = ap.parse_args()
sys.path.insert(0, os.path.abspath(args.tree))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the checkout under test first: chip_smoke.py's own imports then resolve to it
FA = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
if not FA.__file__.startswith(os.path.abspath(args.tree)):
    raise RuntimeError(f"imported {FA.__file__}, not the checkout in {args.tree}")
QK = importlib.import_module("flash_attention_tpu_torch.quant.kv")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from flash_attention_tpu_torch.data import CharTokenizer, batch_iterator, synthetic_corpus  # noqa: E402
from flash_attention_tpu_torch.kernels import _build  # noqa: E402
from flash_attention_tpu_torch.models.gpt import GPT2_124M  # noqa: E402
from flash_attention_tpu_torch.training import Trainer, TrainerConfig  # noqa: E402
from flash_attention_tpu_torch.utils.measure import TF32X3_FLOPS, floor_ms, graph_ms  # noqa: E402


def kernel_times(gen, d: int) -> dict:
    bf16 = torch.bfloat16
    q, k, v = (torch.randn((1, 2, 300, d), generator=gen).to("cuda", bf16) for _ in range(3))
    kv = QK.quantize_kv(k.float(), v.float())
    with torch.no_grad():
        e1 = (FA.flash_attention(q, k, v).float() - FA.flash_attention_reference(q, k, v)[0].float()).abs().max()
        e4 = (QK.flash_attention_kv_quant(q, kv).float()
              - QK.flash_attention_kv_quant_reference(q, kv).float()).abs().max()
    if not (e1.item() <= 2e-2 and e4.item() <= 2e-2):
        raise AssertionError(f"{args.label} D{d}: K1 {e1.item():.3e} / K4 {e4.item():.3e} vs plain, atol 2e-2")
    do = torch.randn((1, 2, 300, d), generator=gen).to("cuda", bf16)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(FA.flash_attention(qg, kg, vg), (qg, kg, vg), do)
    with torch.no_grad():
        o_p, lse_p = FA.flash_attention_reference(q, k, v)
        plain = FA.flash_attention_bwd_reference(q, k, v, o_p, lse_p, do)
    eg = max(((a.float() - b_.float()).abs().max() / b_.float().abs().max()).item() for a, b_ in zip(got, plain))
    if not eg <= 2e-2:
        raise AssertionError(f"{args.label} D{d}: grads {eg:.3e} x max |grad| from the plain backward, tol 2e-2")
    b, h, L = 8, 12, 1024
    q, k, v, do = (torch.randn((b, h, L, d), generator=gen).to("cuda", bf16) for _ in range(4))
    kv = QK.quantize_kv(k.float(), v.float())
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)
    with torch.no_grad():
        o, lse = FA.flash_attention_with_lse(q, k, v)
        row = {"k1": graph_ms(lambda: FA.flash_attention(q, k, v), calls=5, runs=7),
               "k1_lse": graph_ms(lambda: FA.flash_attention_with_lse(q, k, v), calls=5, runs=7),
               "k4_int8": graph_ms(lambda: QK.flash_attention_kv_quant(q, kv), calls=5, runs=7),
               "sdpa": graph_ms(lambda: sdpa(q, k, v), calls=5, runs=7)}
    spec = FA._Spec(causal=True, sm_scale=d ** -0.5, window=None, blocks=FA.default_blocks(L, L, d))
    bargs = FA._bwd_args(q, k, v, o, lse, do, None, spec, None)
    FA._launch_bwd_prep(bargs)
    row["prep"] = graph_ms(lambda: FA._launch_bwd_prep(bargs))
    row["k2"] = graph_ms(lambda: FA._launch_bwd_dkv(bargs), calls=3, runs=5)
    row["k3"] = graph_ms(lambda: FA._launch_bwd_dq(bargs), calls=2, runs=3)
    row["sdpa_bwd"] = graph_ms(smoke._grad_fn(sdpa, q, k, v, do), calls=2, runs=3)
    flops = 4 * b * h * L * L * d / 2
    (row["k1_bound"], by1), (row["k4_bound"], by4) = (floor_ms(4 * b * h * L * d * 2, flops),
                                                      floor_ms(b * h * L * (d * 6 + 8), flops))
    print(f"{args.label} b{b} h{h} L{L} D{d} bf16 causal device ms", {key: round(x, 4) for key, x in row.items()},
          f"| K1 {row['k1_bound'] / row['k1']:.1%} of its bound ({by1}), K4 {row['k4_bound'] / row['k4_int8']:.1%} "
          f"({by4}), K1 / SDPA {row['k1'] / row['sdpa']:.2f}x, pre-pass + K2 + K3 / SDPA backward "
          f"{(row['prep'] + row['k2'] + row['k3']) / row['sdpa_bwd']:.2f}x; vs plain at b1 h2 L300: K1 {e1.item():.2e}, "
          f"K4 {e4.item():.2e}, grads {eg:.2e} x max |grad|", flush=True)
    return row


def fp32_forward_times(gen, d: int) -> dict:
    f32 = torch.float32
    q = torch.randn((1, 4, 300, d), generator=gen).to("cuda")
    k, v = (torch.randn((1, 2, 300, d), generator=gen).to("cuda") for _ in range(2))
    errs = {}
    for name, call, plain, tol in (
        ("k1", lambda: FA.flash_attention_with_lse(q, k, v), lambda: FA.flash_attention_reference(q, k, v), 1e-5),
        *((f"k4_{tag}", functools.partial(QK.flash_attention_kv_quant, q, kv),
           functools.partial(QK.flash_attention_kv_quant_reference, q, kv), 5e-5)
          for tag, kv in (("int8", QK.quantize_kv(k, v, dtype=torch.int8)),
                          ("fp8", QK.quantize_kv(k, v, dtype=torch.float8_e4m3fn))))):
        before = dict(FA.KERNEL_LAUNCHES)
        with torch.no_grad():
            got, want = call(), plain()
        torch.cuda.synchronize()
        launched = {key: n - before[key] for key, n in FA.KERNEL_LAUNCHES.items() if n != before[key]}
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        errs[name] = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
        key = FA._route("flash_fwd_kv_quant" if name.startswith("k4") else "flash_fwd", FA.padded_head_dim(d), f32)[0]
        if not errs[name] <= tol or launched != {key: 1}:
            raise AssertionError(f"{args.label} D{d} fp32 {name}: {errs[name]:.3e} vs plain (atol {tol:g}), "
                                 f"launched {launched}")
    b, h, L = 8, 12, 1024
    q, k, v = (torch.randn((b, h, L, d), generator=gen).to("cuda") for _ in range(3))
    kv8, kvf = (QK.quantize_kv(k, v, dtype=t) for t in (torch.int8, torch.float8_e4m3fn))
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)
    with torch.no_grad():
        row = {"k1": graph_ms(lambda: FA.flash_attention(q, k, v), calls=3, runs=7),
               "k1_lse": graph_ms(lambda: FA.flash_attention_with_lse(q, k, v), calls=3, runs=7),
               "k4_int8": graph_ms(lambda: QK.flash_attention_kv_quant(q, kv8), calls=3, runs=7),
               "k4_fp8": graph_ms(lambda: QK.flash_attention_kv_quant(q, kvf), calls=3, runs=7),
               "sdpa": graph_ms(lambda: sdpa(q, k, v), calls=3, runs=7)}
    row["bound"], by = floor_ms(4 * b * h * L * d * 4, 4 * b * h * L * L * d / 2, TF32X3_FLOPS)
    print(f"{args.label} b{b} h{h} L{L} D{d} fp32 causal device ms", {key: round(x, 4) for key, x in row.items()},
          f"| K1 {row['bound'] / row['k1']:.1%} of its bound ({by}, 3xTF32), K4 int8 "
          f"{row['bound'] / row['k4_int8']:.1%}, K1 / SDPA {row['k1'] / row['sdpa']:.2f}x; vs plain at b1 4/2 L300: "
          + ", ".join(f"{key} {e:.2e}" for key, e in errs.items()), flush=True)
    return row


def fp32_backward_times(gen, d: int) -> dict:
    f32 = torch.float32
    errs = {}
    for tag, lq, lk, window in (("L300", 300, 300, None), ("q129 kv257 w100", 129, 257, 100)):
        q, do = (torch.randn((1, 4, lq, d), generator=gen).to("cuda") for _ in range(2))
        k, v = (torch.randn((1, 2, lk, d), generator=gen).to("cuda") for _ in range(2))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        before = dict(FA.KERNEL_LAUNCHES)
        got = torch.autograd.grad(FA.flash_attention(qg, kg, vg, window=window), (qg, kg, vg), do)
        with torch.no_grad():
            o_p, lse_p = FA.flash_attention_reference(q, k, v, window=window)
            plain = FA.flash_attention_bwd_reference(q, k, v, o_p, lse_p, do, window=window)
        torch.cuda.synchronize()
        launched = {key: n - before[key] for key, n in FA.KERNEL_LAUNCHES.items() if n != before[key]}
        errs[tag] = max((a - b_).abs().max().item() for a, b_ in zip(got, plain))
        want = {FA._route(name, FA.padded_head_dim(d), f32)[0] for name in ("flash_bwd_dkv", "flash_bwd_dq")}
        if not errs[tag] <= 1e-4 or any(launched.get(key) != 1 for key in want):
            raise AssertionError(f"{args.label} D{d} fp32 grads {tag}: {errs[tag]:.3e} vs plain (atol 1e-4), "
                                 f"launched {launched}")
    b, h, L = 8, 12, 1024
    q, k, v, do = (torch.randn((b, h, L, d), generator=gen).to("cuda") for _ in range(4))
    spec = FA._Spec(causal=True, sm_scale=d ** -0.5, window=None, blocks=FA.default_blocks(L, L, d, dtype=f32))
    with torch.no_grad():
        o, lse = FA.flash_attention_with_lse(q, k, v)
    bargs = FA._bwd_args(q, k, v, o, lse, do, None, spec, None)
    FA._launch_bwd_prep(bargs)
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)
    row = {"prep": graph_ms(lambda: FA._launch_bwd_prep(bargs)),
           "k2": graph_ms(lambda: FA._launch_bwd_dkv(bargs), calls=2, runs=5),
           "k3": graph_ms(lambda: FA._launch_bwd_dq(bargs), calls=2, runs=5),
           "sdpa_bwd": graph_ms(smoke._grad_fn(sdpa, q, k, v, do), calls=2, runs=3)}
    elems, rows, flops = b * h * L * d, b * h * L, 4 * b * h * L * L * d / 2
    (row["k2_bound"], by2), (row["k3_bound"], by3) = (
        floor_ms(6 * elems * 4 + 2 * rows * 4, 2 * flops, TF32X3_FLOPS),
        floor_ms(5 * elems * 4 + 2 * rows * 4, 1.5 * flops, TF32X3_FLOPS))
    total = row["prep"] + row["k2"] + row["k3"]
    print(f"{args.label} b{b} h{h} L{L} D{d} fp32 causal backward device ms",
          {key: round(x, 4) for key, x in row.items()},
          f"| K2 {row['k2_bound'] / row['k2']:.1%} of its bound ({by2}, 3xTF32), K3 "
          f"{row['k3_bound'] / row['k3']:.1%} ({by3}), pre-pass + K2 + K3 {total:.4f} ms, / SDPA backward "
          f"{total / row['sdpa_bwd']:.2f}x; grads vs plain at b1 4/2: "
          + ", ".join(f"{key} {e:.2e}" for key, e in errs.items()), flush=True)
    return row


def training_times(seed: int = 0) -> dict:
    text = synthetic_corpus()
    data = CharTokenizer(text).encode(text)
    cfg = dataclasses.replace(GPT2_124M, n_layer=2, n_head=3)
    trainer = Trainer(cfg, TrainerConfig(max_iters=3, log_interval=1, learning_rate=6e-4, warmup_iters=1),
                      seed=seed, device="cuda")
    batches = batch_iterator(data, 4, 1024, seed=seed, device="cuda")
    trainer.fit(batches, log=lambda line: None)  # warm-up
    trainer.tcfg.max_iters = 14
    history = trainer.fit(batches, log=lambda line: None)
    walls = np.diff([r["wall_s"] for r in history[-11:]]) * 1e3  # wall_s restarts with each fit
    out = dict(step_wall_median_ms=float(np.median(walls)), step_wall_min_ms=float(walls.min()),
               step_wall_max_ms=float(walls.max()))
    print(args.label, "d256-path training step", out, flush=True)
    return out


def main() -> None:
    t0 = time.perf_counter()
    _build.build()
    if args.build_only:
        print(args.label, "built", _build.build_info["path"], f"in {time.perf_counter() - t0:.1f} s", flush=True)
        return
    name, smi = smoke.phase_device()
    _build.library()
    res = {"label": args.label, "checkout": args.tree, "device": name, "smi": smi}
    gen = torch.Generator().manual_seed(11)
    if args.dtype == "float32":
        res["kernels"] = {f"d{d}": {**fp32_forward_times(gen, d), **fp32_backward_times(gen, d)}
                          for d in args.head_dims}
    else:
        res["kernels"] = {f"d{d}": kernel_times(gen, d) for d in args.head_dims}
    if 256 in args.head_dims and args.dtype == "bfloat16":
        res["training"] = training_times()
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
