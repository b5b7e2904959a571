"""Drive the PyTorch/CUDA port's serving path on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its lines; any failure raises, so the script exits
non-zero and never prints the final `"ok": true` line:

1. device   - a CUDA card of capability 9.0 (Hopper), its name and power
              limit from nvidia-smi; TF32 off for fp32 matmuls.
2. build    - compile the port's CUDA kernels from this checkout's sources.
3. k1       - the flash-attention forward kernel against its plain PyTorch
              tile loop and against dense (vanilla) attention, at the GPT-2
              prefill shapes and more, each error beside its tolerance.
4. serving  - GPT-2 124M (bf16, random weights from --seed) behind the
              continuous-batching engine: 16 requests, every one finishing
              with its exact budget; the kernel's launch count during the
              run equals n_layer x prefill dispatches.
5. parity   - GPT-2 124M in fp32: prefill logits and 8 teacher-forced
              decode steps against the model's forward on dense attention.
6. timing   - the kernel against its plain version and vanilla at GPT-2
              prefill shapes, CUDA events, median of 20 runs.

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flash_attention_tpu_torch.inference import InferenceEngine, init_cache  # noqa: E402
from flash_attention_tpu_torch.inference.model_runner import decode_step, prefill  # noqa: E402
from flash_attention_tpu_torch.kernels import _build  # noqa: E402
from flash_attention_tpu_torch.kernels.vanilla import vanilla_attention_with_lse  # noqa: E402
from flash_attention_tpu_torch.models.gpt import GPT, GPT2_124M  # noqa: E402
from flash_attention_tpu_torch.utils.devices import device_info  # noqa: E402

# the module, not the function that kernels/__init__ re-exports under its name
FA = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
KERNEL_SOURCE = "flash_attention_tpu_torch/csrc/flash_fwd.cu"
REPLACES = "flash_attention_tpu/kernels/flash_attention.py:269"


def say(*parts) -> None:
    print(*parts, flush=True)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs only on the card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say(f"[device] {smi}")
    info = device_info()[0]
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {info['kind']}, capability {cap}, "
        f"{info['sms']} SMs, {info['memory_bytes'] / 2**30:.1f} GiB, count {torch.cuda.device_count()}")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    say(f"[build] {os.path.relpath(_build.build_info['path'])} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_info['seconds']:.1f} s)")
    # ptxas -v: one "Compiling entry function" line per instantiation, then
    # its spills and registers
    kernel = ""
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_fwd_(?:mma|simt)_kernel)I(\w+?)E", line)
            if m:
                args = m.group(2)
                dtype = "bf16" if "bfloat16" in args else "fp16" if "half" in args else "fp32"
                kernel = f"{m.group(1)} {dtype} D{re.search(r'Li(\d+)', args).group(1)}"
            else:
                kernel = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            say(f"[build] ptxas {kernel}: {line.split(':', 1)[1].strip()}; {spills}")


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to(device="cuda", dtype=dtype)


def check_k1(label, gen, b, hq, hkv, lq, lk, d, dtype, causal, atol) -> float:
    """Kernel vs plain tile loop vs fp32 vanilla on the same inputs; returns
    the kernel's max error against the plain version."""
    q = _rand(gen, (b, hq, lq, d), dtype)
    k = _rand(gen, (b, hkv, lk, d), dtype)
    v = _rand(gen, (b, hkv, lk, d), dtype)
    with torch.no_grad():
        out = FA.flash_attention(q, k, v, causal=causal)
        plain, _ = FA.flash_attention_reference(q, k, v, causal=causal)
        g = hq // hkv
        dense, _ = vanilla_attention_with_lse(
            q.float(), k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1),
            causal=causal, sm_scale=d ** -0.5,
        )
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"[k1] {label}: bad output {out.shape} {out.dtype}")
    e_plain = (out.float() - plain.float()).abs().max().item()
    e_dense = (out.float() - dense).abs().max().item()
    ok = e_plain <= atol and e_dense <= atol
    say(f"[k1] {label:<34} vs plain {e_plain:.3e}  vs vanilla {e_dense:.3e}  atol {atol:g}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[k1] {label} outside tolerance")
    return e_plain


def phase_k1(seed: int) -> float:
    gen = torch.Generator().manual_seed(seed)
    bf16, worst = torch.bfloat16, 0.0
    # bf16 tier: fp32 vanilla of the same bf16 inputs, atol 2e-2
    for b in (1, 4):
        for L in (40, 128, 200, 1024):
            err = check_k1(f"gpt2 prefill b{b} h12 L{L} D64 bf16", gen, b, 12, 12, L, L, 64, bf16, True, 2e-2)
            worst = max(worst, err)
    check_k1("fp32 b1 h4 L384 D64", gen, 1, 4, 4, 384, 384, 64, torch.float32, True, 1e-5)
    check_k1("gqa hq8 hkv2 L384 D128 bf16", gen, 1, 8, 2, 384, 384, 128, bf16, True, 2e-2)
    check_k1("lq<lkv q128 kv384 D64 bf16", gen, 2, 12, 12, 128, 384, 64, bf16, True, 2e-2)
    check_k1("non-causal L200 D64 bf16", gen, 2, 12, 12, 200, 200, 64, bf16, False, 2e-2)
    check_k1("fp16 native b2 h12 L200 D64", gen, 2, 12, 12, 200, 200, 64, torch.float16, True, 2e-2)
    # lse (fp32, natural log) against dense attention's
    q, k, v = (_rand(gen, (1, 4, 300, 64), torch.float32) for _ in range(3))
    with torch.no_grad():
        out, lse = FA.flash_attention_with_lse(q, k, v)
        d_out, d_lse = vanilla_attention_with_lse(q, k, v, sm_scale=64 ** -0.5)
    torch.cuda.synchronize()
    e_out = (out - d_out).abs().max().item()
    e_lse = (lse - d_lse).abs().max().item()
    say(f"[k1] {'lse fp32 b1 h4 L300 D64':<34} out {e_out:.3e}  lse {e_lse:.3e}  atol 1e-05  "
        f"{'ok' if max(e_out, e_lse) <= 1e-5 else 'FAIL'}")
    if max(e_out, e_lse) > 1e-5:
        raise AssertionError("[k1] lse outside tolerance")
    return worst


def phase_serving(seed: int) -> dict:
    cfg = GPT2_124M
    t0 = time.perf_counter()
    model = GPT(cfg, generator=torch.Generator().manual_seed(seed), device="cuda")
    say(f"[serving] GPT-2 124M {cfg.dtype} vocab {cfg.vocab_size} layers {cfg.n_layer} heads {cfg.n_head} "
        f"width {cfg.n_embd}, random weights (seed {seed}) in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([
        rng.integers(16, 65, 2), rng.integers(129, 901, 4), rng.integers(16, 901, 10)
    ])
    rng.shuffle(lengths)
    budgets = rng.integers(32, 65, 16)
    eng = InferenceEngine(model, slots=8, max_len=1024, scan_steps=8, device="cuda", rng_seed=seed)
    # warm-up: cuBLAS handles, allocator; not counted
    eng.submit(rng.integers(0, cfg.vocab_size, 200).tolist(), max_new_tokens=4)
    eng.run()
    eng.finished.clear()
    eng.reset_stats()
    torch.cuda.synchronize()

    FA.KERNEL_LAUNCHES["flash_fwd"] = 0
    reqs = []
    for i in range(16):
        kw = {}
        if i % 2:
            kw = dict(temperature=0.8, top_k=50) if i % 4 == 1 else dict(temperature=0.8, top_p=0.95)
        prompt = rng.integers(0, cfg.vocab_size, int(lengths[i])).tolist()
        reqs.append((eng.submit(prompt, max_new_tokens=int(budgets[i]), **kw), int(budgets[i])))
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.KERNEL_LAUNCHES["flash_fwd"]

    by_uid = {r.uid: r for r in done}
    if len(done) != 16 or set(by_uid) != {u for u, _ in reqs}:
        raise AssertionError(f"[serving] {len(done)} of 16 requests finished")
    for uid, budget in reqs:
        out = by_uid[uid].output
        if len(out) != budget:
            raise AssertionError(f"[serving] request {uid}: {len(out)} tokens, budget {budget}")
        if not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"[serving] request {uid}: token id out of range")
    dispatches = eng.stats["prefill_dispatches"]
    if launches <= 0 or launches != cfg.n_layer * dispatches:
        raise AssertionError(f"[serving] flash_fwd launches {launches} != {cfg.n_layer} x {dispatches} prefill dispatches")
    toks = sum(len(r.output) for r in done)
    ttft = sorted(r.ttft for r in done)
    p50, p95 = statistics.median(ttft), ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))]
    say(f"[serving] 16/16 requests finished with their exact budgets; prompt lengths {sorted(lengths.tolist())}")
    say(f"[serving] flash_fwd launches {launches} = {cfg.n_layer} layers x {dispatches} prefill dispatches")
    say(f"[serving] {toks} tokens in {wall:.3f} s wall: {toks / wall:.1f} tokens/s, TTFT p50 {p50 * 1e3:.1f} ms "
        f"p95 {p95 * 1e3:.1f} ms, decode steps {eng.stats['decode_steps']}")
    return {"launches": launches}


def phase_parity(seed: int) -> None:
    cfg = dataclasses.replace(GPT2_124M, dtype=torch.float32)
    model = GPT(cfg, generator=torch.Generator().manual_seed(seed + 1), device="cuda")
    dense = GPT(dataclasses.replace(cfg, use_flash=False), generator=torch.Generator().manual_seed(seed + 1), device="cuda")
    rng = np.random.default_rng(seed + 1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 300), device="cuda")
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, 8), device="cuda", dtype=torch.int32)
    with torch.no_grad():
        ref = dense(torch.cat([prompt, feed.long()])[None])[0].float()  # [308, vocab]
        cache = init_cache(cfg.n_layer, 1, cfg.kv_heads, 1024, cfg.head_dim, dtype=cfg.dtype, device="cuda")
        cache, logits = prefill(model, prompt, cache, 0)
        errs = [(logits - ref[prompt.numel() - 1]).abs().max().item()]
        for i in range(8):
            cache, logits = decode_step(model, feed[i:i + 1], cache)
            errs.append((logits[0] - ref[prompt.numel() + i]).abs().max().item())
    torch.cuda.synchronize()
    worst = max(errs)
    say(f"[parity] fp32 GPT-2 124M, prompt 300 + 8 teacher-forced decode steps vs forward on dense attention: "
        f"max abs logit error {worst:.3e} (prefill {errs[0]:.3e}) atol 1e-3 {'ok' if worst <= 1e-3 else 'FAIL'}")
    if worst > 1e-3:
        raise AssertionError("[parity] outside tolerance")


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(seed: int, smi: str) -> dict:
    gen = torch.Generator().manual_seed(seed + 2)
    result = {}
    for b in (1, 8):
        q, k, v = (_rand(gen, (b, 12, 1024, 64), torch.bfloat16) for _ in range(3))
        with torch.no_grad():
            kern = time_ms(lambda: FA.flash_attention(q, k, v))
            plain = time_ms(lambda: FA.flash_attention_reference(q, k, v))
            dense = time_ms(lambda: vanilla_attention_with_lse(q, k, v, sm_scale=0.125))
            sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4 * b * 12 * 1024 * 1024 * 64 / 2  # causal half of QK^T and PV
        say(f"[timing] {smi} | K1 b{b} h12 L1024 D64 bf16 causal: kernel {kern:.4f} ms "
            f"({flops / kern / 1e9:.1f} TFLOP/s), plain tile loop {plain:.4f} ms, vanilla {dense:.4f} ms; "
            f"yardstick torch SDPA {sdpa:.4f} ms")
        result[b] = (kern, plain)
    return result


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    name, smi = phase_device()
    phase_build()
    err = phase_k1(args.seed)
    serving = phase_serving(args.seed)
    phase_parity(args.seed)
    times = phase_timing(args.seed, smi)
    kern_ms, plain_ms = times[1]
    say(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": serving["launches"], "max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
