"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its lines; any failure raises, so the script exits
non-zero and never prints the final `"ok": true` line:

1. device   - a CUDA card of capability 9.0 (Hopper), its name and power
              limit from nvidia-smi; TF32 off for fp32 matmuls.
2. build    - compile the port's CUDA kernels from this checkout's sources
              (one nvcc per source, in parallel) and print ptxas's
              registers and spills per kernel.
3. k1       - the flash-attention forward kernel against its plain PyTorch
              tile loop and against dense (vanilla) attention, at the GPT-2
              shapes and more (window, segment ids), each error beside its
              tolerance.
4. k2k3     - gradients of K1+K2+K3 through the autograd Function against
              the plain backward and against autograd of fp32 vanilla.
5. serving  - GPT-2 124M (bf16, random weights from --seed) behind the
              continuous-batching engine: 16 requests, every one finishing
              with its exact budget; K1's launch count during the run
              equals n_layer x prefill dispatches.
6. parity   - GPT-2 124M in fp32: prefill logits and 8 teacher-forced
              decode steps against the model's forward on dense attention.
7. training - the port's Trainer on GPT-2 124M (bf16 compute, fp32 master
              weights) for 20 steps at b8 x T1024: losses finite and
              falling by more than 1 nat; K1, K2 and K3 each launched
              n_layer x steps times; step time, tokens/s, peak memory.
8. train-parity - GPT-2 124M in fp32, 5 steps at b2 x T512 on flash and on
              dense attention from the same weights and batches: losses
              within 2e-3.
9. timing   - K1, and one backward (K2, K3, both with the di reduction),
              against the plain versions and vanilla at GPT-2 shapes, CUDA
              events, median of 20 runs.

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

from flash_attention_tpu_torch.data import CharTokenizer, batch_iterator, synthetic_corpus  # noqa: E402
from flash_attention_tpu_torch.inference import InferenceEngine, init_cache  # noqa: E402
from flash_attention_tpu_torch.inference.model_runner import decode_step, prefill  # noqa: E402
from flash_attention_tpu_torch.kernels import _build  # noqa: E402
from flash_attention_tpu_torch.kernels.vanilla import vanilla_attention_with_lse  # noqa: E402
from flash_attention_tpu_torch.models.gpt import GPT, GPT2_124M  # noqa: E402
from flash_attention_tpu_torch.training import Trainer, TrainerConfig  # noqa: E402
from flash_attention_tpu_torch.utils.devices import device_info  # noqa: E402

# the module, not the function that kernels/__init__ re-exports under its name
FA = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "flash_fwd": ("flash_attention_tpu_torch/csrc/flash_fwd.cu", "flash_attention_tpu/kernels/flash_attention.py:269"),
    "flash_bwd_dkv": ("flash_attention_tpu_torch/csrc/flash_bwd.cu", "flash_attention_tpu/kernels/flash_attention.py:637"),
    "flash_bwd_dq": ("flash_attention_tpu_torch/csrc/flash_bwd.cu", "flash_attention_tpu/kernels/flash_attention.py:765"),
}


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
            m = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_(?:mma|simt)_kernel)I(\w+?)E", line)
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


def _segment_ids(b: int, length: int, n: int = 3) -> torch.Tensor:
    """n segments per row, of unequal lengths, as int32 on the card."""
    cuts = [0, length // 5, length // 2, length]
    ids = torch.zeros(b, length, dtype=torch.int32)
    for i in range(n):
        ids[:, cuts[i]:cuts[i + 1]] = i
    return ids.cuda()


def check_k1(label, gen, b, hq, hkv, lq, lk, d, dtype, causal, atol, window=None, segments=False) -> float:
    """Kernel vs plain tile loop vs fp32 vanilla on the same inputs; returns
    the kernel's max error against the plain version."""
    q = _rand(gen, (b, hq, lq, d), dtype)
    k = _rand(gen, (b, hkv, lk, d), dtype)
    v = _rand(gen, (b, hkv, lk, d), dtype)
    segs = (_segment_ids(b, lq), _segment_ids(b, lk)) if segments else None
    with torch.no_grad():
        out = FA.flash_attention(q, k, v, causal=causal, window=window, segment_ids=segs)
        plain, _ = FA.flash_attention_reference(q, k, v, causal=causal, window=window, segment_ids=segs)
        g = hq // hkv
        dense, _ = vanilla_attention_with_lse(
            q.float(), k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1),
            causal=causal, sm_scale=d ** -0.5, window=window, segment_ids=segs,
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
    check_k1("window 256 b2 h12 L1024 D64 bf16", gen, 2, 12, 12, 1024, 1024, 64, bf16, True, 2e-2, window=256)
    check_k1("3 segments b2 h12 L1024 D64 bf16", gen, 2, 12, 12, 1024, 1024, 64, bf16, True, 2e-2, segments=True)
    check_k1("window 100 fp32 b1 h4 L384 D128", gen, 1, 4, 4, 384, 384, 128, torch.float32, True, 1e-5, window=100)
    check_k1("3 segments fp32 b2 h4 L300 D64", gen, 2, 4, 2, 300, 300, 64, torch.float32, True, 1e-5, segments=True)
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


def check_grads(label, gen, b, hq, hkv, lq, lk, d, dtype, causal=True, window=None, segments=False,
                with_lse=False) -> dict:
    """Gradients of K1+K2+K3 through the autograd Function against the plain
    backward (on the plain forward's o and lse) and against autograd of fp32
    vanilla attention, on the same inputs and one random dO (and dlse).
    fp32: absolute 1e-4, the source repo's backward tier.  bf16/fp16: max
    error <= 2e-2 x max |grad| of the fp32 reference, since P and dS are
    rounded to the 16-bit type before their products.  Returns the worst
    error of each grad against the plain backward."""
    q = _rand(gen, (b, hq, lq, d), dtype).requires_grad_()
    k = _rand(gen, (b, hkv, lk, d), dtype).requires_grad_()
    v = _rand(gen, (b, hkv, lk, d), dtype).requires_grad_()
    do = _rand(gen, (b, hq, lq, d), dtype)
    dlse = _rand(gen, (b, hq, lq), torch.float32) if with_lse else None
    segs = (_segment_ids(b, lq), _segment_ids(b, lk)) if segments else None
    kw = dict(causal=causal, window=window, segment_ids=segs)
    if with_lse:
        out, lse = FA.flash_attention_with_lse(q, k, v, causal=causal)
        torch.autograd.backward((out, lse), (do, dlse))
    else:
        FA.flash_attention(q, k, v, **kw).backward(do)
    got = (q.grad, k.grad, v.grad)
    with torch.no_grad():
        o_p, lse_p = FA.flash_attention_reference(q, k, v, **kw)
        plain = FA.flash_attention_bwd_reference(q, k, v, o_p, lse_p, do, dlse=dlse, **kw)
    g = hq // hkv
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o_v, lse_v = vanilla_attention_with_lse(
        qf, kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1), sm_scale=d ** -0.5, **kw
    )
    loss = (o_v * do.float()).sum() + ((lse_v * dlse).sum() if with_lse else 0.0)
    dense = torch.autograd.grad(loss, (qf, kf, vf))
    torch.cuda.synchronize()
    worst, ok = {}, True
    parts = []
    for name, a, p_, r in zip(("dq", "dk", "dv"), got, plain, dense):
        if a.shape != r.shape or a.dtype != dtype or not torch.isfinite(a).all():
            raise AssertionError(f"[k2k3] {label}: bad {name} {tuple(a.shape)} {a.dtype}")
        e_p = (a.float() - p_.float()).abs().max().item()
        e_d = (a.float() - r).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2e-2 * r.abs().max().item()
        ok = ok and e_p <= tol and e_d <= tol
        worst[name] = e_p
        parts.append(f"{name} {e_p:.2e}/{e_d:.2e} tol {tol:.2e}")
    say(f"[k2k3] {label:<34} vs plain/vanilla: {'  '.join(parts)}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[k2k3] {label} outside tolerance")
    return worst


def phase_k2k3(seed: int) -> dict:
    """Returns K2's and K3's worst errors against the plain backward."""
    gen = torch.Generator().manual_seed(seed + 3)
    bf16, f32 = torch.bfloat16, torch.float32
    say("[k2k3] tolerance: fp32 absolute 1e-4 (the source repo's backward tier); bf16/fp16 2e-2 x max |grad| of "
        "the fp32 reference, since P and dS are rounded to the 16-bit type before their products")
    runs = [
        check_grads("gpt2 train b4 h12 L1024 D64 bf16", gen, 4, 12, 12, 1024, 1024, 64, bf16),
        *(check_grads(f"b2 h12 L{L} D64 bf16", gen, 2, 12, 12, L, L, 64, bf16) for L in (40, 200)),
        check_grads("fp32 b1 h4 L384 D64", gen, 1, 4, 4, 384, 384, 64, f32),
        check_grads("gqa hq8 hkv2 L384 D128 bf16", gen, 1, 8, 2, 384, 384, 128, bf16),
        check_grads("lq<lkv q128 kv384 D64 bf16", gen, 2, 12, 12, 128, 384, 64, bf16),
        check_grads("non-causal L200 D64 bf16", gen, 2, 12, 12, 200, 200, 64, bf16, causal=False),
        check_grads("window 128 L512 D64 bf16", gen, 2, 12, 12, 512, 512, 64, bf16, window=128),
        check_grads("3 segments L512 D64 bf16", gen, 2, 12, 12, 512, 512, 64, bf16, segments=True),
        check_grads("lse cotangent fp32 b1 h4 L300 D64", gen, 1, 4, 4, 300, 300, 64, f32, with_lse=True),
        check_grads("lse cotangent b2 h12 L256 D64 bf16", gen, 2, 12, 12, 256, 256, 64, bf16, with_lse=True),
        check_grads("fp32 gqa hq4 hkv2 L200 D128 window 64", gen, 1, 4, 2, 200, 200, 128, f32, window=64),
        check_grads("fp16 b2 h12 L300 D64", gen, 2, 12, 12, 300, 300, 64, torch.float16),
    ]
    return {
        "flash_bwd_dkv": max(max(r["dk"], r["dv"]) for r in runs),
        "flash_bwd_dq": max(r["dq"] for r in runs),
    }


def phase_serving(seed: int) -> None:
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

    for key in FA.KERNEL_LAUNCHES:
        FA.KERNEL_LAUNCHES[key] = 0
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


def phase_training(seed: int, smi: str, data: np.ndarray) -> dict:
    """GPT-2 124M through the port's Trainer: returns the kernels' launch
    counts over the run."""
    cfg = GPT2_124M  # bf16 compute, dropout 0; Trainer keeps fp32 master weights
    steps, batch, seq = 20, 8, 1024
    tcfg = TrainerConfig(max_iters=steps, log_interval=1, learning_rate=6e-4, warmup_iters=5)
    trainer = Trainer(cfg, tcfg, seed=seed, device="cuda")
    batches = batch_iterator(data, batch, seq, seed=seed, device="cuda")
    for key in FA.KERNEL_LAUNCHES:
        FA.KERNEL_LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    history = trainer.fit(batches, log=lambda line: None)
    torch.cuda.synchronize()
    launches = dict(FA.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [r["train_loss"] for r in history]
    say(f"[training] GPT-2 124M {cfg.dtype} compute, fp32 master weights, vocab {cfg.vocab_size}, "
        f"{cfg.n_layer} layers; synthetic_corpus char ids at b{batch} x T{seq}, {steps} steps, lr 6e-4, warmup 5")
    say(f"[training] losses {' '.join(f'{x:.3f}' for x in losses)}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[training] {len(losses)} losses, not all finite")
    last5 = float(np.mean(losses[-5:]))
    ok = last5 < losses[0] - 1.0
    say(f"[training] mean of the last 5 losses {last5:.3f} vs first {losses[0]:.3f} - 1.0 nat: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[training] loss did not fall by more than 1 nat")
    want = cfg.n_layer * steps
    for key in KERNELS:
        if launches[key] != want:
            raise AssertionError(f"[training] {key} launched {launches[key]} times, want {cfg.n_layer} x {steps} = {want}")
    say(f"[training] launches {launches} = {cfg.n_layer} layers x {steps} steps each")
    step_ms = np.diff([0.0] + [r["wall_s"] for r in history]) * 1e3
    med = float(np.median(step_ms[5:]))
    say(f"[training] {smi} | step {med:.2f} ms (median of steps 6-{steps}), {batch * seq / med * 1e3:.0f} tokens/s, "
        f"peak allocated {peak / 2**30:.2f} GiB")
    return launches


def phase_train_parity(seed: int, data: np.ndarray) -> None:
    cfg = dataclasses.replace(GPT2_124M, dtype=torch.float32)
    tcfg = TrainerConfig(max_iters=5, log_interval=1, learning_rate=6e-4, warmup_iters=2)
    curves = {}
    for flash in (True, False):
        trainer = Trainer(dataclasses.replace(cfg, use_flash=flash), tcfg, seed=seed + 4, device="cuda")
        history = trainer.fit(batch_iterator(data, 2, 512, seed=seed + 4, device="cuda"), log=lambda line: None)
        curves[flash] = np.array([r["train_loss"] for r in history])
        del trainer
    flash, dense = curves[True], curves[False]
    excess = np.abs(flash - dense) - (2e-3 + 2e-3 * np.abs(dense))
    ok = len(flash) == 5 and bool((excess <= 0).all())
    say(f"[train-parity] fp32 GPT-2 124M b2 x T512, 5 steps from the same weights and batches: flash "
        f"{' '.join(f'{x:.5f}' for x in flash)} vs dense {' '.join(f'{x:.5f}' for x in dense)}; "
        f"max |diff| {np.abs(flash - dense).max():.2e} (atol 2e-3 + rtol 2e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[train-parity] flash and dense losses disagree")


def phase_timing(seed: int, smi: str) -> dict:
    """Kernels against their plain versions at GPT-2 shapes; returns
    {kernel: (ms, plain_ms)} at b8."""
    gen = torch.Generator().manual_seed(seed + 2)
    result = {}
    for b in (1, 8):
        q, k, v, do = (_rand(gen, (b, 12, 1024, 64), torch.bfloat16) for _ in range(4))
        with torch.no_grad():
            kern = time_ms(lambda: FA.flash_attention(q, k, v))
            plain = time_ms(lambda: FA.flash_attention_reference(q, k, v))
            dense = time_ms(lambda: vanilla_attention_with_lse(q, k, v, sm_scale=0.125))
            sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4 * b * 12 * 1024 * 1024 * 64 / 2  # causal half of QK^T and PV
        say(f"[timing] {smi} | K1 b{b} h12 L1024 D64 bf16 causal: kernel {kern:.4f} ms "
            f"({flops / kern / 1e9:.1f} TFLOP/s), plain tile loop {plain:.4f} ms, vanilla {dense:.4f} ms; "
            f"yardstick torch SDPA {sdpa:.4f} ms")

        # one backward: K2 + K3 (+ the di reduction), the plain backward,
        # autograd of vanilla, and torch SDPA's backward as a yardstick
        with torch.no_grad():
            o, lse = FA.flash_attention_with_lse(q, k, v)
        spec = FA._Spec(causal=True, sm_scale=0.125, window=None, blocks=FA.default_blocks(1024, 1024, 64))
        args = FA._bwd_args(q, k, v, o, lse, do, None, spec, None)
        k2 = time_ms(lambda: FA._launch_bwd_dkv(args))
        k3 = time_ms(lambda: FA._launch_bwd_dq(args))
        bwd = time_ms(lambda: FA._launch_bwd(q, k, v, o, lse, do, None, spec, None))
        with torch.no_grad():
            p2 = time_ms(lambda: FA.flash_attention_bwd_dkv_reference(q, k, v, o, lse, do))
            p3 = time_ms(lambda: FA.flash_attention_bwd_dq_reference(q, k, v, o, lse, do))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out_v = vanilla_attention_with_lse(qg, kg, vg, sm_scale=0.125)[0]
        van = time_ms(lambda: torch.autograd.grad(out_v, (qg, kg, vg), do, retain_graph=True))
        out_s = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa_b = time_ms(lambda: torch.autograd.grad(out_s, (qg, kg, vg), do, retain_graph=True))
        flops_b = 2.5 * flops  # five products of the forward's size, causal half
        say(f"[timing] {smi} | backward b{b} h12 L1024 D64 bf16 causal: K2+K3+di {bwd:.4f} ms "
            f"({flops_b / bwd / 1e9:.1f} TFLOP/s; K2 {k2:.4f} ms, K3 {k3:.4f} ms), plain {p2 + p3:.4f} ms "
            f"(dK/dV {p2:.4f}, dQ {p3:.4f}), autograd of vanilla {van:.4f} ms; yardstick torch SDPA backward "
            f"{sdpa_b:.4f} ms")
        result = {"flash_fwd": (kern, plain), "flash_bwd_dkv": (k2, p2), "flash_bwd_dq": (k3, p3)}
    return result


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    name, smi = phase_device()
    phase_build()
    errors = {"flash_fwd": phase_k1(args.seed), **phase_k2k3(args.seed)}
    phase_serving(args.seed)
    phase_parity(args.seed)
    text = synthetic_corpus()
    data = CharTokenizer(text).encode(text)
    launches = phase_training(args.seed, smi, data)
    phase_train_parity(args.seed, data)
    times = phase_timing(args.seed, smi)
    say(json.dumps({"kernels": [
        {"name": key, "route": "cuda", "source": src, "replaces": rep, "launches": launches[key],
         "max_abs_err": errors[key], "ms": times[key][0], "plain_ms": times[key][1]}
        for key, (src, rep) in KERNELS.items()
    ]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
