"""Time variants of the whole-group decode kernel (K6 of
`flash_attention_tpu_torch/csrc/decode_group.cuh`, or with `--q fp32` of
`decode_group_fp32.cuh`) at SantaCoder's and Falcon-40B's decode layers,
each variant built alone, to see where a step's time goes.

    python3 tools/decode_group_variants.py [--q bf16|fp32] [--variants base,timeline,...] [--clusters 8 2]

Each variant is a copy of the header under `build/group_variants/<name>/`
with a few lines replaced (the replaced text must match the header, or the
tool stops), compiled with a small launcher into its own library (its
symbols hidden, so that the variants' kernels do not clash in one
process); every variant runs the same inputs:

* base: the header as it is;
* timeline: base with `%globaltimer` stamps (thread 0 of every block):
  bf16 q: entry, stage 0 landed, its row maxima, its P, stage 1 landed, the
  stages done, the block's state written (the cluster's merge begins),
  exit; fp32 q: entry, stage 0 landed, stage 1 landed, the stages done, the
  token groups merged (the cluster's merge begins), exit; printed as
  medians over the blocks of a launch, in us after the launch's first block
  entered, with the gap between launches;
* nocompute: the stages' S, P and P V skipped (copies and barriers kept);
* nocopy: the payload's copies skipped (compute on what the ring holds);
* mergediv: the cluster's merge (`decode_cluster.cuh`) walking the
  run-time d's columns, a division by d an element, in place of D's;
* constd: the run-time head dim taken as the instantiated D, so that its
  column tests fold away (what they cost where d == D);
* bf16 q only: tok256: 256-token stages at D64 (chunks of 256); tok256q:
  256-token stages for an 8-bit payload;
* fp32 q only: stages3: 3 stages in the ring for an fp32 cache (2 by
  default: 192 KB in place of 128).

Shapes (24 / 4 layers walked in a CUDA graph, one call a layer, so each call
finds its layer out of L2): SantaCoder's layer (8 slots, 16 q heads on one
KV head of 128, contexts 1920-2047 of 2048) and Falcon-40B's (8 slots, GQA
128/8 at D64), on caches in q's dtype and int8, at the cluster sizes given (each
clamped to the chunks; `cudaOccupancyMaxActiveClusters` printed beside
each).  Device ms a call from `utils.measure.graph_ms`; the error against an
fp32 plain decode beside each (a variant that skips work is wrong on
purpose).  Compare variants within one call only.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from flash_attention_tpu_torch.utils.measure import graph_ms  # noqa: E402

PA = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")

CSRC = os.path.join(ROOT, "flash_attention_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "group_variants")

LAUNCHER = r'''
#include "HEADER"
using namespace fa::decode;
template <typename KV, int D>
cudaError_t run(const GroupParams& p, int cluster, dim3 grid, cudaStream_t s, int* resident) {
  return LAUNCH_ONE(p, cluster, grid, s, resident);
}
// K6 over one slot-major layer, q of type QT, one row tile (a group of up to 16).
extern "C" __attribute__((visibility("default"))) int variant_decode(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* lengths, void* out,
    int int8, int d, int slots, int hq, int hkv, int max_len, int cluster, int chunk, int walks,
    const long long* st, float sm_scale, void* stream, int tag, void* times, int* resident) {
  GroupParams p{};
  p.q = q; p.k = k; p.v = v; p.ks = (const float*)ks; p.vs = (const float*)vs; p.lengths = (const int*)lengths;
  p.o = out; p.page_size = max_len; p.pages_per_seq = 1; p.len_add = 1; p.chunk = chunk; p.walks = walks;
  p.q_scale = sm_scale; p.score_scale = 1.f;
  p.q_sb = st[0]; p.q_sh = st[1]; p.o_sb = st[2]; p.o_sh = st[3];
  p.k_sh = st[4]; p.k_sp = st[5]; p.k_sr = st[6]; p.v_sh = st[7]; p.v_sp = st[8]; p.v_sr = st[9];
  p.s_sh = st[10]; p.s_sp = st[11];
  p.group = hq / hkv; p.passes = 1; p.pass_rows = 16; p.head_dim = d;
#ifdef FA_TIMELINE
  p.tag = tag; p.times = (unsigned long long*)times;
#endif
  const dim3 grid(cluster, hkv, slots);
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return int8 ? run<int8_t, 128>(p, cluster, grid, s, resident) : run<QT, 128>(p, cluster, grid, s, resident);
  return int8 ? run<int8_t, 64>(p, cluster, grid, s, resident) : run<QT, 64>(p, cluster, grid, s, resident);
}
'''
# per q dtype: the header, its row-tile launch and q's C++ type
KERNELS = {
    "bf16": ("decode_group.cuh", "group_launch_one<__nv_bfloat16, KV, D, 1, false>", "__nv_bfloat16"),
    "fp32": ("decode_group_fp32.cuh", "group32_launch_one<KV, D, 1, false>", "float"),
}

_STAMP = ("__device__ __forceinline__ unsigned long long gtime() {\n"
          "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
          "#define FA_T(k) if (tid == 0) p.times[((p.tag * 1024) + (blockIdx.z * gridDim.y + blockIdx.y) * "
          "gridDim.x + blockIdx.x) * 8 + k] = gtime();\n")
_PARAMS = ("decode_group.cuh", "  float q_scale, score_scale;\n};",
           "  float q_scale, score_scale;\n  int tag;\n  unsigned long long* times;\n};")
# a variant: (file, old text, new text) replacements
TIMELINE = [
    _PARAMS,
    ("template <typename T, typename KV, int D, int kRW, bool kPaged>\n__global__",
     _STAMP + "template <typename T, typename KV, int D, int kRW, bool kPaged>\n__global__"),
    ("  const int len = p.lengths[b];\n", "  FA_T(0)\n  const int len = p.lengths[b];\n"),
    ("    int t0, tend, walk, c0;\n    stage_range(j, t0, tend, walk, c0);\n    const uint32_t k_base",
     "    if (j == 0) FA_T(1)\n    if (j == 1) FA_T(4)\n    int t0, tend, walk, c0;\n"
     "    stage_range(j, t0, tend, walk, c0);\n    const uint32_t k_base"),
    ("    __syncthreads();  // every sub-tile's row maxima are in",
     "    if (j == 0) FA_T(2)\n    __syncthreads();  // every sub-tile's row maxima are in"),
    ("    __syncthreads();  // P and the row sums are in\n", "    __syncthreads();  // P and the row sums are in\n"
     "    if (j == 0) FA_T(3)\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // the rings are free",
     "  FA_T(5)\n  cp_async_wait<0>();\n  __syncthreads();  // the rings are free"),
    ("  cluster_merge<T, kGThreads, D>(", "  FA_T(6)\n  cluster_merge<T, kGThreads, D>("),
    ("                                 p.o_sh);\n}", "                                 p.o_sh);\n  FA_T(7)\n}"),
]
TIMELINE_FP32 = [
    _PARAMS,
    ("template <typename KV, int D, int kRW, bool kPaged>\n__global__",
     _STAMP + "template <typename KV, int D, int kRW, bool kPaged>\n__global__"),
    ("  const int len = p.lengths[b];\n", "  FA_T(0)\n  const int len = p.lengths[b];\n"),
    ("    stage_range(j, t0, tend, walk, c0);\n\n    for (int u = tg;",
     "    stage_range(j, t0, tend, walk, c0);\n    if (j == 0) FA_T(1)\n    if (j == 1) FA_T(2)\n\n    for (int u = tg;"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // the ring is free",
     "  FA_T(3)\n  cp_async_wait<0>();\n  __syncthreads();  // the ring is free"),
    ("  cluster_merge<float, kGThreads, D>(", "  FA_T(4)\n  cluster_merge<float, kGThreads, D>("),
    ("                                     p.o_sh);\n}", "                                     p.o_sh);\n  FA_T(5)\n}"),
]
STAMPS = {"bf16": ("entry", "stage 0 landed", "its row maxima", "its P", "stage 1 landed", "stages done",
                   "state written", "exit"),
          "fp32": ("entry", "stage 0 landed", "stage 1 landed", "stages done", "token groups merged", "exit")}
# the cluster merge dividing by the run-time d in place of the instantiated D
MERGEDIV = [("decode_cluster.cuh",
             "  constexpr int kD4 = D / 4;\n  for (int e = rank * kThreads + tid; e < G * kD4; e += C * kThreads) {\n"
             "    const int g = e / kD4, c4 = e % kD4;\n    if (c4 * 4 >= d) continue;\n",
             "  const int d4 = d / 4;\n  for (int e = rank * kThreads + tid; e < G * d4; e += C * kThreads) {\n"
             "    const int g = e / d4, c4 = e % d4;\n")]
# the run-time head dim taken as the instantiated D (its column tests fold
# away; wrong where d < D)
CONSTD = [("  const int d = p.head_dim;                      // the columns past d are zero in q, K and V",
           "  constexpr int d = D;")]
VARIANTS = {
    "base": [],
    "timeline": TIMELINE,
    "nocompute": [
        ("      const bool live = rows_live && t0 + tok0 < tend;\n      float mx[2]",
         "      const bool live = false;\n      float mx[2]"),
        ("      const bool live = rows_live && t0 + tok0 < tend;\n      float ls[2]",
         "      const bool live = false;\n      float ls[2]"),
        ("    if (rows_live) {\n#pragma unroll\n      for (int h = 0; h < 2; ++h) {\n        float l = l_run",
         "    if (false) {\n#pragma unroll\n      for (int h = 0; h < 2; ++h) {\n        float l = l_run"),
    ],
    "nocopy": [
        ("        cp_async<16>(dk + i * kRowStep * L::kRow, ok ? sk + i * kstep : gk, ok ? 16 : 0);\n"
         "        cp_async<16>(dv + i * kRowStep * L::kRow, ok ? sv + i * vstep : gv, ok ? 16 : 0);\n", ""),
    ],
    "mergediv": MERGEDIV,
    "constd": CONSTD,
    "tok256": [("  static constexpr int kTok = 128;  ", "  static constexpr int kTok = D == 64 && kRW <= 2 ? 256 : 128;  ")],
    "tok256q": [("  static constexpr int kTok = 128;  ", "  static constexpr int kTok = kQuant ? 256 : 128;  ")],
}
VARIANTS_FP32 = {
    "base": [],
    "timeline": TIMELINE_FP32,
    "nocompute": [("      if (!rows_live || t0 + tok0 >= tend) break;", "      if (true) break;")],
    "nocopy": VARIANTS["nocopy"],
    "mergediv": MERGEDIV,
    "constd": CONSTD,
    "stages3": [("  static constexpr int kFit = 96 * 1024 / (2 * kStage);",
                 "  static constexpr int kFit = (kQuant ? 96 : 192) * 1024 / (2 * kStage);")],
}
# the stage tokens of a variant for a payload and head dim (its chunks)
STAGE = {"tok256": lambda d, int8: 256 if d == 64 else 128, "tok256q": lambda d, int8: 256 if int8 else 128}
SHAPES = {"santacoder": (24, 8, 16, 1, 128, 2048), "falcon40b": (4, 8, 128, 8, 64, 2048)}


def build(names: list[str], q: str) -> dict:
    """Every variant's library, compiled in parallel."""
    header, launch_one, qt = KERNELS[q]
    variants = VARIANTS_FP32 if q == "fp32" else VARIANTS
    procs = {}
    for name in names:
        d = os.path.join(OUT, f"{q}-{name}")
        os.makedirs(d, exist_ok=True)
        edits = [e if len(e) == 3 else (header,) + e for e in variants[name]]
        for f in os.listdir(CSRC):
            if not f.endswith(".cuh"):
                continue
            src = open(os.path.join(CSRC, f)).read()
            for where, old, new in edits:
                if where != f:
                    continue
                if old not in src:
                    raise RuntimeError(f"variant {name}: {f} no longer has {old[:60]!r}")
                src = src.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(src)
        with open(os.path.join(d, "launcher.cu"), "w") as fh:
            fh.write(f"#define QT {qt}\n"
                     + LAUNCHER.replace("HEADER", header).replace("LAUNCH_ONE", launch_one))
        flags = ["-DFA_TIMELINE"] if name == "timeline" else []
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *flags, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC,-fvisibility=hidden", "-o", f"{d}/lib.so",
             f"{d}/launcher.cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{q}-{name}", "lib.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.variant_decode.argtypes = [P] * 7 + [I] * 9 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, P, I, P,
                                                           ctypes.POINTER(I)]
        lib.variant_decode.restype = I
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--q", default="bf16", choices=sorted(KERNELS))
    ap.add_argument("--variants", default="")
    ap.add_argument("--clusters", type=int, nargs="+", default=[8, 2])
    args = ap.parse_args()
    names = (args.variants or ",".join(VARIANTS_FP32 if args.q == "fp32" else VARIANTS)).split(",")
    q_dtype = torch.float32 if args.q == "fp32" else torch.bfloat16
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    libs = build(names, args.q)
    print(f"[variants] {smi} | {len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    times = torch.zeros(32 * 1024 * 8, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (layers, slots, hq, hkv, d, L) in SHAPES.items():
        for int8 in (0, 1):
            k = torch.randn(layers, hkv, slots, L, d, device="cuda", generator=gen)
            v = torch.randn(layers, hkv, slots, L, d, device="cuda", generator=gen)
            if int8:
                ks, vs = k.abs().amax(-1) / 127, v.abs().amax(-1) / 127
                k, v = (k / ks[..., None]).round().to(torch.int8), (v / vs[..., None]).round().to(torch.int8)
            else:
                k, v = k.to(q_dtype), v.to(q_dtype)
                ks = vs = torch.ones(layers, hkv, slots, L, device="cuda")
            lengths = torch.randint(1919, 2047, (slots,), device="cuda", dtype=torch.int32, generator=gen)
            q = torch.randn(slots, hq, d, device="cuda", generator=gen).to(q_dtype)
            out = torch.empty_like(q)
            st = (ctypes.c_longlong * 12)(*q.stride()[:2], *out.stride()[:2], *k.stride()[1:4], *v.stride()[1:4],
                                          *ks.stride()[1:3])
            # the plain decode of layer 0 in fp32: q pre-scaled and rounded to its dtype as K6 does
            kf = k[0].float() * (ks[0][..., None] if int8 else 1)
            vf = v[0].float() * (vs[0][..., None] if int8 else 1)
            qq = (q.float() * d ** -0.5).to(q_dtype).float().view(slots, hkv, hq // hkv, d)
            sc = torch.einsum("shgd,hsld->shgl", qq, kf)
            live = torch.arange(L, device="cuda")[None, :] <= lengths[:, None].long()
            sc = torch.where(live[:, None, None, :], sc, -math.inf)
            ref = torch.einsum("shgl,hsld->shgd", torch.softmax(sc, -1), vf).reshape(slots, hq, d)
            for cluster in args.clusters:
                for name, lib in libs.items():
                    if args.q == "fp32":  # the stage of group_tokens, 3 of them in stages3's ring
                        chunk = PA.group_tokens(d, 1 if int8 else 4)
                    else:
                        chunk = STAGE.get(name, lambda d, int8: 128)(d, int8)
                    cl = min(cluster, -(-L // chunk))
                    walks = -(-L // (chunk * cl))

                    def call(i, lib=lib, cl=cl, chunk=chunk, walks=walks):
                        err = lib.variant_decode(
                            q.data_ptr(), k[i].data_ptr(), v[i].data_ptr(), ks[i].data_ptr() if int8 else None,
                            vs[i].data_ptr() if int8 else None, lengths.data_ptr(), out.data_ptr(), int8, d, slots, hq,
                            hkv, L, cl, chunk, walks, st, d ** -0.5, torch.cuda.current_stream().cuda_stream, i,
                            times.data_ptr(), None)
                        if err:
                            raise RuntimeError(f"variant {name}: cudaError {err}")

                    call(0)
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs().max().item()
                    ms = graph_ms(lambda: [call(i) for i in range(layers)], calls=10, runs=5) / layers
                    resident = ctypes.c_int(0)
                    lib.variant_decode(None, None, None, None, None, None, None, int8, d, slots, hq, hkv, L, cl, chunk,
                                       walks, st, 1.0, None, 0, None, ctypes.byref(resident))
                    print(f"[variants] {smi} | {shape} {args.q} q {'int8' if int8 else args.q} cache cluster {cl} {name}: "
                          f"{ms * 1e3:.2f} us a call on the device, error {err:.2e}; {resident.value} clusters of "
                          f"{cl} resident at once ({slots * hkv} needed)", flush=True)
                    if name == "timeline":
                        stamp_lines(call, layers, cl * hkv * slots, times, STAMPS[args.q])


def stamp_lines(call, layers: int, blocks: int, times: torch.Tensor, stamps: tuple) -> None:
    """One graph replay of the layers with the stamps on; medians over the
    blocks of a launch, in us after its first block entered."""
    times.zero_()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        for i in range(layers):
            call(i)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    n = len(stamps)
    t = times.view(32, 1024, 8)[:layers, :blocks, :n].cpu().numpy().astype(np.float64)
    first, last = t[:, :, 0].min(1), t[:, :, n - 1].max(1)
    rel = (t - first[:, None, None]) / 1e3
    med = np.median(rel.reshape(-1, n), axis=0)
    gap = np.median(first[1:] - last[:-1]) / 1e3
    print("[variants]   stamps (median us after the launch's first entry): "
          + ", ".join(f"{name} {x:.2f}" for name, x in zip(stamps, med))
          + f"; launch span {np.median(last - first) / 1e3:.2f} us, gap to the next launch {gap:.2f} us", flush=True)


if __name__ == "__main__":
    main()
