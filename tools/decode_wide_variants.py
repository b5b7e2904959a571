"""Time variants of the decode kernels (K6 over one slot-major layer), each
variant built alone, to see where a step's time goes.

    python3 tools/decode_wide_variants.py [--kernel wide|tiles|narrow] [--tree DIR] [--variants base,timeline,...]
                                          [--shapes d512,d1024] [--q bf16|fp32] [--one-split]
                                          [--clusters 1,2,4] [--chunk N]

`--kernel narrow` takes `csrc/decode_narrow.cuh` (head dims 8-32 at groups
of up to 8) at the d32 / d32_gqa4 shapes below, with the variants below and
its own: nosoftmax (the per-tile softmax skipped), st2 / st3 / st4 / st6 (a
ring of that many stages), w8 (8 warps a block: with `--chunk 256`);
`--clusters` runs the listed cluster sizes (wide and narrow) in place of the
split's choice, with chunks of `--chunk` tokens if given.  `--one-split`
(tiles) adds a run at one split a pair, which has no merge; the tiles kernel
has a nosoftmax variant too.

`--kernel wide` (the default) takes `csrc/decode_wide.cuh`, the cluster
kernel that runs every decode call at padded D512 / D1024; `--kernel tiles`
takes the group-tile kernel of `csrc/decode.cuh` as a checkout that still
instantiates it at D512 / D1024 has it (`--tree`, required with tiles:
that checkout, e.g. a parent from before the wide kernel unpacked under
`build/parent`; it measured the layout the wide kernel replaced, PERF.md
§6).  Each
variant is a copy of the headers under `build/wide_variants/<kernel>-<name>/`
with a few lines replaced (the replaced text must match the header, or the
tool stops), compiled with a small launcher into its own library (its
symbols hidden, so that the variants' kernels do not clash in one process);
every variant runs the same inputs:

* base: the header as it is;
* timeline: base with `%globaltimer` stamps (thread 0 of every block),
  printed as medians over the blocks of a launch that reach each stamp, in
  us after the launch's first block entered, with the launch's span and the
  gap between launches.  tiles: entry, tile 0 landed, tile 0's barrier,
  the last tile's barrier, the block's loop done, its state written (to the
  workspace, or the output when it is the only live split), the last
  block's merge begun and ended.  wide: entry, stage 0's K landed, stage
  0's S exchanged, stage 0's V landed, the stages done, the block's state
  written (the cluster's merge begins), exit;
* nocompute: S and P V skipped (copies, barriers and the merge kept);
* nocopy: the payload's copies skipped (compute on what the ring holds);
* wide only: pace (thread 0's stamps as it finds stages 0-7's K landed, in
  us after the launch's first such stamp: the pace of a block's stream).

Shapes (`--shapes`): `chip_smoke.NEW_DECODE_SHAPES`' d512 and d1024 rows
(8 slots, GQA 8/2, contexts in the last 128 tokens of 2048, 4 layers walked
in a CUDA graph with one call a layer, so that each call finds its layer
out of L2), on caches in q's dtype and int8, at bf16 q or (`--q fp32`) fp32
q; with `--kernel tiles` also SantaCoder's layer (santacoder: 24 layers, 16
q heads on one KV head of 128, two group tiles of 8; santacoder8: the same
with 8 q heads, one tile, so that the difference is the second tile's
re-read) and Falcon-40B's (falcon40b: 8 layers, GQA 128/8 at D64), which
the group tiles run with fp32 q at groups above 8 in a checkout from before
the whole-group kernel took fp32 q (this tree's decode.cuh is that kernel
at D64 / D128); and the GQA groups above 8 at D256 and D32 that the group
tiles run in a checkout from before the whole-group kernel took those head
dims: RecurrentGemma-2B's layer (recurrentgemma2b: 8 layers, 10 q heads on
one KV head of 256, two tiles of 5; recurrentgemma2b5 with 5 q heads, one
tile), PaLM-8B's (palm8b: 16 q heads of 256 on one KV head; palm8b8 with
8) and a multi-query layer at D32 (d32_mqa: 32 layers of 32 slots of 1024,
16 q heads on one KV head; d32_mqa8 with 8), and the d32 (3 layers of 32 slots
of 1024, 16 heads of 32) and d32_gqa4 (8 layers, 16 q heads on 4 KV heads) rows
of `chip_smoke.NEW_DECODE_SHAPES`.  tiles runs at two splits, K6's own (`decode_split`
over 16-token tiles) and K5's (chunks of a 128-token page), to see what the
split costs; wide at the cluster `decode_cluster_split` picks from the card's
resident clusters.  Device ms a call from `utils.measure.graph_ms`; the
error against an fp32 plain decode beside each (a variant that skips work is
wrong on purpose).  Compare variants within one call only.
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
PA = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")
from flash_attention_tpu_torch.utils.measure import graph_ms  # noqa: E402

OUT = os.path.join(ROOT, "build", "wide_variants")
MAX_BLOCKS = 4096  # stamp rows a launch

_STAMP = ("__device__ __forceinline__ unsigned long long gtime() {\n"
          "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
          "#define FA_T(k) if (threadIdx.x == 0) p.times[((p.tag * 4096) + (blockIdx.z * gridDim.y + blockIdx.y) * "
          "gridDim.x + blockIdx.x) * 8 + k] = gtime();\n")
_PARAMS = ("  float q_scale, score_scale;\n};", "  float q_scale, score_scale;\n  int tag;\n  unsigned long long* times;\n};")
_COMMON = '''
// K6 over one slot-major layer, q of type QT.
extern "C" __attribute__((visibility("default"))) int variant_decode(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* lengths, void* out,
    void* ws, void* counters, int int8, int d, int slots, int hq, int hkv, int max_len, int cluster, int chunk,
    int splits, const long long* st, float sm_scale, void* stream, int tag, void* times, int* resident) {
  P p{};
  p.q = q; p.k = k; p.v = v; p.ks = (const float*)ks; p.vs = (const float*)vs; p.lengths = (const int*)lengths;
  p.o = out; p.page_size = max_len; p.pages_per_seq = 1; p.len_add = 1; p.chunk = chunk;
  p.q_scale = sm_scale; p.score_scale = 1.f;
  p.q_sb = st[0]; p.q_sh = st[1]; p.o_sb = st[2]; p.o_sh = st[3];
  p.k_sh = st[4]; p.k_sp = st[5]; p.k_sr = st[6]; p.v_sh = st[7]; p.v_sp = st[8]; p.v_sr = st[9];
  p.s_sh = st[10]; p.s_sp = st[11];
  p.group = hq / hkv; p.head_dim = d;
#ifdef FA_TIMELINE
  p.tag = tag; p.times = (unsigned long long*)times;
#endif
  cudaStream_t s = (cudaStream_t)stream;
  SETUP
  DISPATCH
  return (int)cudaErrorInvalidValue;
}
'''


def _dispatch(dims) -> str:
    """The launcher's dispatch on the padded head dim, for the dims run."""
    return "\n  ".join(f"if (d <= {D} && d > {D // 2}) return int8 ? run<int8_t, {D}>(p, cluster, splits, hkv, slots, s, "
                       f"resident) : run<QT, {D}>(p, cluster, splits, hkv, slots, s, resident);" for D in dims)

KERNELS = {
    # decode.cuh's group tiles (as a checkout that still runs D512 / D1024 has them, or at
    # D64 / D128): a block of 4 warps a (sequence, KV head, group tile of up to 8 q heads,
    # split), column slabs above D128
    "tiles": dict(
        header="decode.cuh",
        launcher='#include "decode.cuh"\nusing namespace fa::decode;\nusing P = DecodeParams;\n'
                 "template <typename KV, int D>\n"
                 "cudaError_t run(const P& p, int, int splits, int hkv, int slots, cudaStream_t s, int*) {\n"
                 "  return launch_rows<QT, KV, D, false>(p, dim3(hkv * p.gtiles, slots, splits), s);\n}\n"
                 + _COMMON.replace("SETUP", "p.ws = (float*)ws; p.counters = (int*)counters; p.splits = splits; "
                                   "p.gtiles = (hq / hkv + 7) / 8; p.rows = (hq / hkv + p.gtiles - 1) / p.gtiles;"),
        timeline=[
            _PARAMS,
            ("template <typename T, typename KV, int D, int kMaxG, bool kPaged>\n__global__",
             _STAMP + "template <typename T, typename KV, int D, int kMaxG, bool kPaged>\n__global__"),
            ("  const int c0 = split * p.chunk;\n", "  const int c0 = split * p.chunk;\n  FA_T(0)\n"),
            ("    const unsigned char* sK = ring + stage * L::kStage;\n",
             "    if (j == 0) FA_T(1)\n    const unsigned char* sK = ring + stage * L::kStage;\n"),
            ("    else __syncwarp();\n\n    // One online-softmax step",
             "    else __syncwarp();\n    if (j == 0) FA_T(2)\n    if (j == mytiles - 1) FA_T(3)\n\n"
             "    // One online-softmax step"),
            ("  cp_async_wait<0>();\n\n  // Sum the warp's", "  FA_T(4)\n  cp_async_wait<0>();\n\n  // Sum the warp's"),
            ("  if (live == 1) return;\n", "  FA_T(5)\n  if (live == 1) return;\n"),
            ("  if (!sTable[0]) return;\n", "  if (!sTable[0]) return;\n  FA_T(6)\n"),
            ("  if (tid == 0) p.counters[pair] = 0;", "  FA_T(7)\n  if (tid == 0) p.counters[pair] = 0;"),
        ],
        stamps=("entry", "tile 0 landed", "tile 0 barrier", "last tile barrier", "loop done", "state written",
                "merge begun", "merge ended"),
        nocompute=[
            ("      for (int pass = 0; pass < kTile / kTokPass; ++pass) {",
             "      for (int pass = 0; pass < 0; ++pass) {"),
            ("    for (int i = 0; i < kTile / kSub; ++i) {\n      const int tok = psub + i * kSub;",
             "    for (int i = 0; i < 0; ++i) {\n      const int tok = psub + i * kSub;"),
            ("      for (int ks = 0; ks < W::kCols / 16; ++ks) {\n        uint32_t a[4];",
             "      for (int ks = 0; ks < 0; ++ks) {\n        uint32_t a[4];"),
        ],
        nosoftmax=[
            ("    for (int i = 0; i < kRows2; ++i) {\n      const int g = min(half + 2 * i, kMaxG - 1);",
             "    for (int i = 0; i < 0; ++i) {\n      const int g = min(half + 2 * i, kMaxG - 1);"),
        ],
        nocopy=[
            ("      cp_async<W::kCopy>(dk + r * L::kRow + ((in / 16) ^ swz(r)) * 16 + in % 16, gk + ko, ok ? bytes : 0);\n"
             "      cp_async<W::kCopy>(dv + r * L::kRow + in, gv + vo, ok ? bytes : 0);\n", ""),
        ],
    ),
}
KERNELS["narrow"] = dict(
    header="decode_narrow.cuh",
    launcher='#include "decode_narrow.cuh"\nusing namespace fa::decode;\nusing P = GroupParams;\n'
             "template <typename KV, int D>\n"
             "cudaError_t run(const P& p0, int cluster, int walks, int hkv, int slots, cudaStream_t s, int* r) {\n"
             "  P p = p0;\n  p.walks = walks;\n  p.passes = 1;\n  p.pass_rows = p.group;\n"
             "  return narrow_launch_rows<QT, KV, false>(p, cluster, dim3(cluster, hkv, slots), s, r);\n}\n"
             + _COMMON.replace("SETUP", ""),
    timeline=[
        ("decode_cluster.cuh",) + _PARAMS,
        ("template <typename T, typename KV, int kG, bool kPaged>\n__global__",
         _STAMP + "template <typename T, typename KV, int kG, bool kPaged>\n__global__"),
        ("  const int len = p.lengths[b];\n", "  FA_T(0)\n  const int len = p.lengths[b];\n"),
        ("    __syncwarp();  // the tile has landed", "    if (j == 0) FA_T(1)\n    __syncwarp();  // the tile has landed"),
        ("  cp_async_wait<0>();\n\n  // The warp's state", "  FA_T(2)\n  cp_async_wait<0>();\n\n  // The warp's state"),
        ("  M::template merge_groups<kNThreads>(smem, G, tid);\n", "  M::template merge_groups<kNThreads>(smem, G, tid);\n"
         "  FA_T(3)\n"),
        ("    return;\n  }\n  cluster_merge", "    FA_T(4)\n    return;\n  }\n  cluster_merge"),
        ("p.o_sh);\n}\n\ntemplate <typename T, typename KV, int kG, bool kPaged>\ncudaError_t narrow_launch_one",
         "p.o_sh);\n  FA_T(4)\n}\n\ntemplate <typename T, typename KV, int kG, bool kPaged>\ncudaError_t narrow_launch_one"),
    ],
    stamps=("entry", "tile 0 landed (thread 0's warp)", "warp 0's tiles done", "block merged", "exit"),
    nocompute=[
        ("    for (int cg = 0; cg < 4; ++cg) {", "    for (int cg = 0; cg < 0; ++cg) {"),
        ("    for (int i = 0; i < ncols; ++i) {", "    for (int i = 0; i < 0; ++i) {"),
    ],
    nocopy=[
        ("    for (int m = 0; m < per_row; ++m) {", "    for (int m = 0; m < 0; ++m) {"),
    ],
    nosoftmax=[
        ("    for (int g = 0; g < kG; ++g) {\n      const float x = valid", "    for (int g = 0; g < 0; ++g) {\n"
         "      const float x = valid"),
    ],
    # design variants: 2, 3 and 4 stages a ring
    st2=[("kStages = sizeof(KV) == 1 ? 4 : sizeof(KV) == 2 ? 2 : 3;", "kStages = 2;")],
    st3=[("kStages = sizeof(KV) == 1 ? 4 : sizeof(KV) == 2 ? 2 : 3;", "kStages = 3;")],
    st4=[("kStages = sizeof(KV) == 1 ? 4 : sizeof(KV) == 2 ? 2 : 3;", "kStages = 4;")],
    st6=[("kStages = sizeof(KV) == 1 ? 4 : sizeof(KV) == 2 ? 2 : 3;", "kStages = 6;")],
    # 8 warps a block (chunks of 256 tokens at least: run with --chunk 256)
    w8=[("constexpr int kNThreads = 128;", "constexpr int kNThreads = 256;")],
)
KERNELS["wide"] = dict(
    header="decode_wide.cuh",
    launcher='#include "decode_wide.cuh"\nusing namespace fa::decode;\nusing P = WideParams;\n'
             "template <typename KV, int D>\n"
             "cudaError_t run(const P& p0, int cluster, int walks, int hkv, int slots, cudaStream_t s, int* r) {\n"
             "  P p = p0;\n  p.walks = walks;\n  p.passes = 1;\n  p.pass_rows = p.group;\n"
             "  return wide_launch_one<QT, KV, D, 4, false>(p, cluster, dim3(cluster, hkv, slots), s, r);\n}\n"
             + _COMMON.replace("SETUP", ""),
    timeline=[
        _PARAMS,
        ("template <typename T, typename KV, int D, int kMaxG, bool kPaged>\n__global__",
         _STAMP + "template <typename T, typename KV, int D, int kMaxG, bool kPaged>\n__global__"),
        ("  const int len = p.lengths[b];\n", "  FA_T(0)\n  const int len = p.lengths[b];\n"),
        ("      sm90::mbar_wait(full + sk, (fk / NS) & 1);\n",
         "      sm90::mbar_wait(full + sk, (fk / NS) & 1);\n      if (j == 0) FA_T(1)\n"),
        ("      sm90::named_bar_sync(1, kWConsumers * 32);     // every slab's partial S is in\n",
         "      sm90::named_bar_sync(1, kWConsumers * 32);     // every slab's partial S is in\n      if (j == 0) FA_T(2)\n"),
        ("      sm90::mbar_wait(full + sv, (fv / NS) & 1);\n",
         "      sm90::mbar_wait(full + sv, (fv / NS) & 1);\n      if (j == 0) FA_T(3)\n"),
        ("  __syncthreads();  // the ring is free", "  FA_T(4)\n  __syncthreads();  // the ring is free"),
        ("  cluster_merge<T, kWThreads, D>(", "  FA_T(5)\n  cluster_merge<T, kWThreads, D>("),
        ("                                 p.o_sh);\n}", "                                 p.o_sh);\n  FA_T(6)\n}"),
    ],
    stamps=("entry", "stage 0 K landed", "stage 0 S exchanged", "stage 0 V landed", "stages done",
            "state written", "exit"),
    nocompute=[
        ("sk * L::kSlot + slab_off;\n      if (slab_live) {", "sk * L::kSlot + slab_off;\n      if (false) {"),
        ("sv * L::kSlot + slab_off;\n      if (slab_live) {", "sv * L::kSlot + slab_off;\n      if (false) {"),
    ],
    nocopy=[
        ("mbar_expect_tx(full + slot, (tend - t0) * row_bytes);", "mbar_expect_tx(full + slot, 0);"),
        ("        bulk_copy(ring + slot", "        if (false) bulk_copy(ring + slot"),
    ],
    # thread 0's stamps as it finds stages 0-7's K landed: the pace of a block's stream
    pace=[
        _PARAMS,
        ("template <typename T, typename KV, int D, int kMaxG, bool kPaged>\n__global__",
         _STAMP + "template <typename T, typename KV, int D, int kMaxG, bool kPaged>\n__global__"),
        ("      sm90::mbar_wait(full + sk, (fk / NS) & 1);\n",
         "      sm90::mbar_wait(full + sk, (fk / NS) & 1);\n      if (j < 8) FA_T(j)\n"),
    ],
    pace_stamps=tuple(f"stage {j} K landed" for j in range(8)),
)

VARIANT_NAMES = ("base", "timeline", "nocompute", "nocopy")  # and, tiles only, nosoftmax
SHAPES = {"d512": (4, 8, 8, 2, 512, 2048), "d1024": (4, 8, 8, 2, 1024, 2048),
          "santacoder": (24, 8, 16, 1, 128, 2048), "santacoder8": (24, 8, 8, 1, 128, 2048),
          "falcon40b": (8, 8, 128, 8, 64, 2048),
          "recurrentgemma2b": (8, 8, 10, 1, 256, 2048), "recurrentgemma2b5": (8, 8, 5, 1, 256, 2048),
          "palm8b": (8, 8, 16, 1, 256, 2048), "palm8b8": (8, 8, 8, 1, 256, 2048),
          "d32_mqa": (32, 32, 16, 1, 32, 1024), "d32_mqa8": (32, 32, 8, 1, 32, 1024),
          "d32": (3, 32, 16, 16, 32, 1024), "d32_gqa4": (8, 32, 16, 4, 32, 1024)}
Q_TYPES = {"bf16": ("__nv_bfloat16", torch.bfloat16), "fp32": ("float", torch.float32)}


def build(kernel: str, tree: str, names: list[str], q: str, dims) -> dict:
    """Every variant's library, compiled in parallel."""
    spec = KERNELS[kernel]
    csrc = os.path.join(tree, "flash_attention_tpu_torch", "csrc")
    procs = {}
    for name in names:
        d = os.path.join(OUT, f"{kernel}-{name}")
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(csrc):
            if not f.endswith(".cuh"):
                continue
            src = open(os.path.join(csrc, f)).read()
            # a replacement is (old, new) in the kernel's header or (file, old, new)
            for rep in spec.get(name, []):
                target, old, new = rep if len(rep) == 3 else (spec["header"], *rep)
                if f == target:
                    if old not in src:
                        raise RuntimeError(f"variant {name}: {f} no longer has {old[:60]!r}")
                    src = src.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(src)
        with open(os.path.join(d, "launcher.cu"), "w") as fh:
            fh.write(f"#define QT {Q_TYPES[q][0]}\n" + spec["launcher"].replace("DISPATCH", _dispatch(dims)))
        flags = ["-DFA_TIMELINE"] if name in ("timeline", "pace") else []
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *flags, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC,-fvisibility=hidden", "-o", f"{d}/lib.so",
             f"{d}/launcher.cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{kernel}-{name}", "lib.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.variant_decode.argtypes = ([P] * 9 + [I] * 9 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, P, I, P,
                                                            ctypes.POINTER(I)])
        lib.variant_decode.restype = I
        libs[name] = lib
    return libs


def splits(kernel: str, libs: dict, int8: int, d: int, slots: int, hq: int, hkv: int, L: int,
           itemsize: int, one_split: bool = False) -> list[tuple]:
    """(label, cluster, chunk, splits or walks) of each run; tiles with
    `one_split` also one block a (sequence, KV head, group tile): no merge."""
    if kernel == "tiles":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = PA.group_tiles(hq // hkv)[0]
        out = []
        for label, unit in (("K6 split", PA.DECODE_TILE), ("K5 split", 128)):
            chunk, n = PA.decode_split(L, slots * hkv * tiles, unit, sms)
            out.append((f"{label} {n} x {chunk}", 1, chunk, n))
        if one_split:
            out.append((f"one split 1 x {L}", 1, L, 1))
        return out
    lib = next(iter(libs.values()))
    resident = {}
    for c in range(1, PA.CLUSTER_MAX + 1):
        r = ctypes.c_int(0)
        err = lib.variant_decode(None, None, None, None, None, None, None, None, None, int8, d, slots, hq, hkv, L, c,
                                 0, 0, (ctypes.c_longlong * 12)(), 1.0, None, 0, None, ctypes.byref(r))
        if err:
            raise RuntimeError(f"occupancy query failed with cudaError {err}")
        resident[c] = r.value
    tokens = PA.NARROW_TOKENS if kernel == "narrow" else PA.wide_tokens(d, 1 if int8 else itemsize)
    cl, chunk, walks = PA.decode_cluster_split(L, slots * hkv, tokens, resident, False, tokens)
    return [(f"cluster {cl} x {walks} chunks of {chunk} (resident {resident})", cl, chunk, walks)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="wide", choices=sorted(KERNELS))
    ap.add_argument("--tree", default=ROOT, help="the checkout whose headers are built")
    ap.add_argument("--variants", default=",".join(VARIANT_NAMES))
    ap.add_argument("--shapes", default="d512,d1024", help=f"comma-separated, of {', '.join(SHAPES)}")
    ap.add_argument("--q", default="bf16", choices=sorted(Q_TYPES))
    ap.add_argument("--one-split", action="store_true", help="tiles: also run one split a pair (no merge)")
    ap.add_argument("--clusters", default="", help="wide / narrow: run these cluster sizes (comma-separated) in place "
                    "of the split's choice, its chunk kept")
    ap.add_argument("--chunk", type=int, default=0, help="with --clusters: chunks of this many tokens")
    args = ap.parse_args()
    shapes = args.shapes.split(",")
    wide_dims = any(SHAPES[s][4] > 256 for s in shapes)
    if args.kernel == "tiles" and wide_dims and os.path.abspath(args.tree) == ROOT:
        ap.error("--kernel tiles at D512 / D1024 needs --tree: a checkout whose decode.cuh still runs them (before "
                 "the wide kernel), e.g. a parent unpacked under build/parent")
    if args.kernel == "wide" and not all(SHAPES[s][4] > 256 for s in shapes):
        ap.error("--kernel wide runs head dims above 256 only")
    if args.kernel == "narrow" and not all(SHAPES[s][4] <= 32 and SHAPES[s][2] // SHAPES[s][3] <= 8 for s in shapes):
        ap.error("--kernel narrow runs head dims 8-32 at groups of up to 8 only")
    names = args.variants.split(",")
    unknown = [v for v in names if v != "base" and v not in KERNELS[args.kernel]]
    if unknown:
        ap.error(f"--kernel {args.kernel} has no variants {unknown}")
    dims = sorted({512 if SHAPES[s][4] <= 512 and SHAPES[s][4] > 256 else
                   (1024 if SHAPES[s][4] > 512 else SHAPES[s][4]) for s in shapes})
    q_dtype = Q_TYPES[args.q][1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    libs = build(args.kernel, args.tree, names, args.q, dims)
    print(f"[variants] {smi} | {args.kernel}: {len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    max_layers = max(SHAPES[s][0] for s in shapes)
    times = torch.zeros(max_layers * MAX_BLOCKS * 8, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in shapes:
        layers, slots, hq, hkv, d, L = SHAPES[shape]
        for int8 in (0, 1):
            k = torch.randn(layers, hkv, slots, L, d, device="cuda", generator=gen)
            v = torch.randn(layers, hkv, slots, L, d, device="cuda", generator=gen)
            if int8:
                ks, vs = k.abs().amax(-1) / 127, v.abs().amax(-1) / 127
                k, v = (k / ks[..., None]).round().to(torch.int8), (v / vs[..., None]).round().to(torch.int8)
            else:
                k, v = k.to(q_dtype), v.to(q_dtype)
                ks = vs = torch.ones(layers, hkv, slots, L, device="cuda")
            lengths = torch.randint(L - 129, L - 1, (slots,), device="cuda", dtype=torch.int32, generator=gen)
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
            tiles, rows = PA.group_tiles(hq // hkv)
            runs = splits(args.kernel, libs, int8, d, slots, hq, hkv, L, q.element_size(), args.one_split)
            if args.clusters and args.kernel != "tiles":
                chunk = args.chunk or runs[0][2]
                runs = [(f"cluster {c} x {-(-L // (c * chunk))} chunks of {chunk} (forced)", c, chunk,
                         -(-L // (c * chunk))) for c in map(int, args.clusters.split(","))]
            for label, cl, chunk, n in runs:
                ws = torch.empty(slots * hkv * tiles * n * rows * (d + 2), device="cuda")
                counters = torch.zeros(slots * hkv * tiles, dtype=torch.int32, device="cuda")
                for name, lib in libs.items():
                    def call(i, lib=lib, cl=cl, chunk=chunk, n=n):
                        err = lib.variant_decode(
                            q.data_ptr(), k[i].data_ptr(), v[i].data_ptr(), ks[i].data_ptr() if int8 else None,
                            vs[i].data_ptr() if int8 else None, lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
                            counters.data_ptr(), int8, d, slots, hq, hkv, L, cl, chunk, n, st, d ** -0.5,
                            torch.cuda.current_stream().cuda_stream, i, times.data_ptr(), None)
                        if err:
                            raise RuntimeError(f"variant {name}: cudaError {err}")

                    call(0)
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs().max().item()
                    ms = graph_ms(lambda: [call(i) for i in range(layers)], calls=10, runs=5) / layers
                    print(f"[variants] {smi} | {shape} {args.q} q {'int8' if int8 else args.q} cache {args.kernel} "
                          f"{label} {name}: "
                          f"{ms * 1e3:.2f} us a call on the device, error {err:.2e}", flush=True)
                    if name in ("timeline", "pace"):
                        stamp_lines(call, layers, KERNELS[args.kernel]["stamps" if name == "timeline" else "pace_stamps"],
                                    times, max_layers)


def stamp_lines(call, layers: int, stamps: tuple, times: torch.Tensor, max_layers: int) -> None:
    """One graph replay of the layers with the stamps on; medians over the
    blocks of a launch that reached each stamp, in us after its first block
    entered."""
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
    t = times.view(max_layers, MAX_BLOCKS, 8)[:layers].cpu().numpy().astype(np.float64)
    t[t == 0] = np.nan
    first, last = np.nanmin(t[:, :, 0], axis=1), np.nanmax(t.reshape(layers, -1), axis=1)
    rel = (t - first[:, None, None]) / 1e3
    med = np.nanmedian(rel.reshape(-1, 8), axis=0)
    latest = np.nanmedian(np.nanmax(rel, axis=1), axis=0)
    reached = np.sum(~np.isnan(t[0]), axis=0)
    gap = np.median(first[1:] - last[:-1]) / 1e3
    print("[variants]   stamps (median / latest us after the launch's first entry; blocks reaching it): "
          + ", ".join(f"{name} {x:.2f} / {y:.2f} ({int(c)})" for name, x, y, c in zip(stamps, med, latest, reached))
          + f"; launch span {np.median(last - first) / 1e3:.2f} us, gap to the next launch {gap:.2f} us", flush=True)


if __name__ == "__main__":
    main()
