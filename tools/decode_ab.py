"""Time the decode kernels (K5 paged, K6 slot-major) and the quantized
serving engines of one checkout of the PyTorch port on the card, for an A/B
between checkouts.

    python3 tools/decode_ab.py <checkout dir> <label> [--cluster N]

Imports `flash_attention_tpu_torch` from <checkout dir>, builds its kernels
there (its own build/torch_kernels/), and prints lines of results, the last
`RESULT {json}`:

* K5 and K6 at every shape of this checkout's `chip_smoke.DECODE_SHAPES`
  (8 slots on one layer, L2-hot; GPT-2's 12 layers, a long context at 32
  slots and a Llama-shaped GQA layer, L2-cold; SantaCoder's and Falcon-40B's
  layers, which run the whole-group kernel where the checkout has it) and at
  `ONE_TILE_SHAPE`, on their caches: device ms a call, ms a call as the
  engine calls them, the plain versions, SDPA with a length mask on a bf16
  cache, the byte bound (`time_decode`);
* the serving-quant bursts of `chip_smoke.py` (GPT-2 124M, 16 requests; an
  int8 cache through K5 and an fp8 cache through K6): tokens/s each.

The shapes, the bursts and `time_decode` are this checkout's
`chip_smoke.py`, its timers the checkout's `utils.measure` (`graph_ms`,
`time_ms`, `floor_ms`), so the checkout must have `utils/measure.py`, and
two checkouts are measured alike where that file agrees.  Compare two
checkouts in one call, in turns (A, B, B, A): times on the host's clock
spread between calls and between processes, and one process cannot import
two checkouts' packages.

`--stores a,b` times only the rows on those caches (`chip_smoke.STORES`
names, e.g. `fp32,int8 fp32 q`), `--shapes a,b` only those rows: a
`chip_smoke.NEW_DECODE_SHAPES` name (e.g. `recurrentgemma2b,palm8b`) or
the start of another row's label (e.g. `llama,santacoder layer`), and
`--no-bursts` leaves out the serving bursts: a short call that measures a
few rows.

A row at a head dim the checkout's decode kernels do not take
(`paged_attention.HEAD_DIMS`: a parent from before a head dim ran) is
skipped, and says so.  Each row draws its data from a seed of its own
label and cache, so that the rows two checkouts share see the same data
whatever rows either skips or leaves out.

`--cluster N` (a checkout with cluster decode kernels) forces clusters of N
blocks (1-8) in place of the split's choice (`decode_cluster_split`, or
`decode_group_split` in a checkout from before it), the chunk kept: the
A/B of cluster sizes in one checkout.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import zlib

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("tree")
parser.add_argument("label")
parser.add_argument("--cluster", type=int, default=0, help="force the cluster decode kernels' clusters to this many blocks")
parser.add_argument("--stores", default="", help="time only the rows on these caches (comma-separated)")
parser.add_argument("--no-bursts", action="store_true", help="leave out the serving bursts")
parser.add_argument("--shapes", default="", help="time only these chip_smoke.NEW_DECODE_SHAPES rows (comma-separated)")
args = parser.parse_args()
tree, label = args.tree, args.label
sys.path.insert(0, os.path.abspath(tree))

import torch  # noqa: E402

# the checkout under test first: chip_smoke.py's own imports then resolve to it
FA = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
if not FA.__file__.startswith(os.path.abspath(tree)):
    raise RuntimeError(f"imported {FA.__file__}, not the checkout in {tree}")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from flash_attention_tpu_torch.kernels import _build  # noqa: E402

if args.cluster:
    PA = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")
    _name = "decode_cluster_split" if hasattr(PA, "decode_cluster_split") else "decode_group_split"
    _split = getattr(PA, _name)

    def _forced(capacity, pairs, unit, resident, paged, *tokens):
        _, chunk, _ = _split(capacity, pairs, unit, resident, paged, *tokens)
        chunks = -(-capacity // chunk)
        cluster = min(args.cluster, chunks)
        return cluster, chunk, -(-chunks // cluster)

    setattr(PA, _name, _forced)


def main() -> None:
    name, smi = smoke.phase_device()
    t0 = time.perf_counter()
    _build.library()
    res = {"label": label, "checkout": tree, "device": name, "smi": smi, "build_s": time.perf_counter() - t0,
           "cluster": args.cluster or "chosen"}
    stores = set(args.stores.split(",")) if args.stores else None
    shapes = smoke.DECODE_SHAPES + (smoke.ONE_TILE_SHAPE,)
    if args.shapes:
        shapes = tuple(smoke.NEW_DECODE_SHAPES.get(name) or next(s for s in shapes if s[0].startswith(name))
                       for name in args.shapes.split(","))
    head_dims = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention").HEAD_DIMS
    for shape in shapes:
        if shape[5] not in head_dims:
            print(label, shape[0], f"skipped: head dim {shape[5]} is not among this checkout's", flush=True)
            continue
        for store in shape[-1]:
            if stores is not None and store not in stores:
                continue
            gen = torch.Generator().manual_seed(zlib.crc32(f"{shape[0]} {store}".encode()))
            row = smoke.time_decode(gen, smi, shape, store)
            res[f"{shape[0]} {store}"] = row
            print(label, shape[0], store, {k: v if isinstance(v, str) else round(v, 5) for k, v in row.items()},
                  flush=True)
    if args.no_bursts:
        print("RESULT " + json.dumps(res), flush=True)
        return
    model = smoke._gpt2(0)
    base = smoke._burst(0, "serving", model)
    _, rates = smoke.phase_serving_quant(0, model, base, smi)
    res["serving tokens/s"] = {"bf16 einsum": base["tokens_s"], **rates}
    print(label, "serving tokens/s", res["serving tokens/s"], flush=True)
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
