"""The memory regression of `tests/test_memory.py`, ported: the reference's
reason to exist is that dense attention runs out of memory where flash fits
(its tests/python/test_scaled_dot_product_attention.py:116-153).

The port counts memory by running the function once under
`utils.profiling`'s dispatch mode (storage created and freed, operator by
operator), which gives the same counts on the CPU and on the card; here
the flash side is the K1 wrapper's plain version (the tile loop), and
chip_smoke.py's memory phase repeats the claim with the CUDA kernel and the
dense path's real out-of-memory error."""

from __future__ import annotations

import json
import pathlib

import jax
import numpy as np
import torch

from _torch_port import numpy_params
from flash_attention_tpu.utils import profiling as jprof
from flash_attention_tpu_torch.kernels import flash_attention, vanilla_attention
from flash_attention_tpu_torch.utils import profiling


def test_flash_avoids_score_matrix_memory():
    """At (16 heads, 2048, 64) fp32, the reference's OOM shape, dense
    attention's temps hold the 16 x 2048 x 2048 fp32 scores (256 MiB);
    flash's are at most a quarter of dense's."""
    b, h, l, d = 1, 16, 2048, 64
    q = torch.zeros(b, h, l, d)
    dense = profiling.memory_report(lambda q, k, v: vanilla_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    flash = profiling.memory_report(lambda q, k, v: flash_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    score_bytes = b * h * l * l * 4
    assert dense.temp_bytes >= score_bytes, (dense, score_bytes)
    assert flash.temp_bytes * 4 <= dense.temp_bytes, (flash, dense)
    # q, k and v are one storage; the outputs are [b, h, l, d] fp32
    assert dense.argument_bytes == flash.argument_bytes == q.numel() * 4
    assert dense.output_bytes == flash.output_bytes == q.numel() * 4
    assert dense.generated_code_bytes == 0 and dense.allocator_peak_bytes is None


def test_flash_memory_scales_linearly():
    """Flash's temps grow about linearly in L (dense's quadratically), at
    the JAX test's shape, h4 D128 bf16."""

    def temps(length):
        q = torch.zeros(1, 4, length, 128, dtype=torch.bfloat16)
        return profiling.memory_report(lambda q: flash_attention(q, q, q), q).temp_bytes

    m1, m2 = temps(2048), temps(4096)
    assert 0 < m2 <= m1 * 3, (m1, m2)


def test_flops_estimate_smoke():
    """FlopCounterMode counts dense attention's two products, 4 b h L^2 D;
    a function without a product counts nothing and gives None."""
    q = torch.zeros(1, 2, 256, 128)
    f = profiling.flops_estimate(lambda q: vanilla_attention(q, q, q), q)
    assert f == 4 * 1 * 2 * 256 * 256 * 128
    assert profiling.flops_estimate(lambda q: q + 1, q) is None


def test_memory_report_counts_storage_by_class():
    """x * 2 + 1: the product is a temporary of x's size, freed when the sum
    has used it; the sum is the output.  A view adds nothing."""
    x = torch.zeros(1000)
    rep = profiling.memory_report(lambda x: (x * 2 + 1).view(10, 100), x)
    assert (rep.argument_bytes, rep.output_bytes, rep.temp_bytes) == (4000, 4000, 4000)
    assert rep.peak_bytes == 12000
    assert "temp 0.00 MB" in str(rep)
    a, b = profiling.compare_memory(lambda x: x * 2, lambda x: x * 2 * 3, x)
    assert (a.temp_bytes, b.temp_bytes) == (0, 4000)


def test_variable_table_accounts_all_bytes():
    """Per-variable size table (the reference's get_report_variables):
    every leaf named, totals exact, as JAX's test pins it."""
    tree = {
        "wte": torch.zeros(1000, 64, dtype=torch.bfloat16),
        "blocks": [{"w": torch.zeros(64, 64)}, {"w": torch.zeros(64, 64)}],
    }
    rows = profiling.variable_table(tree, name="params")
    assert len(rows) == 3
    assert rows[0].name == "params['wte']" and rows[0].bytes == 1000 * 64 * 2
    assert rows[0].dtype == "bfloat16"
    assert sum(r.bytes for r in rows) == 1000 * 64 * 2 + 2 * 64 * 64 * 4
    text = profiling.format_variable_table(rows, top=2)
    assert "TOTAL" in text and "params['wte']" in text and "1 more" in text


def test_variable_table_rows_match_the_jax_package():
    """The GPT parameter tree of the parity tests (numpy, from the JAX
    init) gives the same rows in both packages: names, shapes, dtypes,
    bytes, order."""
    tree = numpy_params(0)
    port = profiling.variable_table(tree, name="params")
    ref = jprof.variable_table(tree, name="params")
    assert [(r.name, r.shape, r.dtype, r.bytes) for r in port] == [(r.name, r.shape, r.dtype, r.bytes) for r in ref]
    # the same tree as torch tensors names and sizes its rows alike
    assert profiling.variable_table(jax.tree.map(lambda a: torch.tensor(np.array(a)), tree), name="params") == port


def test_variable_table_of_a_module_names_its_parameters_as_a_tree():
    from flash_attention_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(vocab_size=64, block_size=32, n_layer=2, n_head=2, n_embd=32, dtype=torch.float32)
    model = gpt.GPT(cfg, device="cpu")
    rows = profiling.variable_table(model, name="params")
    names = {r.name for r in rows}
    assert "params['wte']" in names and "params['blocks'][1]['attn']['wqkv']['weight']" in names
    assert sum(r.bytes for r in rows) == sum(p.numel() * 4 for p in model.parameters())


def test_liveness_curve_flash_vs_dense():
    """Live bytes over the run: dense attention's peak holds the score
    matrix, and is at least twice flash's."""
    b, h, l, d = 1, 8, 1024, 64
    q = torch.zeros(b, h, l, d)
    _, dense = profiling.liveness(lambda q, k, v: vanilla_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    steps, flash = profiling.liveness(lambda q, k, v: flash_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    assert len(dense) > 3 and len(flash) > 3 and len(steps) == len(flash)
    score_bytes = b * h * l * l * 4
    assert dense.max() >= score_bytes
    assert flash.max() * 2 <= dense.max(), (flash.max(), dense.max())


def test_liveness_steps_are_operators():
    """x * 2 + 1 is two operators: after the first, the argument and the
    product are live; after the second, the sum too."""
    x = torch.zeros(1000)
    steps, live = profiling.liveness(lambda x: x * 2 + 1, x)
    assert steps.tolist() == [0, 1] and live.tolist() == [8000, 12000]


def test_plot_liveness_and_trace(tmp_path):
    q = torch.zeros(1, 2, 256, 64)
    curves = {name: profiling.liveness(fn, q) for name, fn in
              (("dense", lambda q: vanilla_attention(q, q, q)), ("flash", lambda q: flash_attention(q, q, q)))}
    profiling.plot_liveness(curves, str(tmp_path / "liveness.png"))
    assert (tmp_path / "liveness.png").stat().st_size > 0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        flash_attention(q, q, q)
    events = json.loads(pathlib.Path(tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert profiling.device_time(prof, 1) is None  # no device on the CPU
