"""The whole-group K5's plan (`paged_attention_group_ref`) with bf16 / fp16 q
at GQA groups above 8 at head dims 64 and 128, against the JAX package's
`paged_attention` in Pallas interpret mode. Head dims 8-32 and 256 are in
test_torch_decode_group_k5_d32_d256.py, K6 in
test_torch_decode_group_k6.py, fp32 q in test_torch_decode_group_fp32*.py.
Inputs are numpy from a seed; fp8 payloads cross as uint8 views; the checks
are in tests/_torch_decode_cases.py."""

import pytest

from _torch_decode_cases import GROUP_CASES_D64_D128, GROUP_PAYLOADS, check_k5_group_plan, dim_ids


@pytest.mark.parametrize("payload", GROUP_PAYLOADS)
@pytest.mark.parametrize("hq,hkv,d", GROUP_CASES_D64_D128, ids=dim_ids(GROUP_CASES_D64_D128))
def test_k5_group_plan_matches_jax_paged_kernel(hq, hkv, d, payload):
    """The whole-group K5's plan in plain PyTorch (`paged_attention_group_ref`:
    chunks of one stage, 128 tokens (64 for a 16-bit payload at D256), 2
    blocks a cluster each walking 2 (4) chunks, then the cluster's merge in
    rank order) against JAX's paged kernel (interpret mode) over a permuted
    page table, at the 16-bit tier (P and the output are rounded to q's
    dtype at other points)."""
    check_k5_group_plan(hq, hkv, d, payload)
