"""The whole-group K6's plan (`paged_attention_group_ref` over the slot-major
cache's page view, q pre-scaled) with bf16 / fp16 q at GQA groups above 8
at head dims 8-256, against the JAX package's `decode_attention_fused` or
its einsum `decode_attention` (K5 in test_torch_decode_group_k5*.py, fp32 q
in test_torch_decode_group_fp32*.py). Inputs are numpy from a seed; fp8
payloads cross as uint8 views; the checks are in
tests/_torch_decode_cases.py."""

import pytest

from _torch_decode_cases import GROUP_CASES_D32_D256, GROUP_CASES_D64_D128, GROUP_PAYLOADS, check_k6_group_plan, dim_ids

CASES = GROUP_CASES_D64_D128 + GROUP_CASES_D32_D256


@pytest.mark.parametrize("payload", GROUP_PAYLOADS)
@pytest.mark.parametrize("hq,hkv,d", CASES, ids=dim_ids(CASES))
def test_k6_group_plan_matches_jax_fused(hq, hkv, d, payload):
    """The whole-group K6's plan (q pre-scaled and rounded to its dtype,
    lengths + 1, chunks of one stage over the slot-major cache's page view,
    2 blocks a cluster) against JAX's `decode_attention_fused` (interpret
    mode up to d = 128, its einsum fallback above), or on an fp8 cache,
    whose P the JAX kernel rounds to fp8, against JAX's einsum
    `decode_attention`, the function both compute; the 16-bit tier."""
    check_k6_group_plan(hq, hkv, d, payload)
