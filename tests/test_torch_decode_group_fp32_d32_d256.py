"""The fp32 whole-group kernel's plan as in test_torch_decode_group_fp32.py,
at head dims 8, 16, 32 (run at 32) and 256: groups 12 (one padded row
tile), 71 (5 row tiles; 3 passes of at most 32 q heads at 256) and 24 on
two KV heads, over fp32, int8 and fp8 pages (stages of 128 tokens, 32 for
fp32 pages at 256). Inputs are numpy from a seed; fp8 payloads cross as
uint8 views; the checks are in tests/_torch_decode_cases.py."""

import pytest

from _torch_decode_cases import (GROUP_CASES_D32_D256, GROUP_FP32_PAYLOADS, check_k5_group_fp32_plan,
                                 check_k6_group_fp32_plan, dim_ids)


@pytest.mark.parametrize("payload", GROUP_FP32_PAYLOADS)
@pytest.mark.parametrize("hq,hkv,d", GROUP_CASES_D32_D256, ids=dim_ids(GROUP_CASES_D32_D256))
def test_k5_group_fp32_plan_matches_jax_paged_kernel(hq, hkv, d, payload):
    """The fp32 whole-group K5's plan in plain PyTorch (chunks of one stage,
    2 blocks a cluster, then the cluster's merge in rank order) against
    JAX's paged kernel (interpret mode, fp32 q: P is not rounded) over a
    permuted page table of pages of 16, at the fp32 tolerance."""
    check_k5_group_fp32_plan(hq, hkv, d, payload)


@pytest.mark.parametrize("payload", GROUP_FP32_PAYLOADS)
@pytest.mark.parametrize("hq,hkv,d", GROUP_CASES_D32_D256, ids=dim_ids(GROUP_CASES_D32_D256))
def test_k6_group_fp32_plan_matches_jax_fused(hq, hkv, d, payload):
    """The fp32 whole-group K6's plan (q multiplied by sm_scale in fp32,
    lengths + 1, chunks of one stage over the slot-major cache's page view,
    2 blocks a cluster) against JAX's `decode_attention_fused` (interpret
    mode up to d = 128, its einsum fallback above) over fp32 pages, and over
    int8 / fp8 pages, whose P the JAX kernel rounds (to bf16 / fp8,
    pv_dtype), against JAX's einsum `decode_attention`, the function both
    compute; the fp32 tolerance."""
    check_k6_group_fp32_plan(hq, hkv, d, payload)
