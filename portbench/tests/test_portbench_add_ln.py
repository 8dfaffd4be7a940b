"""The two readers of the ViT blocks' fused add + LayerNorm op
(`add_ln_kernel_share.hmr2`, `add_ln_ms.hmr2`) on synthetic summaries and
counters, as the HMR 2.0 cell's run hands them over: each reads its number,
and None where the program has no such counter or kernel (the parent of
the op). The kernels' names, as the profiler gives them, stay in the
"other" kind, so `other_ms.hmr2` counts them too."""

import pytest

from portbench.spec import Spec
from portbench.work import vit

CELL = "train.hmr2_vith.soft_b48"
FWD = ("void (anonymous namespace)::vit_add_ln_fwd_kernel<5>(float const*, __nv_bfloat16 const*, float const*, "
       "int, int, float const*, float const*, float*, __nv_bfloat16*, float*, float*, int, int, float)")
BWD = ("void (anonymous namespace)::vit_add_ln_bwd_kernel<5>(__nv_bfloat16 const*, float const*, float const*, "
       "float const*, float const*, float const*, float const*, int, int, float*, __nv_bfloat16*, float*, int, int)")
RED = "(anonymous namespace)::vit_add_ln_bwd_reduce_kernel(float const*, int, int, float*, float*)"
OTHERS = {"nvjet_tst_256x128_64x4_1x4_h_bz_coopA_NNT": 60.0,
          "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3": 8.0,
          "void at::native::vectorized_elementwise_kernel<4>": 40.0}


def _data(kernels: dict, calls: dict, units: int = 2) -> dict:
    summary = {"units": units, "by_kernel_ms": dict(kernels), "busy_s": 0.9, "window_s": 1.0}
    return {"summary": summary, "extras": {"attn_calls": dict(calls)}, "window": {"images_per_s": 300.0}}


@pytest.mark.parametrize("metric, kernels, calls, expected", [
    ("add_ln_ms.hmr2", {FWD: 3.0, BWD: 4.6, RED: 0.4, **OTHERS}, {}, 4.0),
    ("add_ln_ms.hmr2", OTHERS, {"vit.tokens": 9216}, None),
    ("add_ln_kernel_share.hmr2", OTHERS,
     {"vit.tokens": 9216, "vit.tokens.add_ln.kernel": 2 * 64 * 9216, "attn.calls.cudnn_attention": 76}, 100.0),
    ("add_ln_kernel_share.hmr2", OTHERS, {"vit.tokens.add_ln.kernel": 3, "vit.tokens.add_ln.eager": 1}, 75.0),
    ("add_ln_kernel_share.hmr2", OTHERS, {"vit.tokens.add_ln.eager": 5}, 0.0),
    ("add_ln_kernel_share.hmr2", OTHERS, {"vit.tokens": 9216, "attn.calls.cudnn_attention": 76}, None),
], ids=["ms", "ms_no_kernel", "share_all", "share_mixed", "share_none_on_kernel", "share_no_counter"])
def test_the_add_ln_readers(metric, kernels, calls, expected):
    value = Spec(CELL).reader(metric).read(_data(kernels, calls))
    assert value == (None if expected is None else pytest.approx(expected))


def test_the_kernels_stay_in_other_ms():
    assert {vit.kind(n) for n in (FWD, BWD, RED)} == {"other"}
    data = _data({FWD: 3.0, BWD: 4.6, RED: 0.4, **OTHERS}, {})
    assert Spec(CELL).reader("other_ms.hmr2").read(data) == pytest.approx((3.0 + 4.6 + 0.4 + 40.0) / 2)
