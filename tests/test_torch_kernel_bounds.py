"""chip_smoke.py's yardsticks, checked on the CPU: the least time each
attention kernel could take at the main paths' shapes (the bounds PERF.md
quotes) and the device time it reads from a profiler window."""
from types import SimpleNamespace

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize("kernel,bh,s,dtype,want_ms,want_by", [
    # K1 at the training shape (O1, batch 64 x 12 heads, seq 128)
    ("fwd", 768, 128, "bfloat16", 0.0151, "bytes"),
    # K2 and K3 at the same shape, and in float32 (the O0 step's form)
    ("bwd_dq", 768, 128, "bfloat16", 0.0190, "bytes"),
    ("bwd_dkv", 768, 128, "bfloat16", 0.0228, "bytes"),
    ("bwd_dq", 768, 128, "float32", 0.0721, "operations"),
    ("bwd_dkv", 768, 128, "float32", 0.0962, "operations"),
    # K1 at the largest serving shape (batch 8 x 12 heads, seq 512, f32)
    ("fwd", 96, 512, "float32", 0.0962, "operations"),
])
def test_attention_bound_at_the_main_shapes(kernel, bh, s, dtype, want_ms, want_by):
    ms, by = chip_smoke.attention_bound_ms(bh, s, s, 64, dtype, False, kernel)
    assert by == want_by
    assert round(ms, 4) == want_ms


def test_causal_bound_counts_only_the_unmasked_pairs():
    # bottom-right causal: row r sees cols <= r + (sk - sq)
    assert chip_smoke.attention_pairs(4, 4, True) == 10
    assert chip_smoke.attention_pairs(4, 2, True) == 3  # two rows fully masked
    assert chip_smoke.attention_pairs(2, 4, True) == 7
    full, _ = chip_smoke.attention_bound_ms(8, 512, 512, 64, "float32", False)
    causal, by = chip_smoke.attention_bound_ms(8, 512, 512, 64, "float32", True)
    assert by == "operations" and causal == pytest.approx(full * 513 / 1024)


def test_decode_form_is_timed_against_non_causal_sdpa():
    """A single query under the kernels' bottom-right causal mask sees
    every key, so the decode form has a library call: sdpa without a
    causal mask. Causal with 1 < sq != sk has none (sdpa aligns top-left)."""
    decode = dict(causal=True, sq=1, sk=192)
    assert chip_smoke.library_reason(decode) is None
    assert chip_smoke.library_causal(decode) is False
    square = dict(causal=True, sq=128, sk=128)
    assert chip_smoke.library_reason(square) is None and chip_smoke.library_causal(square)
    assert chip_smoke.library_reason(dict(causal=True, sq=200, sk=512)) is not None
    assert not chip_smoke.library_causal(dict(causal=False, sq=64, sk=64))
    # the premise, on the CPU: non-causal sdpa is the kernels' causal
    # single-query function (their plain version)
    from paddle_tpu_torch.ops import flash_attention as tfa

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, n, 64, generator=g) for n in (1, 37, 37))
    want, _ = tfa.mha_reference(q, k, v, 0, 0.125, True, 0.0)
    got = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=False,
                                                           scale=0.125)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_llama_decode_bound_in_bench_terms():
    """Llama-2-7B (6,738,415,616 parameters) at batch 16: a step reads the
    13.21 GB of weights but the embedding table, the batch's 16 embedding
    rows and 16 rows of 100.7 MB of K/V at the mean length 192: 4.4255 ms,
    about 3,615 tokens/s at the data sheet's 3.35 TB/s."""
    ms, tps = chip_smoke.decode_bound(6738415616, 32000, 4096, 32, 4096, 16, 192)
    assert round(ms, 4) == 4.4255 and round(tps) == 3615
    # the bound of one Llama prefill or decode launch of K1 (bf16)
    prefill, by = chip_smoke.attention_bound_ms(512, 128, 128, 128, "bfloat16", True)
    assert by == "bytes" and round(prefill, 4) == 0.0201
    step, by = chip_smoke.attention_bound_ms(512, 1, 192, 128, "bfloat16", True)
    assert by == "bytes" and round(step, 4) == 0.0151


def test_length_form_bound_counts_only_the_valid_rows():
    """K1's length form reads each batch row's k_len valid K/V rows, not
    the pool: at every length equal to the operand's it is the plain
    form's bound, and shorter lengths lower it."""
    for causal, sq, sk in ((False, 64, 64), (True, 1, 256), (True, 128, 128)):
        full, by = chip_smoke.attention_bound_ms(16 * 32, sq, sk, 128, "bfloat16", causal)
        got, by2 = chip_smoke.length_bound_ms(32, sq, sk, 128, "bfloat16", causal, [sk] * 16)
        assert by == by2 and got == pytest.approx(full)
    # the engine step at lengths 1 and 255 over a 256-row pool: q, O and LSE
    # of 2 x 32 heads and 256 valid rows of K and V each
    ms, by = chip_smoke.length_bound_ms(32, 1, 256, 128, "bfloat16", True, [1, 255])
    want = (2 * 32 * (2 * 128 * 2 + 4) + 2 * 32 * 256 * 128 * 2) / 3.35e12 * 1e3
    assert by == "bytes" and ms == pytest.approx(want)
    # causal prefill at length 77: rows past 76 still see keys 0..76
    assert chip_smoke.length_pairs(128, 128, 77, True) == 77 * 78 // 2 + (128 - 77) * 77
    assert chip_smoke.length_pairs(1, 256, 40, True) == 40
    assert chip_smoke.length_pairs(5, 9, 3, False) == 15


def _ev(device_type, us, key="k"):
    return SimpleNamespace(key=key, device_type=device_type, self_device_time_total=us)


def test_device_time_sums_only_what_ran_on_the_card():
    events = [
        _ev("DeviceType.CPU", 900.0, "aten::empty"),        # host side: left out
        _ev("DeviceType.CUDA", 120.0, "fwd_bf16_kernel"),
        _ev("DeviceType.CUDA", 30.5, "Memset (Device)"),
        _ev("DeviceType.CPU", 55.0, "cudaLaunchKernel"),
    ]
    assert chip_smoke.device_us(events) == 150.5
    # older profilers name the field self_cuda_time_total
    old = SimpleNamespace(key="k", device_type="DeviceType.CUDA", self_cuda_time_total=7.0)
    assert chip_smoke.device_us(events + [old]) == 157.5
    assert chip_smoke.device_us([]) == 0.0


def test_device_time_refuses_a_window_that_lost_records():
    """Over 20 calls every kernel of a call shows 20, 40, ... times; a
    count that is not a multiple means the profiler dropped records, and
    the sum would read below the kernel's own time."""
    def ev(count, us):
        return SimpleNamespace(key="k", device_type="DeviceType.CUDA",
                               self_device_time_total=us, count=count)
    assert chip_smoke.device_us([ev(20, 800.0), ev(40, 100.0)], calls=20) == 900.0
    assert chip_smoke.device_us([ev(20, 800.0), ev(7, 300.0)], calls=20) is None
    host = SimpleNamespace(key="cudaLaunchKernel", device_type="DeviceType.CPU",
                           self_device_time_total=0.0, count=13)
    assert chip_smoke.device_us([ev(20, 800.0), host], calls=20) == 800.0
