"""chip_smoke.py's yardsticks, checked on the CPU: the least time each
attention kernel could take at the main paths' shapes (the bounds PERF.md
quotes) and the device time it reads from a profiler window."""
from types import SimpleNamespace

import pytest

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
