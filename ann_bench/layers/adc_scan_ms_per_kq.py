"""adc_scan_ms_per_kq: device ms of the port's ADC kernel
(`kw::ivf_adc_scan_kernel`, csrc/ivf_adc.cu) per 1,000 queries of the
profiled part's complete requests."""

from ann_bench.profile import device_ms_per_kq

ADC_KERNEL = "ivf_adc_scan_kernel"


def read(ctx):
    return device_ms_per_kq(ctx.trace, ctx.nq, lambda name, ranges: ADC_KERNEL in name)
