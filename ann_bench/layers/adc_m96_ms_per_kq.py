"""adc_m96_ms_per_kq: device ms of the port's ADC kernel
(`kw::ivf_adc_scan_kernel`, csrc/ivf_adc.cu) per 1,000 queries of the
profiled part's complete requests, in the cell whose PQ has 96 subspaces
over 960 dimensions (adc_scan_ms_per_kq's reading there)."""

from ann_bench.layers.adc_scan_ms_per_kq import read  # noqa: F401
