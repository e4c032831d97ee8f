"""adc_lut_per_lookup_pct: the ADC kernel's lookup-table entries built per
lookup, in percent: 100 x `ivf_scan.adc_lut_entries` (Qg x m x ksub a task
with rows) over `ivf_scan.adc_lookups` (valid queries x rows x m a task),
counted at each launch in ops/ivf_scan.py, over the profiled part's complete
requests. None where the program counts neither."""

from ann_bench import spans


def read(ctx):
    return spans.counter_pct(ctx, "ivf_scan.adc_lut_entries", "ivf_scan.adc_lookups")
