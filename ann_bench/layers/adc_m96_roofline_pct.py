"""adc_m96_roofline_pct: the least time the card could take for the ADC work
of the profiled part's complete requests over the ADC kernel's device time
in them, in percent, in the cell whose PQ has 96 subspaces over 960
dimensions (adc_scan_roofline_pct's reading there: roofline.py counts from
the index's own m, ksub, nbits and unpadded d, and the search's nprobe and
k x refine_k)."""

from ann_bench.layers.adc_scan_roofline_pct import read  # noqa: F401
