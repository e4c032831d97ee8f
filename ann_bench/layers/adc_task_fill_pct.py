"""adc_task_fill_pct: the share of the scan kernel's launched tasks that hold
rows (`ivf_scan.tasks_filled` over `ivf_scan.tasks_launched`, counted per
kernel call in ops/ivf_scan.py: the static task bound pads the device-built
tasks with empty ones), over the profiled part's complete requests, in
percent."""

from ann_bench import spans


def read(ctx):
    return spans.counter_pct(ctx, "ivf_scan.tasks_filled", "ivf_scan.tasks_launched")
