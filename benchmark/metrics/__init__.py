"""Per-layer and end-to-end metric readers, one file a metric
(`<name>.py`, a function `read(ctx)` that returns the number or None), and
the shared reductions they use (`trace.py`, `roofline.py`, `flops.py`).

``ctx`` holds what a run measured: "window_s", "setup_s", "attempted",
"answered" (the targets that the flow's answers count as answered: the
main flow's certified ones, the ks flow's assigned ones), "batch_s" (each
batch's seconds), "span_s" (host seconds inside each benchmark span),
"lanes" (the port's `chain_kernels.lane_counts()` over the window) and, in
a `--trace 1` run, "trace" (`trace.traced_segment`'s reduction).
"""
