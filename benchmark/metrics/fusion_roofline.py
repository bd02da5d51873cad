"""``fusion_roofline``: the fused call's least time over the card's busy
time per call (%).

The least time (``fusion_work.fusion_least_s``) is counted from the
configuration: the stacked operator's rotation, detection and canvas taps
in each of its 2 x iterations + 2 applications, as three TF32 passes at
495 TFLOP/s, or each iteration's canvases read once and estimate read and
written once at 3.35 TB/s, whichever is longer. The busy time is every
kernel, copy and fill of the traced calls, so the products, gathers,
scatters, FFTs, draws and elementwise passes all count against it."""

from benchmark.fusion_work import fusion_least_s


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    least = fusion_least_s(run.spec.config, run.spec.workload["traffic"])
    return 100.0 * least / (t.busy_s / t.calls)
