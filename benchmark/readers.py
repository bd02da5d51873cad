"""Readers that several metrics share; each metric's own file under
``metrics/`` names the one it reads with. A reader takes the run
(``core.Run``) and returns a number, or None where the run holds nothing
to read (no trace, no such kernel)."""

from __future__ import annotations


def kernels_per_call(run):
    """Device kernels per call in the traced stretch (every CUDA kernel:
    the port's, cuFFT's, cuBLAS's and aten's)."""
    if run.trace is None or not run.trace.kernel_count():
        return None
    return run.trace.kernel_count() / run.trace.calls


def syncs_per_call(run):
    """The host's device-to-host reads and waits on the device per call,
    the harness's own synchronise left out."""
    if run.trace is None or not run.trace.kernel_count():
        return None
    return run.trace.syncs / run.trace.calls


def device_idle(run):
    """Share (%) of the traced stretch in which nothing runs on the card."""
    t = run.trace
    if t is None or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(run, least_s, names):
    """A kernel's least time on its work over its device time per call,
    in %; the kernel found by the names it matches in the trace."""
    if run.trace is None:
        return None
    device_s = run.trace.kernel_s(*names) / run.trace.calls
    if not device_s:
        return None
    return 100.0 * least_s(run.spec.config, run.spec.workload["traffic"]) \
        / device_s
