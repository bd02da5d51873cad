"""``fft_placements_per_call.fusion``: forward applications per call of
the closed form's placement as an FFT (``rls.image.fft_placement``: one
per application of the canvas map where ``R * (W/b)`` is the canvas
width; the acquisition, the normaliser's forward and one per RL
iteration in a fused call); None where the program records no such span
(a program whose placement is the phase-table product alone)."""

from benchmark import spans


def read(run):
    return spans.per_call(run, "rls.image.fft_placement",
                          "rls.image.fft_placement")
