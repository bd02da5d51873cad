"""Port parity of the banded fused rescan scan (kernel K1).

The plain version ``rescan_banded_fused_reference`` (what the wrapper runs
on CPU tensors) is held against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs, on the four (q, b, R) cases of
the JAX package's own banded-kernel test. Noise-free agreement:
max|port - jax| / max|jax| <= 1e-5. The CUDA kernel is tested on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.rescan_banded_fused import (
    rescan_banded_fused,
    rescan_banded_fused_reference,
)
from rescan_line_sted_tpu.kernels.rescan_banded_fused import (
    rescan_banded_fused as j_banded,
)

torch.set_num_threads(1)
CASES = [(1, 1, 2.0), (1, 2, 3.0), (2, 1, 1.5), (4, 1, 2.25)]


def _profile(w, sigma):
    x = np.arange(w) - w // 2
    return np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)


def _case(q, binning, rf, seed=0):
    """Inputs of one (q, b, R) case at 64^2 (numpy) and the kernel kwargs."""
    rng = np.random.default_rng(5 + q + binning + seed)
    h = w = 64
    wc = int(round(rf * (w // binning)))
    p_n = int(round((rf - 1.0) / binning * q))
    pos = np.arange(w)
    arrays = dict(sample=rng.random((h, w), np.float32),
                  eff=_profile(w, 1.6), gx=_profile(w, 1.4),
                  offsets=((p_n * pos) // q).astype(np.int32),
                  classes=(pos % q).astype(np.int32))
    kw = dict(wc=wc, d_in=32, d_out=48 // binning * binning, chunk=8,
              binning=binning, q=q)
    return arrays, kw


def _torch_args(a, device="cpu"):
    return [torch.from_numpy(a[k]).to(device)
            for k in ("sample", "eff", "gx", "offsets", "classes")]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("q,binning,rf", CASES)
def test_plain_matches_jax_interpret(q, binning, rf):
    a, kw = _case(q, binning, rf)
    want = j_banded(jnp.asarray(a["sample"]), jnp.asarray(a["eff"]),
                    jnp.asarray(a["gx"]), jnp.asarray(a["offsets"]),
                    classes=jnp.asarray(a["classes"]), interpret=True, **kw)
    s, e, g, o, c = _torch_args(a)
    got = rescan_banded_fused_reference(s, e, g, o, classes=c, **kw)
    assert got.shape == want.shape == (q, kw["wc"], 64 // binning)
    assert _rel(got, want) <= 1e-5
    # the wrapper takes the plain version for CPU tensors, launching nothing
    _build.reset_launches()
    assert torch.equal(rescan_banded_fused(s, e, g, o, classes=c, **kw), got)
    assert _build.LAUNCHES["rescan_banded_fused"] == 0


@pytest.mark.parametrize("fn", [rescan_banded_fused,
                                rescan_banded_fused_reference],
                         ids=["wrapper", "reference"])
@pytest.mark.parametrize("kw,match", [
    (dict(wc=128, d_in=32, d_out=None, chunk=8), "frame window"),
    (dict(wc=128, d_in=32, d_out=48, chunk=4), "multiple of 8"),
    (dict(wc=32, d_in=32, d_out=48, chunk=8), "wider than canvas"),
    (dict(wc=128, d_in=32, d_out=50, chunk=8, binning=2), "binning"),
    (dict(wc=128, d_in=64, d_out=48, chunk=8), "d_in < W"),
])
def test_guards(fn, kw, match):
    w = 64
    prof = torch.from_numpy(_profile(w, 1.5))
    args = (torch.zeros(64, w), prof, prof, torch.zeros(w, dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        fn(*args, **kw)


def test_class_range_guard():
    a, kw = _case(2, 1, 1.5)
    s, e, g, o, c = _torch_args(a)
    with pytest.raises(ValueError, match="classes"):
        rescan_banded_fused_reference(s, e, g, o, classes=c + 1, **kw)


def test_plain_noise_statistics():
    """Noisy plain K1: integer non-negative class canvases whose total
    matches the noise-free total within shot noise; deterministic in the
    generator."""
    a, kw = _case(2, 1, 1.5)
    s, e, g, o, c = _torch_args(a)
    s, e = 50.0 * s, 40.0 * e
    clean = rescan_banded_fused_reference(s, e, g, o, classes=c, **kw)
    noisy = [rescan_banded_fused_reference(
        s, e, g, o, classes=c, generator=torch.Generator().manual_seed(k),
        **kw) for k in (7, 7, 8)]
    assert torch.equal(noisy[0], noisy[1])
    assert not torch.equal(noisy[0], noisy[2])
    assert (noisy[0] >= 0).all() and torch.equal(noisy[0], noisy[0].round())
    tot, ref = float(noisy[0].double().sum()), float(clean.double().sum())
    assert abs(tot - ref) <= 5 * np.sqrt(ref)

