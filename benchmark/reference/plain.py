"""Pieces shared by the plain references: the physics' profiles written
from the image-formation equations (a frozen copy of
``tests/oracle/oracle.py``'s conventions), and the precision a reference
is computed in.

``Precision("float64")`` is the reference. ``Precision("tf32")`` is its
control: float32, with every operand of a product rounded to TF32's
10-bit mantissa first (the tensor cores' single TF32 pass, emulated the
same on every device), which is the step below the float32 that the
configurations state.
"""

from __future__ import annotations

import math

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) rounded to the nearest TF32 value."""
    if x.is_complex():
        return torch.view_as_complex(tf32(torch.view_as_real(x).contiguous()))
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.complex = (torch.complex128 if name == "float64"
                        else torch.complex64)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand in this precision."""
        x = x.to(self.complex if x.is_complex() else self.real)
        return x if self.name == "float64" else tf32(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = self.operand(a), self.operand(b)
        if a.is_complex() != b.is_complex():
            a, b = a.to(self.complex), b.to(self.complex)
        return a @ b


def coords(n: int, device) -> torch.Tensor:
    """Signed offsets from the grid centre ``n // 2`` (float64)."""
    return torch.arange(n, dtype=torch.float64, device=device) - (n // 2)


def gaussian(x: torch.Tensor, sigma: float) -> torch.Tensor:
    return torch.exp(-x.square() / (2.0 * sigma * sigma))


def detection_profile(n: int, sigma: float, device) -> torch.Tensor:
    """Sum-normalised Gaussian, centred at ``n // 2``."""
    g = gaussian(coords(n, device), sigma)
    return g / g.sum()


def line_profiles(width: int, cfg: dict, device):
    """``(excitation, depletion)`` of the line: a Gaussian line of width
    ``sigma_exc`` and the standing-wave stripe ``sin^2(pi x / period)``."""
    x = coords(width, device)
    return (gaussian(x, cfg["sigma_exc"]),
            torch.sin(math.pi * x / cfg["stripe_period"]).square())


def point_profiles(shape, cfg: dict, device):
    """``(excitation, depletion)`` of the point scan: a Gaussian spot and
    the donut ``u e^(1-u)``, ``u = r^2 / (2 sigma_dep^2)``."""
    y = coords(shape[0], device)[:, None]
    x = coords(shape[1], device)[None, :]
    r2 = y * y + x * x
    u = r2 / (2.0 * cfg["sigma_dep"] ** 2)
    return torch.exp(-r2 / (2.0 * cfg["sigma_exc"] ** 2)), u * torch.exp(1.0 - u)


def phases(turns: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``exp(-2 i pi turns)`` from float64 turns (reduced mod 1 first)."""
    t = torch.remainder(turns.to(torch.float64), 1.0)
    z = torch.polar(torch.ones_like(t), -2.0 * math.pi * t)
    return z.to(prec.complex)


def conv_axis(x: torch.Tensor, profile: torch.Tensor, dim: int,
              prec: Precision) -> torch.Tensor:
    """Circular convolution along ``dim`` with a profile centred at
    ``n // 2``, by FFT in the precision's real type."""
    n = x.shape[dim]
    k = torch.fft.rfft(torch.fft.ifftshift(prec.operand(profile), dim=-1))
    shape = [1] * x.dim()
    shape[dim] = k.numel()
    spec = torch.fft.rfft(prec.operand(x), dim=dim) * k.reshape(shape)
    return torch.fft.irfft(spec, n=n, dim=dim)


def correlate2(x: torch.Tensor, kernel: torch.Tensor,
               prec: Precision) -> torch.Tensor:
    """Circular correlation ``out(r) = sum_a x(a) k(a - r)`` with a kernel
    centred at ``(H // 2, W // 2)``."""
    kh = torch.fft.rfft2(torch.fft.ifftshift(prec.operand(kernel),
                                             dim=(-2, -1)))
    return torch.fft.irfft2(torch.fft.rfft2(prec.operand(x)) * kh.conj(),
                            s=tuple(x.shape[-2:]))


def convolve2(x: torch.Tensor, kernel: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Circular convolution with a kernel centred at ``(H // 2, W // 2)``."""
    kh = torch.fft.rfft2(torch.fft.ifftshift(prec.operand(kernel),
                                             dim=(-2, -1)))
    return torch.fft.irfft2(torch.fft.rfft2(prec.operand(x)) * kh,
                            s=tuple(x.shape[-2:]))
