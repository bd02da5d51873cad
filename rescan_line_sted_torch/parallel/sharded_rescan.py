"""Row-sharded banded fused rescan: kernel K1 on every rank (port of the
JAX package's ``parallel/sharded_rescan.py``, its ``shard_map`` engine).

After the detection y-convolution, every remaining stage of the rescan
scan -- the band-window x-convolution, the in-kernel Poisson draws, the
integer / class / NUFFT placement and the per-class residue shifts along
the canvas axis -- is independent per CAMERA ROW. Sharding the H axis
therefore needs no collective in the scan itself::

    sample [H, W], rows sharded over mesh axis ``axis``
      |-- halo exchange: each rank sends its last S rows down the ring and
      |   its first S rows up (``torch.distributed.batch_isend_irecv``; a
      |   circular ring == the unsharded engine's circular FFT boundary);
      |   S = det_support, where the detection profile has decayed below
      |   ~4e-10 of peak
      |-- local y-convolution on the halo-extended block (one rfft pair;
      |   rows [0, H_loc) of the extended correlation are wrap-free)
      |-- K1 (``kernels.rescan_banded_fused``) on the rank's block ->
      |   folded class canvases [q, wc, H_loc/b], drawing from the rank's
      |   own key words (``rank_key``)
      `-- per-class residue spectral shifts + class sum (local along wc)
          -> canvas rows [H_loc/b, wc]

    result: a DTensor, Shard(0) over ``axis``: canvas rows are owned by
    one rank each, no reduction.

Numerics against the unsharded engine: identical but for the
y-convolution, which truncates the detection profile at its static support
instead of the full-H circular FFT -- a < ~1e-9 relative tail, far inside
the 1e-5 parity bar.

Random streams. K1's and K2c's Philox counters are element indices within
one launch, so two ranks launching with the same key words on blocks of the
same shape would draw the same noise. The two key words are drawn once from
the caller's generator (seeded alike on every rank, as JAX's key is
replicated) and the second is offset by the rank's index on ``axis``
(``_build.offset_key``), as the JAX engine offsets its per-device seed;
rank 0's words are the unsharded call's.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch
import torch.distributed as dist

from rescan_line_sted_torch.config import RescanGeometry, RescanParams
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.poisson import poisson_flat
from rescan_line_sted_torch.parallel.mesh import (
    _mesh_device,
    full_tensor,
    host_staged,
    is_dtensor,
    whole,
)
from rescan_line_sted_torch.physics import psf as psfs
from rescan_line_sted_torch.physics.dose import line_sted_dose


class ShardedPreconditionError(ValueError):
    """A documented precondition of ``rescanned_line_sted_sharded`` does
    not hold for this (sample, params, geom, mesh) combination -- the
    gathered route handles the case instead.

    Raised ONLY by the engine's up-front precondition block; the
    auto-route (``imaging/rescan._route_row_sharded``) catches exactly
    this type, so a genuine bug downstream (any other exception, including
    a plain ValueError from argument validation or a shape error inside the
    engine body) PROPAGATES instead of being rerouted silently."""


def _det_support(params) -> int | None:
    """Static detection-profile support half-width (px); None for a fitted
    width (a tensor that requires grad has no static halo)."""
    s = getattr(params, "det_support", None)
    if s is not None:
        return int(s)
    sd = params.sigma_det
    if isinstance(sd, torch.Tensor) and sd.requires_grad:
        return None
    from rescan_line_sted_torch.config import _support

    return _support(sd)


def _axis_index(mesh, axis) -> int:
    return mesh.mesh_dim_names.index(axis) if isinstance(axis, str) else axis


def rank_key(generator, device, index: int):
    """The key words of stream ``index`` (a rank's index on the sharded
    axis): the two words drawn from ``generator`` as an unsharded kernel
    call draws them (``_build.draw_key``), the second offset by ``index``
    (``_build.offset_key``): a pair of ints, with no host-device sync.
    None without a generator."""
    if generator is None:
        return None
    return _build.offset_key(_build.draw_key(generator, device), index)


def halo_exchange(block: torch.Tensor, s: int, group
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(top, bottom)`` halo rows of this rank's row block over the ring of
    ``group``: the last ``s`` rows of the rank above and the first ``s``
    rows of the rank below (circular). A ring of one rank gives the block's
    own wrap rows -- the unsharded engine's circular boundary.

    Each rank sends its last rows down the ring and its first rows up in
    one ``batch_isend_irecv``; the two messages to one peer carry tags 0
    and 1 and are posted in one order on every rank, so they match under
    gloo (by tag) and NCCL (by order) alike. Over gloo on a card
    (``host_staged``) the 2 s rows go through pinned host buffers."""
    n = dist.get_world_size(group)
    if n == 1:
        return block[-s:], block[:s]
    idx = dist.get_rank(group)
    down = dist.get_global_rank(group, (idx + 1) % n)
    up = dist.get_global_rank(group, (idx - 1) % n)
    staged = host_staged(group, block.device)
    if staged:
        send = torch.empty((2, s, block.shape[1]), dtype=block.dtype,
                           pin_memory=True)
        send[0].copy_(block[-s:])
        send[1].copy_(block[:s])
        recv = torch.empty(send.shape, dtype=block.dtype, pin_memory=True)
    else:
        send = torch.stack([block[-s:], block[:s]])
        recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send[0], down, group, tag=0),
           dist.P2POp(dist.isend, send[1], up, group, tag=1),
           dist.P2POp(dist.irecv, recv[0], up, group, tag=0),
           dist.P2POp(dist.irecv, recv[1], down, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recv = recv.to(block.device, non_blocking=True)
    return recv[0], recv[1]


def y_convolve_block(ext: torch.Tensor, ker: torch.Tensor, rows: int
                     ) -> torch.Tensor:
    """Rows ``[0, rows)`` of the cross-correlation ``corr[i] = sum_u ker[u]
    ext[i + u]`` of the halo-extended block ``ext`` [rows + len(ker) - 1,
    W] with the reversed detection window ``ker``: one rfft pair, wrap-free
    on those rows."""
    ell = ext.shape[0]
    kerp = torch.zeros(ell, dtype=ext.dtype, device=ext.device)
    kerp[:ker.numel()] = ker
    spec = torch.fft.rfft(ext, dim=0)
    return torch.fft.irfft(spec * torch.conj(torch.fft.rfft(kerp))[:, None],
                           n=ell, dim=0)[:rows]


def rescanned_line_sted_sharded(
    sample,
    params: RescanParams,
    geom: RescanGeometry,
    mesh,
    axis: str = "space",
    generator: torch.Generator | None = None,
    noise_mode: str = "collapsed",
    reassignment: str = "auto",
):
    """Rescanned line-STED acquisition with sample ROWS sharded over
    ``mesh`` axis ``axis``, K1 on every rank (module doc).

    Drop-in for ``rescanned_line_sted_image(..., method="scan")`` when the
    sample is (or should be) row-sharded: ``sample`` is a ``DTensor``
    (``Shard(0)`` on ``axis``, ``Replicate()`` elsewhere) or the whole
    sample on every rank; returns an ``AcquisitionResult`` whose image is
    the same canvas as a ``DTensor`` with its rows sharded over ``axis``.
    Every rank of the mesh calls it (the halo exchange is collective).
    Requirements (``ShardedPreconditionError``, a ``ValueError`` subtype,
    otherwise -- this API is explicit, it does not fall back; INVALID
    ARGUMENTS like an unknown noise_mode/reassignment raise plain
    ``ValueError``, exactly as the unsharded engine does):

    * static band windows (the Gaussian-excitation model, a frame wider
      than the windows), within K1's shared memory (``banded_fits``);
    * ANY placement step: rational ``(R-1)/b = p/q`` with ``q <= 8``,
      ``q | chunk`` runs class placement (rounded reassignment is the q=1
      case); irrational / larger-q steps run K1's NUFFT spreading mode
      (``ShardedPreconditionError`` only when ``RLS_BANDED_NUFFT=0``
      disables it);
    * ``H`` divisible by the mesh axis size; the per-rank row block at
      least the detection support (the halo crosses ONE neighbour) and
      divisible by the binning.

    ``generator`` (seeded alike on every rank) draws shot noise from
    per-rank streams (``rank_key``): ``noise_mode="per_step"`` inside K1,
    ``"collapsed"`` by K2c on the rank's canvas rows: statistically the
    same as, not draw for draw, the unsharded call.
    """
    from rescan_line_sted_torch.imaging import rescan as engine
    from rescan_line_sted_torch.imaging.line_sted import (
        effective_line_profile,
    )
    from rescan_line_sted_torch.imaging.point_sted import AcquisitionResult

    params = whole(params)
    # argument validation: plain ValueError, as the unsharded engine raises
    # (the same arguments must not validate differently when sharded)
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if reassignment not in ("auto", "rounded", "subpixel"):
        raise ValueError(f"unknown reassignment {reassignment!r}")
    if tuple(sample.shape) != tuple(geom.grid.shape):
        raise ValueError(f"sample shape {tuple(sample.shape)} does not match "
                         f"the grid {tuple(geom.grid.shape)}")
    h, w = geom.grid.shape
    b = geom.binning
    chunk = geom.chunk
    hc, wc = geom.canvas_shape
    mesh_dim = _axis_index(mesh, axis)
    n_dev = mesh.size(mesh_dim)
    if h % n_dev:
        raise ShardedPreconditionError(
            f"H={h} not divisible by mesh axis {axis}={n_dev}")
    h_loc = h // n_dev
    if h_loc % b:
        raise ShardedPreconditionError(
            f"per-device rows {h_loc} not divisible by binning {b}")
    s_det = _det_support(params)
    if s_det is None:
        raise ShardedPreconditionError(
            "fitted sigma_det: no static halo width; use the gathered "
            "route (rescanned_line_sted_image)")
    s_det = min(s_det, h // 2)  # profile window cannot exceed the grid
    if n_dev > 1 and s_det > h_loc:
        raise ShardedPreconditionError(
            f"halo {s_det} px exceeds the per-device row block {h_loc}; "
            f"use fewer devices on axis {axis!r}")

    # placement classes: integer offsets within q fractional-residue
    # classes (K1's contract; see imaging/rescan._banded_inputs).
    # Irrational (or q > 8 rational) steps run K1's NUFFT spreading mode
    # instead: two parity canvases of a 2x-oversampled fine grid + one
    # window deconvolution per rank block -- all stages stay independent
    # per camera row, so the halo ring and the result are unchanged.
    reassignment = engine._resolve_reassignment(geom, reassignment)
    step = (float(geom.rescan_factor) - 1.0) / b
    nufft = False
    if reassignment == "rounded":
        bf_p, bf_q = None, 1
    else:
        pq = engine._rational_step(step, chunk)
        if pq is None:
            if os.environ.get("RLS_BANDED_NUFFT", "1") == "0":
                raise ShardedPreconditionError(
                    "irrational placement step with NUFFT spreading "
                    "disabled (RLS_BANDED_NUFFT=0); use the gathered route")
            nufft = True
            bf_p, bf_q = None, 2  # parity canvases of the fine grid
        else:
            bf_p, bf_q = pq
    windowed = engine._illum_band(params, w, chunk, b)
    if windowed is None or windowed[1] is None:
        raise ShardedPreconditionError(
            "no static band windows (custom excitation / window not "
            "narrower than the frame / binning misaligns them)")
    d_in, d_out = windowed
    dob = d_out // b
    n_spread = engine._NUFFT_P // 2 if nufft else 0
    d_place = dob + max(n_spread - 1, 0)
    if chunk % 8 or (chunk * dob) % 32 or (d_place + 7) // 8 * 8 + 8 > wc:
        raise ShardedPreconditionError(
            "banded kernel alignment preconditions failed "
            f"(chunk={chunk}, d_out/b={dob}, wc={wc})")
    rbf = importlib.import_module(
        "rescan_line_sted_torch.kernels.rescan_banded_fused")
    if not rbf.banded_fits(d_in, dob, chunk, b, n_spread):
        raise ShardedPreconditionError(
            "band windows beyond K1's shared memory (banded_fits) at "
            "this per-device block")
    # END of the precondition block: everything below is the engine body;
    # an exception past this point is a bug and must surface (see
    # ShardedPreconditionError)

    from torch.distributed.tensor import DTensor, Replicate, Shard

    idx = mesh.get_local_rank(mesh_dim)
    placements = [Shard(0) if i == mesh_dim else Replicate()
                  for i in range(mesh.ndim)]
    if is_dtensor(sample) and list(sample.placements) == placements:
        block = sample.to_local()
    else:                    # the whole sample on every rank: take its rows
        block = torch.as_tensor(full_tensor(sample), dtype=torch.float32,
                                device=_mesh_device(mesh.device_type))
        block = block[idx * h_loc:(idx + 1) * h_loc]
    block = block.to(torch.float32).contiguous()
    dev = block.device
    per_step = generator is not None and noise_mode == "per_step"
    key = rank_key(generator, dev, idx)

    eff_s = params.brightness * effective_line_profile(w, params, dev)
    gx = psfs.detection_profile(w, params.sigma_det, dev)
    gy = psfs.detection_profile(h, params.sigma_det, dev)
    # reversed centered detection window: the local y-conv runs as a
    # cross-correlation corr[i] = sum_u ker[u] ext[i+u] (module doc)
    ker = gy[h // 2 - s_det: h // 2 + s_det + 1].flip(0)
    top, bottom = halo_exchange(block, s_det, mesh.get_group(mesh_dim))
    ext = torch.cat([top, block, bottom], dim=0)
    sample_y = y_convolve_block(ext, ker, h_loc).contiguous()

    kw = dict(wc=wc, d_in=d_in, d_out=d_out, chunk=chunk, binning=b,
              supports=engine._band_supports(params),
              key=key if per_step else None)
    pos = torch.arange(w, device=dev)
    if nufft:
        offsets2, weights = engine._nufft_spread_tables(
            step * np.arange(w, dtype=np.float64), device=dev)
        folded = rbf.rescan_banded_fused(
            sample_y, eff_s, gx, torch.zeros(w, dtype=torch.int32,
                                             device=dev),
            spread_weights=weights, offsets2=offsets2, **kw)
        canvas = engine._apply_nufft_deconv(folded, wc,
                                            engine._nufft_deconv_inv(wc))
    else:
        if bf_p is None:
            offsets = torch.round(
                (geom.rescan_factor - 1.0) * pos / b).to(torch.int32)
            classes, fracs = None, [0.0]
        else:
            offsets = torch.div(bf_p * pos, bf_q,
                                rounding_mode="floor").to(torch.int32)
            classes = (pos % bf_q).to(torch.int32)
            fracs = [((bf_p * r) % bf_q) / bf_q for r in range(bf_q)]
        folded = rbf.rescan_banded_fused(
            sample_y, eff_s, gx, offsets, classes=classes, q=bf_q, **kw)
        canvas = engine._apply_class_residues(folded, fracs, wc)
    if key is not None and not per_step:
        canvas = poisson_flat(canvas.contiguous(), key=key)
    image = DTensor.from_local(canvas, mesh, placements, run_check=False)
    return AcquisitionResult(image=image,
                             dose=line_sted_dose(params, geom, dev))
