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
      |-- K1 (``kernels.rescan_banded_fused``) on the rank's block, with
      |   the unsharded entry's plan (``imaging.rescan._image_plan``) ->
      |   folded class canvases [q, wc, H_loc/b], drawing from the rank's
      |   own key words (``rank_key``)
      `-- the plan's finish: per-class residue spectral shifts + class sum,
          or the NUFFT merge and deconvolution (local along wc)
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
from rescan_line_sted_torch.physics.dose import DoseReport


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
    """Static detection-profile support half-width (px), the one the band
    windows are sized by (``imaging.rescan._band_supports``); None for a
    fitted width without a set ``det_support`` (a tensor that requires
    grad has no static halo)."""
    from rescan_line_sted_torch.imaging.rescan import _band_supports

    sd = params.sigma_det
    if (getattr(params, "det_support", None) is None
            and isinstance(sd, torch.Tensor) and sd.requires_grad):
        return None
    return _band_supports(params)[1]


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
      than the windows), within K1's shared memory (``banded_fits``):
      where the unsharded scan takes K1, with the same plan (the entry's
      ``imaging.rescan._image_plan``: route, windows, tables, finish);
    * ANY placement step: rational ``(R-1)/b = p/q`` with ``q <= 8``,
      ``q | chunk`` runs class placement (rounded reassignment is the q=1
      case); irrational / larger-q steps run K1's NUFFT spreading mode;
    * ``H`` divisible by the mesh axis size; the per-rank row block at
      least the detection support (the halo crosses ONE neighbour) and
      divisible by the binning.

    ``generator`` (seeded alike on every rank) draws shot noise from
    per-rank streams (``rank_key``): ``noise_mode="per_step"`` inside K1,
    ``"collapsed"`` by K2c on the rank's canvas rows: statistically the
    same as, not draw for draw, the unsharded call.
    """
    from rescan_line_sted_torch.imaging import rescan as engine
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
    h = geom.grid.shape[0]
    b = geom.binning
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

    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(0) if i == mesh_dim else Replicate()
                  for i in range(mesh.ndim)]
    by_rows = is_dtensor(sample) and list(sample.placements) == placements
    dev = (sample.to_local().device if by_rows
           else _mesh_device(mesh.device_type))
    # K1's route, windows, tables and finish: the entry's plan, built once
    # per (params, geometry, placement, device)
    plan = engine._image_plan(
        params, geom, engine._resolve_reassignment(geom, reassignment), dev)
    if plan.banded is None:
        raise ShardedPreconditionError(
            "no static band windows (custom excitation / window not "
            "narrower than the frame / binning misaligns them / windows "
            "beyond the canvas or K1's shared memory, banded_fits)")
    # END of the precondition block: everything below is the engine body;
    # an exception past this point is a bug and must surface (see
    # ShardedPreconditionError)

    idx = mesh.get_local_rank(mesh_dim)
    if by_rows:
        block = sample.to_local()
    else:                    # the whole sample on every rank: take its rows
        block = torch.as_tensor(full_tensor(sample), dtype=torch.float32,
                                device=dev)[idx * h_loc:(idx + 1) * h_loc]
    block = block.to(torch.float32).contiguous()
    per_step = generator is not None and noise_mode == "per_step"
    key = rank_key(generator, dev, idx)

    gy = psfs.detection_profile(h, params.sigma_det, dev)
    # reversed centered detection window: the local y-conv runs as a
    # cross-correlation corr[i] = sum_u ker[u] ext[i+u] (module doc)
    ker = gy[h // 2 - s_det: h // 2 + s_det + 1].flip(0)
    top, bottom = halo_exchange(block, s_det, mesh.get_group(mesh_dim))
    ext = torch.cat([top, block, bottom], dim=0)
    sample_y = y_convolve_block(ext, ker, h_loc).contiguous()

    # the module's attribute, looked up per call (a test replaces it)
    rbf = importlib.import_module(
        "rescan_line_sted_torch.kernels.rescan_banded_fused")
    banded = plan.banded
    canvas = banded.finish(rbf.rescan_banded_fused(
        sample_y, banded.k1, key=key if per_step else None))
    if key is not None and not per_step:
        canvas = poisson_flat(canvas.contiguous(), key=key)
    image = DTensor.from_local(canvas, mesh, placements, run_check=False)
    return AcquisitionResult(image=image,
                             dose=DoseReport(*plan.dose.clone().unbind()))
