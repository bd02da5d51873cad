"""Scaling the sweep and the field over ranks (one process to many)::

    python -m rescan_line_sted_torch.examples.scaling [--platform cpu]
    python -m torch.distributed.run --nproc_per_node 2 \\
        -m rescan_line_sted_torch.examples.scaling [--platform cpu]

Three levels, one code path:

1. one process         -- a world of one rank; the mesh is {"batch": 1,
                          "space": 1}; no change.
2. one host, N ranks   -- shard the sweep axis ("batch") and image rows
                          ("space") over the ranks torchrun starts.
3. many hosts          -- the same: ``initialize_multihost()`` reads the
                          launcher's environment and the SAME mesh helpers
                          span hosts.

Ranks that share a card (more ranks than cards on a host) run over gloo,
ranks with a card each over NCCL (``parallel.initialize_multihost``).
"""

import argparse

import torch

import rescan_line_sted_torch as rls
from rescan_line_sted_torch.data import siemens_star
from rescan_line_sted_torch.device import resolve
from rescan_line_sted_torch.imaging import line_sted_image
from rescan_line_sted_torch.parallel import (
    initialize_multihost,
    make_mesh,
    shard_batch,
)
from rescan_line_sted_torch.parallel.mesh import full_tensor
from rescan_line_sted_torch.sweeps import dose_matched_sweep
from rescan_line_sted_torch.sweeps.mesh import run_sharded_sweep


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--platform", choices=["cpu", "cuda"], default=None,
                        help="device (default: the CUDA card)")
    args = parser.parse_args(argv)
    # Level 3 wiring: no-op without a launcher's environment, joins the
    # process group when there is one. Safe to call unconditionally.
    proc, nprocs = initialize_multihost(
        backend="gloo" if args.platform == "cpu" else None)
    print(f"process {proc}/{nprocs}")

    space = 2 if nprocs % 2 == 0 else 1
    dev = resolve(args.platform)              # the rank's card under a group
    mesh = make_mesh({"batch": nprocs // space, "space": space},
                     devices=dev.type)
    print("mesh:", dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))

    # --- batch axis: the dose-matched sweep, sweep points sharded over ranks
    size = 64
    sample = siemens_star((size, size), device=dev)
    powers = shard_batch(mesh, torch.linspace(0.0, 16.0, 8))
    pgeom = rls.PointSTEDGeometry(rls.Grid(size, size), chunk=size)
    lgeom = rls.LineSTEDGeometry(rls.Grid(size, size), chunk=16)
    pbase = rls.PointSTEDParams.create()
    lbase = rls.LineSTEDParams.create()
    sweep = run_sharded_sweep(
        lambda s, pw: dose_matched_sweep(s, pbase, lbase, pgeom, lgeom, pw,
                                         dose_budget=100.0, device=dev),
        mesh, sample, (powers,))
    print("sweep (8 points over the batch axis):")
    print("  point FWHM [px]:",
          full_tensor(sweep.point.fwhm_x).cpu().numpy().round(2))
    print("  line  FWHM [px]:",
          full_tensor(sweep.line.fwhm_x).cpu().numpy().round(2))

    # --- space axis: one large acquisition, image rows sharded over ranks
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    big = 256
    rows = [Shard(0) if name == "space" else Replicate()
            for name in mesh.mesh_dim_names]
    fov_sample = distribute_tensor(siemens_star((big, big), device=dev), mesh,
                                   rows, src_data_rank=None)
    geom = rls.LineSTEDGeometry(rls.Grid(big, big))
    params = rls.LineSTEDParams.create(depletion=8.0)
    img = line_sted_image(fov_sample, params, geom, device=dev).image
    print(f"large-FOV {big}^2 rows sharded over 'space': "
          f"placements={img.placements}, "
          f"sum={float(full_tensor(img).sum()):.3e}")


if __name__ == "__main__":
    main()
