"""One rank of a gloo world on the CPU for ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py RANK WORLD STORE OUT

Joins the world through a ``FileStore`` (``file://STORE``), drives the
port's ``parallel`` package and writes what it saw to ``OUT/rank{RANK}.npz``
(arrays: each rank's canvas rows and sweep columns) and
``OUT/rank{RANK}.json`` (facts: routes taken, placements, error messages).
The test module compares them with the JAX package and with the port's
unsharded engines. Imports torch and the port only.
"""

import json
import math
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

W = 192            # the smallest grid where the 128-aligned windows engage
CASES = {"r1.5_b1": (1.5, 1), "r2_b2": (2.0, 2),
         "irrational": (1.0 + math.pi / 16, 1)}
# a chunk whose frame window is not narrower than the frame: no band windows
WIDE_CHUNK = 96
SWEEP_SIZE = 32
SWEEP_POWERS = 8


def _error(fn) -> str | None:
    """The message of the ``ValueError`` ``fn`` raises, with its type."""
    try:
        fn()
    except ValueError as e:
        return f"{type(e).__name__}: {e}"
    return None


def main(rank: int, world: int, store: str, out: str) -> None:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    import rescan_line_sted_torch as T
    from rescan_line_sted_torch.data import samples
    from rescan_line_sted_torch.imaging import rescan as engine
    from rescan_line_sted_torch.parallel import (
        initialize_multihost,
        is_initialized,
        local_device_slice,
        make_mesh,
        replicate,
        shard_batch,
    )
    from rescan_line_sted_torch.parallel import sharded_rescan
    from rescan_line_sted_torch.parallel.mesh import full_tensor, host_staged
    from rescan_line_sted_torch.sweeps import dose_matched_sweep
    from rescan_line_sted_torch.sweeps.mesh import run_sharded_sweep

    arrays, facts = {}, {}
    facts["init"] = initialize_multihost(f"file://{store}",
                                         num_processes=world,
                                         process_id=rank, backend="gloo")
    facts["init_again"] = initialize_multihost()
    facts["is_initialized"] = is_initialized()
    mesh = make_mesh({"space": world}, devices="cpu")
    group = mesh.get_group("space")
    facts["host_staged"] = [host_staged(group, torch.device("cpu")),
                            host_staged(group, torch.device("cuda"))]
    facts["mesh_default"] = [list(make_mesh(devices="cpu").mesh_dim_names),
                             list(make_mesh(devices="cpu").mesh.shape)]
    facts["mesh_bad"] = _error(lambda: make_mesh({"batch": world + 1},
                                                 devices="cpu"))
    pair = make_mesh({"batch": max(world // 2, 1),
                      "space": 2 if world > 1 else 1}, devices="cpu")
    facts["local_slice"] = {a: list(local_device_slice(pair, a))
                            for a in pair.mesh_dim_names}
    facts["coordinate"] = list(pair.get_coordinate())

    sample = samples.siemens_star((W, W), spokes=10, device="cpu") * 3.0
    rows = distribute_tensor(sample, mesh, [Shard(0)], src_data_rank=None)
    params = T.LineSTEDParams.create(sigma_exc=1.2, sigma_det=1.2,
                                     depletion=4.0, brightness=50.0)

    engaged = []
    orig = sharded_rescan.rescanned_line_sted_sharded

    def spy(*a, **kw):
        engaged.append(kw.get("axis"))
        return orig(*a, **kw)

    sharded_rescan.rescanned_line_sted_sharded = spy

    def routed(name, smp, geom, **kw):
        engaged.clear()
        img = T.rescanned_line_sted_image(smp, params, geom, method="scan",
                                          device="cpu", **kw).image
        arrays[name] = img.to_local().numpy()
        facts[name] = {"engaged": list(engaged),
                       "placements": [str(p) for p in img.placements]}
        return img

    geoms = {name: T.RescanGeometry(T.Grid(W, W), rescan_factor=r,
                                    binning=b, chunk=16)
             for name, (r, b) in CASES.items()}
    for name, geom in geoms.items():
        routed(f"routed_{name}", rows, geom)
        img = orig(sample, replicate(mesh, params), geom, mesh).image
        arrays[f"explicit_{name}"] = img.to_local().numpy()
    # a second sharded call of each geometry: the entry's plan, cached
    from torch.profiler import ProfilerActivity, profile

    facts["second_call"] = {}
    for name, geom in geoms.items():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            orig(rows, params, geom, mesh)
        facts["second_call"][name] = sorted(
            e.name for e in prof.events()
            if e.name in ("rls.plan_build", "rls.read_back"))
    # no band windows: attempted, refused inside, gathered route
    wide = T.RescanGeometry(T.Grid(W, W), rescan_factor=1.5,
                            chunk=WIDE_CHUNK)
    routed("unbanded", rows, wide)
    facts["unbanded_error"] = _error(lambda: orig(rows, params, wide, mesh))
    # a replicated sample is not row-sharded: the gathered route
    routed("replicated", distribute_tensor(sample, mesh, [Replicate()],
                                           src_data_rank=None),
           geoms["r1.5_b1"])
    # the analytic method gathers too
    img = T.rescanned_line_sted_image(rows, params, geoms["r1.5_b1"],
                                      device="cpu").image
    arrays["analytic"] = img.to_local().numpy()

    # precondition errors (ShardedPreconditionError), each rank alike
    h = W + world                      # divisible by world, not its rows by 2
    facts["errors"] = {
        "not_divisible": _error(lambda: orig(
            torch.zeros(W + 1, W), params,
            T.RescanGeometry(T.Grid(W + 1, W), rescan_factor=1.5, chunk=16),
            mesh)) if world > 1 else None,
        "binning": _error(lambda: orig(
            torch.zeros(h, W), params,
            T.RescanGeometry(T.Grid(h, W), rescan_factor=3.0, binning=2,
                             chunk=16), mesh)) if world > 1 else None,
        # the halo is capped at H/2, so it outgrows a block from 3 ranks
        "halo": _error(lambda: orig(
            sample, params.replace(sigma_det=16.0, det_support=None),
            geoms["r1.5_b1"], mesh)) if world > 2 else None,
        "band_windows": _error(lambda: orig(
            torch.zeros(64, 64), params,
            T.RescanGeometry(T.Grid(64, 64), rescan_factor=1.5, chunk=16),
            mesh)),
        "reassignment": _error(lambda: T.rescanned_line_sted_image(
            rows, params, geoms["r1.5_b1"], method="scan",
            reassignment="nearest", device="cpu")),
        "noise_mode": _error(lambda: T.rescanned_line_sted_image(
            rows, params, geoms["r1.5_b1"], method="scan",
            noise_mode="bogus", device="cpu")),
    }
    cube = distribute_tensor(torch.ones(8, 16, 16), mesh, [Shard(0)],
                             src_data_rank=None)
    facts["row_sharded"] = {
        "3d": engine._row_sharded_mesh(cube) is not None,
        "2d": engine._row_sharded_mesh(distribute_tensor(
            torch.ones(8, 16), mesh, [Shard(0)], src_data_rank=None))
        is not None}

    # a bug past the preconditions surfaces through the auto-route
    rbf = sys.modules["rescan_line_sted_torch.kernels.rescan_banded_fused"]
    kernel = rbf.rescan_banded_fused

    def boom(*a, **kw):
        raise ValueError("engine body bug")

    rbf.rescan_banded_fused = boom
    facts["bug"] = _error(lambda: T.rescanned_line_sted_image(
        rows, params, geoms["r1.5_b1"], method="scan", device="cpu"))
    rbf.rescan_banded_fused = kernel

    # shot noise from per-rank streams (generators seeded alike)
    bright = params.replace(brightness=200.0)
    for mode in ("per_step", "collapsed"):
        img = T.rescanned_line_sted_image(
            rows, bright, geoms["r1.5_b1"], method="scan", noise_mode=mode,
            generator=torch.Generator().manual_seed(7), device="cpu").image
        arrays[f"noisy_{mode}"] = img.to_local().numpy()
    # every rank's block identical: a sample that repeats every H/world rows
    period = sample[:W // world].repeat(world, 1)
    img = T.rescanned_line_sted_image(
        distribute_tensor(period, mesh, [Shard(0)], src_data_rank=None),
        bright, geoms["r1.5_b1"], method="scan", noise_mode="per_step",
        generator=torch.Generator().manual_seed(11), device="cpu").image
    arrays["periodic_per_step"] = img.to_local().numpy()

    # the other entry points gather a row-sharded sample
    small = samples.siemens_star((48, 48), spokes=8, device="cpu")
    small_rows = distribute_tensor(small, mesh, [Shard(0)],
                                   src_data_rank=None)
    line = T.line_sted_image(small_rows, T.LineSTEDParams.create(
        brightness=1.0), T.LineSTEDGeometry(T.Grid(48, 48), chunk=16),
        device="cpu").image
    point = T.point_sted_image(small_rows, T.PointSTEDParams.create(
        brightness=1.0), T.PointSTEDGeometry(T.Grid(48, 48), chunk=48),
        device="cpu").image
    arrays["line_sted_image"] = line.to_local().numpy()
    arrays["point_sted_image"] = point.to_local().numpy()
    facts["gathered_placements"] = [str(p) for p in line.placements]
    arrays["line_full"] = full_tensor(line).numpy()

    ism = T.rescanned_point_sted_image(
        small_rows, T.PointSTEDParams.create(depletion=4.0, brightness=1.0),
        T.RescanPointGeometry(T.Grid(48, 48), rescan_factor=2.0, chunk=48),
        device="cpu").image
    arrays["rescanned_point_sted_image"] = ism.to_local().numpy()

    # views sharded over a batch axis and RL-fused (the fused image comes
    # back replicated); rescan canvases sharded by rows and fused
    from rescan_line_sted_torch.algorithms import richardson_lucy_views
    from rescan_line_sted_torch.algorithms.fusion import (
        multi_orientation_rescan,
        rescan_fusion,
    )
    from rescan_line_sted_torch.imaging.orientations import (
        multi_orientation_line_sted,
    )

    views, kernels = multi_orientation_line_sted(
        small_rows, T.LineSTEDParams.create(brightness=1.0).replace(
            depletion=8.0), T.LineSTEDGeometry(T.Grid(48, 48), chunk=16),
        torch.arange(8) * (math.pi / 8), device="cpu")
    arrays["views"] = views.to_local().numpy()
    facts["views_placements"] = [str(p) for p in views.placements]
    by_view = make_mesh({"batch": world}, devices="cpu")
    fused = richardson_lucy_views(
        *(distribute_tensor(full_tensor(t), by_view, [Shard(0)],
                            src_data_rank=None) for t in (views, kernels)),
        num_iter=10)
    arrays["rl_views"] = fused.to_local().numpy()
    facts["rl_placements"] = [str(p) for p in fused.placements]
    rparams = T.RescanParams.create(depletion=4.0, brightness=100.0)
    rgeom = T.RescanGeometry(T.Grid(48, 48), rescan_factor=2.0, chunk=16)
    turns = (0.0, math.pi / 2)
    canvases = multi_orientation_rescan(small, rparams, rgeom, list(turns),
                                        device="cpu")
    fused = rescan_fusion(
        distribute_tensor(canvases, mesh, [Shard(1)], src_data_rank=None),
        rparams, rgeom, turns, num_iter=10)
    arrays["rescan_fusion"] = fused.to_local().numpy()

    # the batch-sharded sweep
    batch = make_mesh({"batch": world}, devices="cpu")
    sweep_sample = samples.siemens_star((SWEEP_SIZE, SWEEP_SIZE),
                                        device="cpu")
    grid = T.Grid(SWEEP_SIZE, SWEEP_SIZE)

    def sweep(s, p, *gen):
        return dose_matched_sweep(
            s, T.PointSTEDParams.create(brightness=1.0),
            T.LineSTEDParams.create(brightness=1.0),
            T.PointSTEDGeometry(grid, chunk=SWEEP_SIZE),
            T.LineSTEDGeometry(grid, chunk=16), p, 100.0, *gen,
            device="cpu")

    powers = torch.linspace(0.0, 8.0, SWEEP_POWERS)
    got = run_sharded_sweep(sweep, batch, sweep_sample,
                            (shard_batch(batch, powers),))
    for arm in ("point", "line"):
        for col in ("image", "fwhm_x", "fwhm_y", "emitted_signal",
                    "exposure"):
            arrays[f"sweep_{arm}_{col}"] = getattr(
                getattr(got, arm), col).to_local().numpy()
    facts["sweep_placements"] = [str(p) for p in got.point.image.placements]
    facts["sweep_budget_type"] = type(got.dose_budget).__name__
    noisy = run_sharded_sweep(sweep, batch, sweep_sample, (powers,),
                              torch.Generator().manual_seed(5))
    arrays["sweep_noisy_point_image"] = noisy.point.image.to_local().numpy()

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
