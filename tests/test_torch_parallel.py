"""The port's ``parallel`` package on gloo worlds of CPU ranks, after
``tests/test_mesh.py`` and ``tests/test_seed_streams.py``.

Each world of 1, 2 and 4 ranks is spawned once per module
(``tests/torch_parallel_worker.py``, joined through a ``FileStore`` under
``tmp_path``: no port is fixed, so xdist workers never collide); the ranks
write their canvas rows, sweep columns and facts there, and the tests below
compare them: with the JAX package's ``rescanned_line_sted_sharded`` on a
virtual mesh of the same size, with the port's unsharded engines, and with
the JAX suite's expectations. Noise-free parity is held at 2e-5 relative,
as the JAX test holds it.
"""

import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import rescan_line_sted_torch as T
import rescan_line_sted_tpu as J
from rescan_line_sted_torch.data import samples
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.kernels.poisson import poisson_flat
from rescan_line_sted_torch.kernels.rescan_banded_fused import (
    banded_plan,
    rescan_banded_fused,
)
from rescan_line_sted_torch.parallel import (
    initialize_multihost,
    is_initialized,
    local_device_slice,
    make_mesh,
)
from rescan_line_sted_torch.parallel.mesh import _shard_sizes
from rescan_line_sted_torch.parallel.sharded_rescan import rank_key
from rescan_line_sted_torch.sweeps import dose_matched_sweep
from rescan_line_sted_torch.sweeps.mesh import rank_generator
from rescan_line_sted_tpu import imaging as jimaging
from rescan_line_sted_tpu.data import samples as jsamples
from rescan_line_sted_tpu.parallel import make_mesh as jmake_mesh
from rescan_line_sted_tpu.parallel.sharded_rescan import (
    rescanned_line_sted_sharded as jax_sharded,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
sys.path.insert(0, os.path.dirname(WORKER))
import torch_parallel_worker as worker  # noqa: E402

WORLDS = (1, 2, 4)
W = worker.W
CASES = worker.CASES
TOL = 1e-5
PARAMS = dict(sigma_exc=1.2, sigma_det=1.2, depletion=4.0, brightness=50.0)


class Worlds:
    """The spawned worlds: ``result(n)`` waits for world ``n`` and returns
    its ranks' arrays and facts."""

    def __init__(self, root):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self.dirs, self.procs, self.done = {}, {}, {}
        for n in WORLDS:
            out = root / f"world{n}"
            out.mkdir()
            self.dirs[n] = out
            self.procs[n] = [subprocess.Popen(
                [sys.executable, WORKER, str(r), str(n), str(out / "store"),
                 str(out)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(n)]

    def result(self, n):
        if n not in self.done:
            logs = [p.communicate(timeout=240)[0] for p in self.procs[n]]
            for r, (p, log) in enumerate(zip(self.procs[n], logs)):
                assert p.returncode == 0, f"world {n} rank {r}:\n{log[-3000:]}"
            self.done[n] = [
                (dict(np.load(self.dirs[n] / f"rank{r}.npz")),
                 json.loads((self.dirs[n] / f"rank{r}.json").read_text()))
                for r in range(n)]
        return self.done[n]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    spawned = Worlds(tmp_path_factory.mktemp("worlds"))
    yield spawned
    spawned.close()


def _rows(world, n, name):
    """The whole array ``name`` from its ranks' row blocks."""
    return np.concatenate([arrays[name] for arrays, _ in world(n)], axis=0)


def _facts(world, n):
    return [facts for _, facts in world(n)]


def _geom(name):
    r, b = CASES[name]
    return T.RescanGeometry(T.Grid(W, W), rescan_factor=r, binning=b,
                            chunk=16)


def _sample():
    return samples.siemens_star((W, W), spokes=10, device="cpu") * 3.0


def _params(**kw):
    return T.LineSTEDParams.create(**{**PARAMS, **kw})


_UNSHARDED = {}
_JAX = {}


def _unsharded(name, **kw):
    key = (name, tuple(sorted(kw.items())))
    if key not in _UNSHARDED:
        _UNSHARDED[key] = T.rescanned_line_sted_image(
            _sample(), _params(), _geom(name), method="scan", device="cpu",
            **kw).image.numpy()
    return _UNSHARDED[key]


def _jax_sharded(name, n):
    """The JAX package's sharded engine on a virtual mesh of ``n``."""
    if (name, n) not in _JAX:
        r, b = CASES[name]
        mesh = jmake_mesh({"space": n}, jax.devices()[:n])
        sample = jax.device_put(
            jsamples.siemens_star((W, W), spokes=10) * 3.0,
            NamedSharding(mesh, P("space", None)))
        geom = J.RescanGeometry(J.Grid(W, W), rescan_factor=r, binning=b,
                                chunk=16)
        _JAX[(name, n)] = np.asarray(jax_sharded(
            sample, J.LineSTEDParams.create(**PARAMS), geom, mesh).image)
    return _JAX[(name, n)]


def _close(got, want, tol=TOL):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


SHARDED = [(n, c) for n in WORLDS if n > 1 for c in CASES]


@pytest.mark.parametrize("n,case", SHARDED,
                         ids=[f"world{n}-{c}" for n, c in SHARDED])
@pytest.mark.parametrize("entry", ["routed", "explicit"])
def test_sharded_matches_jax_sharded(worlds, n, case, entry):
    want = _jax_sharded(case, n)
    got = _rows(worlds.result, n, f"{entry}_{case}")
    assert got.shape == _geom(case).canvas_shape
    _close(got, want)


ALL = [(n, c) for n in WORLDS for c in CASES]


@pytest.mark.parametrize("n,case", ALL,
                         ids=[f"world{n}-{c}" for n, c in ALL])
@pytest.mark.parametrize("entry", ["routed", "explicit"])
def test_sharded_matches_unsharded(worlds, n, case, entry):
    _close(_rows(worlds.result, n, f"{entry}_{case}"), _unsharded(case))


@pytest.mark.parametrize("n,case", ALL,
                         ids=[f"world{n}-{c}" for n, c in ALL])
def test_auto_route_engages_on_row_sharded_samples(worlds, n, case):
    """A row-sharded sample routes onto the sharded engine where the mesh
    axis has more than one rank; a one-rank axis is not row-sharded (the
    gathered route). Either way the canvas comes back as row shards."""
    for facts in _facts(worlds.result, n):
        assert facts[f"routed_{case}"]["engaged"] == (["space"] if n > 1
                                                      else [])
        assert facts[f"routed_{case}"]["placements"] == ["S(0)"]


@pytest.mark.parametrize("n", WORLDS)
def test_gathered_route_on_precondition_error(worlds, n):
    """A geometry without band windows (a chunk whose frame window is not
    narrower than the frame) refuses inside the sharded engine: the route
    attempts it, catches the ``ShardedPreconditionError`` and runs the
    unsharded engine on the gathered sample, returned by rows."""
    for facts in _facts(worlds.result, n):
        assert facts["unbanded"]["engaged"] == (["space"] if n > 1 else [])
        assert facts["unbanded"]["placements"] == ["S(0)"]
        assert facts["unbanded_error"].startswith(
            "ShardedPreconditionError: no static band windows")
    wide = T.RescanGeometry(T.Grid(W, W), rescan_factor=1.5,
                            chunk=worker.WIDE_CHUNK)
    want = T.rescanned_line_sted_image(_sample(), _params(), wide,
                                       method="scan", device="cpu")
    _close(_rows(worlds.result, n, "unbanded"), want.image.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_second_sharded_call_builds_no_tables(worlds, n):
    """The sharded engine takes the entry's plan: a second call of a
    geometry opens no ``rls.plan_build`` and no ``rls.read_back`` span,
    on every case (classes, binning, NUFFT spreading)."""
    for facts in _facts(worlds.result, n):
        assert facts["second_call"] == {c: [] for c in CASES}


@pytest.mark.parametrize("n", WORLDS)
def test_not_row_sharded_samples_take_the_gathered_route(worlds, n):
    """A replicated sample and the analytic method gather: the same image
    as the unsharded engine, placed as the sample."""
    arrays = [a for a, _ in worlds.result(n)]
    for a, facts in zip(arrays, _facts(worlds.result, n)):
        assert facts["replicated"] == {"engaged": [], "placements": ["R"]}
        _close(a["replicated"], _unsharded("r1.5_b1"))
    want = T.rescanned_line_sted_image(_sample(), _params(),
                                       _geom("r1.5_b1"),
                                       device="cpu").image.numpy()
    _close(_rows(worlds.result, n, "analytic"), want)


PRECONDITIONS = {
    "not_divisible": (2, "ShardedPreconditionError: H=193 not divisible "
                         "by mesh axis space="),
    "binning": (2, "ShardedPreconditionError: per-device rows"),
    "halo": (3, "ShardedPreconditionError: halo 96 px exceeds the "
                "per-device row block"),
    "band_windows": (1, "ShardedPreconditionError: no static band windows"),
}
ERROR_CASES = [(n, k) for n in WORLDS for k, (least, _) in
               PRECONDITIONS.items() if n >= least]


@pytest.mark.parametrize("n,kind", ERROR_CASES,
                         ids=[f"world{n}-{k}" for n, k in ERROR_CASES])
def test_precondition_errors(worlds, n, kind):
    """The explicit sharded API raises (never falls back) when its
    preconditions fail, with the JAX engine's messages."""
    for facts in _facts(worlds.result, n):
        assert facts["errors"][kind].startswith(PRECONDITIONS[kind][1])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind,message", [
    ("reassignment", "ValueError: unknown reassignment 'nearest'"),
    ("noise_mode", "ValueError: unknown noise_mode 'bogus'")])
def test_row_sharded_call_validates_arguments_like_unsharded(
        worlds, n, kind, message):
    """Same arguments, same validation, sharded or not: a plain
    ``ValueError``, never a ``ShardedPreconditionError`` swallowed into a
    fallback."""
    for facts in _facts(worlds.result, n):
        assert facts["errors"][kind] == message
    with pytest.raises(ValueError, match=message.split(": ")[1]):
        T.rescanned_line_sted_image(_sample(), _params(), _geom("r1.5_b1"),
                                    method="scan", device="cpu",
                                    **{kind: message.split("'")[1]})


@pytest.mark.parametrize("n", [n for n in WORLDS if n > 1])
def test_auto_route_surfaces_post_precondition_bugs(worlds, n):
    """A bug inside the sharded engine's body raises through the
    auto-route instead of rerouting onto the gathered path."""
    for facts in _facts(worlds.result, n):
        assert facts["bug"] == "ValueError: engine body bug"


@pytest.mark.parametrize("n", WORLDS)
def test_row_sharded_mesh_rejects_non_2d(worlds, n):
    for facts in _facts(worlds.result, n):
        assert facts["row_sharded"] == {"3d": False, "2d": n > 1}


@pytest.mark.parametrize("n", WORLDS)
def test_make_mesh_sizes(worlds, n):
    for facts in _facts(worlds.result, n):
        assert facts["mesh_default"] == [["batch"], [n]]
        assert facts["mesh_bad"] == (f"ValueError: mesh axes {{'batch': "
                                     f"{n + 1}}} need {n + 1} devices, "
                                     f"got {n}")


def test_make_mesh_validates_sizes_before_wiring():
    with pytest.raises(ValueError, match="need 3 devices, got 1"):
        make_mesh({"batch": 3}, devices="cpu")
    assert not is_initialized()


@pytest.mark.parametrize("n", WORLDS)
def test_initialize_multihost_explicit_wiring_is_idempotent(worlds, n):
    for r, facts in enumerate(_facts(worlds.result, n)):
        assert facts["init"] == [r, n] and facts["init_again"] == [r, n]
        assert facts["is_initialized"]
        # gloo takes CPU tensors as they are, CUDA tensors through the host
        assert facts["host_staged"] == [False, True]


def test_initialize_multihost_is_a_noop_without_cluster_env(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() == (0, 1)
    assert not is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_multihost(num_processes=2, process_id=0)


def test_initialize_multihost_refuses_nccl_on_shared_cards(monkeypatch):
    """More ranks on a host than cards cannot run over NCCL: the call
    names gloo and never switches backends itself."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        initialize_multihost("localhost:1", num_processes=2, process_id=0,
                             backend="nccl")
    assert not is_initialized()


CLUSTER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "SLURM_PROCID", "SLURM_NTASKS")


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"RANK": "1", "WORLD_SIZE": "4", "MASTER_ADDR": "h",
      "MASTER_PORT": "7"}, ("env://", 4, 1)),
    ({"SLURM_PROCID": "2", "SLURM_NTASKS": "4", "MASTER_ADDR": "h",
      "MASTER_PORT": "9"}, ("tcp://h:9", 4, 2)),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, None)],
    ids=["none", "torchrun", "slurm", "slurm_one_task"])
def test_cluster_env(monkeypatch, env, want):
    """torchrun's and SLURM's environments wire the group; none, or one
    SLURM task, is a single process."""
    from rescan_line_sted_torch.parallel.multihost import _cluster_env

    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert _cluster_env() == want


def test_slurm_without_a_coordinator_raises(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize_multihost()
    assert not is_initialized()


@pytest.mark.parametrize("cards,on_host,want", [
    (0, 1, "gloo"), (0, 4, "gloo"), (1, 1, "nccl"), (1, 2, "gloo"),
    (4, 4, "nccl"), (4, 8, "gloo")])
def test_default_backend(monkeypatch, cards, on_host, want):
    """NCCL where every rank on the host has a card of its own, else gloo
    (CPU ranks, or ranks sharing cards)."""
    from rescan_line_sted_torch.parallel.multihost import _backend

    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(on_host))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert _backend(None, 16) == want
    assert _backend("gloo", 16) == "gloo"


@pytest.mark.parametrize("n", WORLDS)
def test_local_device_slice_of_a_mesh(worlds, n):
    """Each rank owns its own coordinate's index on every axis."""
    for facts in _facts(worlds.result, n):
        b, s = facts["coordinate"]
        assert facts["local_slice"] == {"batch": [b, b + 1],
                                        "space": [s, s + 1]}


def test_local_device_slice_ownership_semantics():
    """Ownership is read off the mesh's rank array: contiguous blocks slice,
    an axis this process touches at every index returns the full range,
    non-contiguous ownership and no ownership raise (the JAX suite's
    cases; this process is rank 0)."""
    def mesh(names, ranks):
        return types.SimpleNamespace(mesh_dim_names=names,
                                     mesh=torch.tensor(ranks))

    two_by_four = mesh(("batch", "space"), [[0, 0], [0, 0], [1, 1], [1, 1]])
    assert local_device_slice(two_by_four, "batch") == (0, 2)
    assert local_device_slice(two_by_four, "space") == (0, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        local_device_slice(mesh(("batch",), [[0], [1], [0], [1]]), "batch")
    with pytest.raises(ValueError, match="owns no devices"):
        local_device_slice(mesh(("batch",), [[1], [1]]), "batch")


@pytest.mark.parametrize("n", WORLDS)
def test_per_step_noise_statistics(worlds, n):
    """Per-step noise on row shards: the total within 6 sigma of the
    noise-free canvas and the residual power at the Poisson variance, as
    the JAX suite holds the sharded noisy scan."""
    expected = T.rescanned_line_sted_image(
        _sample(), _params(brightness=200.0), _geom("r1.5_b1"),
        method="scan", device="cpu").image.double().numpy()
    noisy = _rows(worlds.result, n, "noisy_per_step").astype(np.float64)
    etotal = expected.sum()
    assert etotal > 1e4
    assert abs(noisy.sum() - etotal) / np.sqrt(etotal) < 6.0
    assert 0.75 < ((noisy - expected) ** 2).sum() / etotal < 1.3
    collapsed = _rows(worlds.result, n, "noisy_collapsed")
    assert np.isfinite(collapsed).all()
    assert abs(collapsed.sum() - etotal) / np.sqrt(etotal) < 6.0


@pytest.mark.parametrize("n", [n for n in WORLDS if n > 1])
def test_rank_streams_are_independent(worlds, n):
    """A sample that repeats every H/n rows gives every rank the same
    block; with per-rank key words their counts still differ, and the
    correlation of two ranks' residuals lies within 5/sqrt(N) of 0."""
    blocks = [a["periodic_per_step"].astype(np.float64)
              for a, _ in worlds.result(n)]
    clean = T.rescanned_line_sted_image(
        _sample()[:W // n].repeat(n, 1), _params(brightness=200.0),
        _geom("r1.5_b1"), method="scan", device="cpu").image.double()
    mean = clean.numpy()[:blocks[0].shape[0]]
    for i in range(n):
        for j in range(i + 1, n):
            assert not np.array_equal(blocks[i], blocks[j])
            a, b = (blocks[i] - mean).ravel(), (blocks[j] - mean).ravel()
            corr = float(np.corrcoef(a, b)[0, 1])
            assert abs(corr) < 5.0 / math.sqrt(a.size), corr


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("entry", ["line_sted_image", "point_sted_image"])
def test_gathered_entry_points(worlds, n, entry):
    """``line_sted_image`` and ``point_sted_image`` take a row-sharded
    sample as GSPMD lets the JAX ones: the unsharded image, by rows."""
    small = jsamples.siemens_star((48, 48), spokes=8)
    if entry == "line_sted_image":
        want = jimaging.line_sted_image(small, J.LineSTEDParams.create(
            brightness=1.0), J.LineSTEDGeometry(J.Grid(48, 48), chunk=16))
    else:
        want = jimaging.point_sted_image(small, J.PointSTEDParams.create(
            brightness=1.0), J.PointSTEDGeometry(J.Grid(48, 48), chunk=48))
    _close(_rows(worlds.result, n, entry), np.asarray(want.image))
    for arrays, facts in worlds.result(n):
        assert facts["gathered_placements"] == ["S(0)"]
        _close(arrays["line_full"], _rows(worlds.result, n,
                                          "line_sted_image"), 0.0)


@pytest.mark.parametrize("n", WORLDS)
def test_gathered_ism(worlds, n):
    want = jimaging.rescanned_point_sted_image(
        jsamples.siemens_star((48, 48), spokes=8),
        J.PointSTEDParams.create(depletion=4.0, brightness=1.0),
        J.RescanPointGeometry(J.Grid(48, 48), rescan_factor=2.0, chunk=48))
    _close(_rows(worlds.result, n, "rescanned_point_sted_image"),
           np.asarray(want.image))


_FUSED = {}


def _jax_fused():
    """The JAX suite's sharded-fusion cases, unsharded (test_mesh.py)."""
    if not _FUSED:
        from rescan_line_sted_tpu.algorithms import richardson_lucy_views
        from rescan_line_sted_tpu.algorithms.fusion import (
            multi_orientation_rescan, rescan_fusion)
        from rescan_line_sted_tpu.imaging.orientations import (
            multi_orientation_line_sted)

        small = jsamples.siemens_star((48, 48), spokes=8)
        views, kernels = multi_orientation_line_sted(
            small, J.LineSTEDParams.create(brightness=1.0).replace(
                depletion=jax.numpy.float32(8.0)),
            J.LineSTEDGeometry(J.Grid(48, 48), chunk=16),
            jax.numpy.arange(8) * (np.pi / 8))
        _FUSED["views"] = np.asarray(views)
        _FUSED["rl_views"] = np.asarray(richardson_lucy_views(
            views, kernels, num_iter=10))
        params = J.RescanParams.create(depletion=4.0, brightness=100.0)
        geom = J.RescanGeometry(J.Grid(48, 48), rescan_factor=2.0, chunk=16)
        angles = (0.0, float(np.pi / 2))
        canvases = multi_orientation_rescan(small, params, geom,
                                            list(angles))
        _FUSED["rescan_fusion"] = np.asarray(rescan_fusion(
            canvases, params, geom, angles, num_iter=10))
    return _FUSED


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_fusion(worlds, n):
    """Orientation views of a row-sharded sample, their RL fusion with the
    views sharded over a batch axis, and rescan fusion of canvases sharded
    by rows, against the JAX package (the JAX suite's tolerances: 2e-4
    relative, 1e-5 absolute, for the fused images)."""
    want = _jax_fused()
    views = np.concatenate([a["views"] for a, _ in worlds.result(n)], axis=1)
    _close(views, want["views"])
    for arrays, facts in worlds.result(n):
        assert facts["views_placements"] == ["S(1)"]
        assert facts["rl_placements"] == ["R"]
        np.testing.assert_allclose(arrays["rl_views"], want["rl_views"],
                                   rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(_rows(worlds.result, n, "rescan_fusion"),
                               want["rescan_fusion"], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_sweep_matches_unsharded(worlds, n):
    """``run_sharded_sweep``: every column of both arms against the
    unsharded sweep, and the result really is distributed."""
    size = worker.SWEEP_SIZE
    grid = T.Grid(size, size)
    want = dose_matched_sweep(
        samples.siemens_star((size, size), device="cpu"),
        T.PointSTEDParams.create(brightness=1.0),
        T.LineSTEDParams.create(brightness=1.0),
        T.PointSTEDGeometry(grid, chunk=size),
        T.LineSTEDGeometry(grid, chunk=16),
        torch.linspace(0.0, 8.0, worker.SWEEP_POWERS), 100.0, device="cpu")
    for arm in ("point", "line"):
        for col in ("image", "fwhm_x", "fwhm_y", "emitted_signal",
                    "exposure"):
            _close(_rows(worlds.result, n, f"sweep_{arm}_{col}"),
                   getattr(getattr(want, arm), col).numpy())
    for facts in _facts(worlds.result, n):
        assert facts["sweep_placements"] == ["S(0)"]
        assert facts["sweep_budget_type"] == "Tensor"
    noisy = _rows(worlds.result, n, "sweep_noisy_point_image")
    clean = want.point.image.double().numpy()
    for got, mean in zip(noisy, clean):      # every point's total
        assert abs(got.sum() - mean.sum()) <= 5 * math.sqrt(mean.sum()) + 1


def test_shard_sizes_follow_torch_chunk():
    for length in (1, 7, 8, 9, 193):
        for n in (1, 2, 3, 4, 8):
            want = [c.shape[0] for c in torch.arange(length).chunk(n)]
            assert _shard_sizes(length, n)[:len(want)] == want
            assert sum(_shard_sizes(length, n)) == length


# ---- the seed streams (tests/test_seed_streams.py's accounting) ----

@pytest.mark.parametrize("world", range(1, 9))
@pytest.mark.parametrize("form", ["ints", "tensor"])
def test_rank_key_words_are_distinct_and_rank0_is_unsharded(world, form):
    """The ranks' key words are pairwise distinct, and rank 0's are the
    words an unsharded call draws from the same generator state (a CPU
    generator gives ints; a key held as a tensor stays one)."""
    keys = []
    for r in range(world):
        key = rank_key(torch.Generator().manual_seed(123), "cpu", r)
        if form == "tensor":
            key = _build.offset_key(torch.tensor(
                _build.draw_key(torch.Generator().manual_seed(123), "cpu")),
                r)
            assert key.dtype == torch.int64
            key = tuple(key.tolist())
        keys.append(tuple(key))
    assert len(set(keys)) == world
    s0, s1, _ = _build.key_words(torch.Generator().manual_seed(123), "cpu")
    assert keys[0] == (s0, s1)
    assert all(0 <= w < _build.KEY_MOD for k in keys for w in k)
    assert rank_key(None, "cpu", 3) is None


def test_offset_key_wraps_modulo_the_key_range():
    assert _build.offset_key((5, _build.KEY_MOD - 1), 2) == (5, 1)
    got = _build.offset_key(torch.tensor([5, _build.KEY_MOD - 1]), 2)
    assert got.tolist() == [5, 1]


def _k1_sample_and_plan():
    """A sample and K1's plan for it (``banded_plan``)."""
    rng = np.random.default_rng(0)
    w, h = 64, 32
    sample_y = torch.from_numpy(rng.random((h, w), np.float32)) * 5.0
    x = torch.arange(w, dtype=torch.float32) - w // 2
    eff = torch.exp(-0.5 * (x / 3.0) ** 2)
    gx = torch.exp(-0.5 * (x / 2.0) ** 2)
    offsets = torch.arange(w, dtype=torch.int32) // 2
    return sample_y, banded_plan(eff, gx, offsets, wc=128, d_in=32,
                                 d_out=32, chunk=16)


@pytest.mark.parametrize("kernel", ["k1", "k2c"])
def test_key_argument_seeds_the_draws(kernel):
    """K1's and K2c's ``key``: the same words give the same counts,
    different words different ones (the plain versions, drawing from
    ``key_generator``); a generator and a key together are refused."""
    if kernel == "k1":
        sample_y, plan = _k1_sample_and_plan()

        def run(**k):
            return rescan_banded_fused(sample_y, plan, **k)
    else:
        lam = torch.full((64, 64), 3.0)

        def run(**k):
            return poisson_flat(lam, **k)
    a, b, c = run(key=(1, 2)), run(key=(1, 2)), run(key=(1, 3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(key=torch.tensor([1, 2])), a)
    with pytest.raises(ValueError, match="not both|or key words"):
        run(key=(1, 2), generator=torch.Generator().manual_seed(0))
    if kernel == "k2c":
        with pytest.raises(ValueError, match="generator or key words"):
            poisson_flat(lam)


def test_rank_generators_are_distinct():
    draws = [torch.rand(4, generator=rank_generator(
        torch.Generator().manual_seed(9), r)) for r in range(4)]
    assert all(not torch.equal(draws[i], draws[j])
               for i in range(4) for j in range(i + 1, 4))
