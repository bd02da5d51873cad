"""Port parity: TIFF and checkpoint I/O (``rescan_line_sted_torch.io``).

The port's TIFF writer (pure Python and the native C++ codec) writes the
same bytes as the JAX package's for every sample type, single images and
stacks; the JAX suite's round trips, foreign files and rejections
(``tests/test_io.py``, ``tests/test_native_tiff.py``) hold on the port;
checkpoints keep a port sweep result holding tensors, rebuild it with or
without an example of its structure, and refuse a changed structure.
"""

import json
import struct

import numpy as np
import pytest
import torch

from rescan_line_sted_torch.io import (
    SweepCheckpoint,
    array_to_tif,
    load_state,
    save_state,
    tif_to_array,
)
from rescan_line_sted_torch.io.checkpoint import flatten, to_numpy
from rescan_line_sted_torch.io.native import (
    loader,
    native_available,
    tiff_encode_native,
)
from rescan_line_sted_torch.kernels import _build
from rescan_line_sted_torch.sweeps.dose import (
    DoseMatchedComparison,
    ModalitySweep,
)
from rescan_line_sted_tpu.io import array_to_tif as jax_array_to_tif
from rescan_line_sted_tpu.io import save_state as jax_save_state

torch.set_num_threads(1)
DTYPES = [np.uint8, np.uint16, np.float32, np.float64]
SHAPES = {"single": (17, 23), "stack": (5, 8, 12)}


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, np.iinfo(dtype).max, size=shape).astype(dtype)
    return rng.uniform(size=shape).astype(dtype)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_tiff_bytes_match_jax(tmp_path, dtype, shape, native):
    """Each of the port's writers against the JAX package's pure-Python
    writer, byte for byte."""
    if native:
        assert native_available(), "g++ builds the codec here"
    arr = _array(dtype, SHAPES[shape])
    ours, theirs = tmp_path / "port.tif", tmp_path / "jax.tif"
    array_to_tif(arr, str(ours), use_native=native)
    jax_array_to_tif(arr, str(theirs), use_native=False)
    assert _bytes(ours) == _bytes(theirs)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_tiff_roundtrip_single(tmp_path, dtype):
    arr = _array(dtype, (17, 23))
    path = str(tmp_path / "x.tif")
    array_to_tif(arr, path)
    back = tif_to_array(path)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, arr)


def test_tiff_roundtrip_stack_and_casts(tmp_path):
    arr = _array(np.float32, (5, 8, 12), seed=1)
    path = str(tmp_path / "stack.tif")
    array_to_tif(arr, path)
    np.testing.assert_array_equal(tif_to_array(path), arr)
    # an unsupported dtype is written as float32, as in the JAX package
    array_to_tif(np.arange(6, dtype=np.int64).reshape(2, 3), path)
    back = tif_to_array(path)
    assert back.dtype == np.float32 and back.tolist() == [[0, 1, 2],
                                                          [3, 4, 5]]
    with pytest.raises(ValueError, match="expected"):
        array_to_tif(np.zeros((2, 2, 2, 2)), path)


def test_tiff_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.tif")
    with open(path, "wb") as f:
        f.write(b"MM\x00\x99 not a tiff")
    with pytest.raises(ValueError):
        tif_to_array(path)


def test_tiff_rejects_inconsistent_strip_tags(tmp_path):
    """StripOffsets forged to count 2 while StripByteCounts stays 1: the
    strip tables disagree and the file is rejected, not decoded."""
    path = str(tmp_path / "multi.tif")
    array_to_tif(np.zeros((4, 4), np.uint8), path)
    buf = bytearray(_bytes(path))
    (n_entries,) = struct.unpack("<H", buf[8:10])
    for k in range(n_entries):
        base = 10 + 12 * k
        tag, _, _ = struct.unpack("<HHI", buf[base:base + 8])
        if tag == 273:
            buf[base + 4:base + 8] = struct.pack("<I", 2)
    with open(path, "wb") as f:
        f.write(bytes(buf))
    with pytest.raises(ValueError):
        tif_to_array(path)


def test_foreign_multistrip_tiff_roundtrip(tmp_path):
    """A standard writer's (PIL) grayscale TIFFs, multi-strip included."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for name, arr in (
            ("u16", rng.integers(0, 65535, size=(512, 256), dtype=np.uint16)),
            ("u8", rng.integers(0, 255, size=(300, 77), dtype=np.uint8)),
            ("f32", rng.uniform(size=(96, 64)).astype(np.float32))):
        p = str(tmp_path / f"foreign_{name}.tif")
        Image.fromarray(arr).save(p, compression=None)
        np.testing.assert_array_equal(tif_to_array(p), arr)


def test_foreign_tiff_rejects_unsupported(tmp_path):
    """Compressed / RGB files are rejected, not mis-decoded."""
    from PIL import Image

    p = str(tmp_path / "rgb.tif")
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(p, compression=None)
    with pytest.raises(ValueError):
        tif_to_array(p)
    pc = str(tmp_path / "lzw.tif")
    Image.fromarray(np.zeros((64, 64), np.uint8)).save(
        pc, compression="tiff_lzw")
    with pytest.raises(ValueError):
        tif_to_array(pc)


def test_native_codec_builds_into_the_build_directory():
    assert native_available()
    path = loader.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("_tiff_fast_")


@pytest.mark.parametrize("dtype", [np.uint16, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_native_roundtrip(tmp_path, dtype):
    arr = _array(dtype, (4, 33, 47), seed=1)
    path = str(tmp_path / "x.tif")
    array_to_tif(arr, path, use_native=True)
    np.testing.assert_array_equal(tif_to_array(path), arr)


def test_native_encoded_size_and_default_route(tmp_path):
    """A [16, 256, 256] float32 stack (4 MiB: the native route by default)
    encodes to the baseline layout's size, byte-identical to the
    pure-Python writer."""
    arr = _array(np.float32, (16, 256, 256), seed=2)
    blob = tiff_encode_native(arr)
    assert len(blob) == 8 + 16 * (2 + 9 * 12 + 4 + 256 * 256 * 4)
    auto, py = tmp_path / "auto.tif", tmp_path / "py.tif"
    array_to_tif(arr, str(auto))
    array_to_tif(arr, str(py), use_native=False)
    assert _bytes(auto) == _bytes(py) == blob.tobytes()


def _result(device="cpu", frc=False):
    """A port dose-sweep result holding tensors (two arms, ISM absent)."""
    g = torch.Generator().manual_seed(0)

    def arm():
        col = torch.rand(3, generator=g)
        return ModalitySweep(
            torch.rand(3, 4, 5, generator=g), col, col + 1, col + 2,
            col + 3, col + 4, frc_resolution=col + 5 if frc else None)

    return DoseMatchedComparison(
        torch.tensor([0.0, 4.0, 8.0]), torch.tensor(100.0), arm(), arm(),
        rescan=arm())


def test_state_roundtrip_of_a_sweep_result(tmp_path):
    res = _result()
    path = str(tmp_path / "res.npz")
    save_state(path, res)
    for back in (load_state(path), load_state(path, like=res)):
        assert type(back) is DoseMatchedComparison
        assert type(back.point) is ModalitySweep and back.ism is None
        assert back.point.frc_resolution is None
        _, want = flatten(res)
        _, got = flatten(back)
        assert list(got) == list(want)
        for key, leaf in want.items():
            assert isinstance(got[key], np.ndarray)
            np.testing.assert_array_equal(got[key], leaf.numpy())
    assert load_state(path).dose_budget.shape == ()
    host = to_numpy(res)
    assert isinstance(host.rescan.image, np.ndarray)
    np.testing.assert_array_equal(host.line.fwhm_y, res.line.fwhm_y)


def test_state_roundtrip(tmp_path):
    tree = {"a": np.arange(5.0), "b": (np.ones((2, 3)), np.int32(7)),
            "c": [torch.ones(2, dtype=torch.float64), None]}
    path = str(tmp_path / "state.npz")
    save_state(path, tree)
    back = load_state(path, tree)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    assert back["b"][1] == 7 and isinstance(back["b"], tuple)
    assert isinstance(back["c"], list) and back["c"][1] is None
    assert back["c"][0].dtype == np.float64
    assert json.loads(json.dumps(load_state(path)["a"].tolist())) == \
        [0.0, 1.0, 2.0, 3.0, 4.0]


def test_load_state_rejects_structure_mismatch(tmp_path):
    path = str(tmp_path / "state.npz")
    save_state(path, {"a": np.arange(5.0), "b": np.ones((2, 3))})
    with pytest.raises(ValueError, match="treedef mismatch"):
        load_state(path, {"a": np.arange(5.0), "c": np.ones((2, 3))})
    with pytest.raises(ValueError, match="leaf 0 mismatch"):
        load_state(path, {"a": np.arange(4.0), "b": np.ones((2, 3))})
    with pytest.raises(ValueError, match="leaf 1 mismatch"):
        load_state(path, {"a": np.arange(5.0),
                          "b": np.ones((2, 3), np.float32)})
    # a tensor's dtype and shape are held the same way
    with pytest.raises(ValueError, match="leaf 1 mismatch"):
        load_state(path, {"a": np.arange(5.0),
                          "b": torch.ones((2, 3), dtype=torch.float32)})
    # a sweep result with the FRC column against one without
    res = _result()
    save_state(path, res)
    with pytest.raises(ValueError, match="treedef mismatch"):
        load_state(path, like=_result(frc=True))


def test_jax_checkpoints_are_refused(tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_save_state(path, {"a": np.arange(3.0)})
    with pytest.raises(ValueError, match="not written by"):
        load_state(path)


def test_sweep_checkpoint_resume(tmp_path):
    ckpt = SweepCheckpoint(str(tmp_path / "ck"))
    calls = []

    def run_all():
        out, example = [], None
        for i in range(4):
            if ckpt.has(i):
                res = ckpt.load(i, like=example)
            else:
                calls.append(i)
                res = {"x": torch.full((3,), float(i))}
                ckpt.save(i, res)
            example = res if example is None else example
            out.append(res)
        return out

    first = run_all()
    assert calls == [0, 1, 2, 3]
    second = run_all()          # resumes: no recomputation
    assert calls == [0, 1, 2, 3]
    assert ckpt.completed() == [0, 1, 2, 3]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["x"].numpy(), b["x"])
    ckpt.write_meta(n=4)
    assert ckpt.read_meta() == {"n": 4}


def test_completed_skips_stale_tmp_files(tmp_path):
    """A chunk_*.npz.tmp.npz left by an interrupted save must neither crash
    completed() nor count as a finished chunk."""
    ckpt = SweepCheckpoint(str(tmp_path / "ck"))
    ckpt.save(0, {"x": torch.zeros(2)})
    with open(tmp_path / "ck" / "chunk_00003.npz.tmp.npz", "wb") as f:
        f.write(b"torn")
    assert ckpt.completed() == [0]
    assert not ckpt.has(3)
