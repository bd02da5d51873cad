"""K6's per-unit bounds (``chip_smoke.py``: ``UNIT_RATES``, ``BODY_NEEDS``,
``unit_work``, ``unit_bound``, ``sass_unit``, ``sass_loop``,
``sass_counts``, ``sass_shortfall``) and the smoke's Philox terms of K3 and
K4 (``fma_philox_work``), on fixed numbers: an H100's 132 SMs at 1.98 GHz,
what one rep of each body's function needs, and the instructions per rep
that ``cuobjdump -sass`` gave for each body of the sm_90a build.
"""

import importlib.util
import math
import os

import pytest
import torch

from rescan_line_sted_torch.kernels import primitives as prim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS, CLOCK = 132, 1.98e9
SM_CLOCKS = SMS * CLOCK          # 2.6136e11 SM-clocks a second


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_bounds", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
# the busiest unit of each body and its SM-clocks per thread and rep, from
# its needs: a product is two integer multiply slots (64 a clock), every
# instruction one issue slot (128 a clock)
BUSIEST = {"fma": ("FP32", 1 / 128),
           "uniform": ("integer multiply", 2 * 15 / 64),
           "uniform_block": ("integer multiply", 2 * 16 / 64),
           "exp": ("issue", 9 / 128),
           "inv_term": ("issue", 4 / 128),
           "knuth_round": ("integer multiply", 2 * 4 / 64)}
# per rep, by sass_unit (the sm_90a build's loop bodies)
SASS_PER_REP = {
    "fma": {"instructions": 1.0625, "ALU": 0.046875, "FP32": 1.0},
    "uniform": {"instructions": 58.125, "ALU": 28.1875,
                "integer multiply": 3.8125, "product": 19.875,
                "I2FP": 1.0, "FP32": 2.0},
    "uniform_block": {"instructions": 59.5625, "product": 19.9375,
                      "ALU": 25.75, "integer multiply": 1.1875,
                      "I2FP": 4.0, "FP32": 8.0},
    "exp": {"instructions": 9.3125, "ALU": 1.125, "FP32": 7.0, "MUFU": 1.0},
    "inv_term": {"instructions": 4.1875, "FP32": 3.0, "ALU": 1.0625},
    "knuth_round": {"instructions": 16.125, "ALU": 7.0625, "product": 4.25,
                    "integer multiply": 0.125, "I2FP": 1.0,
                    "FP32": 3.0},
}


def test_unit_rates_are_the_guides():
    assert SMOKE.UNIT_RATES == {
        "FP32": 128, "integer multiply": 64, "ALU": 64, "MUFU": 16,
        "conversion": 16, "I2FP": 64, "issue": 128, "shared memory": 128}
    ms, unit, t = SMOKE.unit_bound({"FP32": 128 * SM_CLOCKS,
                                    "MUFU": 8 * SM_CLOCKS}, SMS, CLOCK)
    assert unit == "FP32" and math.isclose(ms, 1e3)
    assert math.isclose(t["MUFU"], 500.0)
    # 2 flops per FP32 FMA: the datasheet's 67 TFLOP/s within 0.2%
    assert math.isclose(2 * 128 * SM_CLOCKS, 67e12, rel_tol=2e-3)


def test_unit_work_charges_products_and_issue():
    """A product takes IMAD_WIDE_SLOTS integer multiply slots; every
    instruction of the needs takes one issue slot."""
    assert SMOKE.IMAD_WIDE_SLOTS == 2
    w = SMOKE.unit_work({"product": 4, "ALU": 6, "I2FP": 1, "FP32": 3}, 10)
    assert w == {"issue": 140, "integer multiply": 80, "ALU": 60,
                 "I2FP": 10, "FP32": 30}
    assert SMOKE.PHILOX_BLOCK == {"product": 16, "ALU": 16}
    assert SMOKE.BODY_NEEDS["knuth_round"]["product"] * 4 == 16
    assert SMOKE.BODY_NEEDS["uniform_block"]["product"] == 16


@pytest.mark.parametrize("name", list(BUSIEST))
def test_elementwise_bound_is_the_busiest_unit(name):
    """A rate call of FILL threads x reps: its bound is the busiest unit's
    time under the body's needs, above the output's HBM bytes."""
    reps = 1024
    work = SMOKE.unit_work(SMOKE.BODY_NEEDS[name], prim.FILL * reps)
    ms, unit, t = SMOKE.unit_bound(work, SMS, CLOCK, 4 * prim.FILL)
    want_unit, clocks = BUSIEST[name]
    assert unit == want_unit
    assert math.isclose(ms, 1e3 * clocks * prim.FILL * reps / SM_CLOCKS)
    assert all(v <= ms for v in t.values())
    assert math.isclose(t["HBM"], 1e3 * 4 * prim.FILL / 3.35e12)


def test_elementwise_bound_falls_to_hbm_on_one_rep():
    work = SMOKE.unit_work(SMOKE.BODY_NEEDS["fma"], prim.FILL)
    ms, unit, _ = SMOKE.unit_bound(work, SMS, CLOCK, 4 * prim.FILL)
    assert unit == "HBM" and math.isclose(ms, 1e3 * 4 * prim.FILL / 3.35e12)


@pytest.mark.parametrize("reps,unit", [(100, "HBM"), (1000, "shared memory")])
def test_place_add_bound(reps, unit):
    """place_add: a load and a store of 4 bytes per window element at 128
    bytes a clock per SM (4352 SM-clocks a window), against the canvases
    read and written once (0.124 ms at the rate call's 33 canvases)."""
    g = prim.PLACE_CANVASES
    smem = 8.0 * g * reps * prim.WINDOW
    nbytes = 4 * (2 * g * prim.CANVAS_ROWS * prim.COLS + prim.WINDOW + reps)
    ms, got, t = SMOKE.unit_bound({"shared memory": smem}, SMS, CLOCK, nbytes)
    assert got == unit
    assert math.isclose(t["shared memory"], 1e3 * g * reps * 4352 / SM_CLOCKS)
    assert math.isclose(t["HBM"], 1e3 * nbytes / 3.35e12)
    assert 0.124 < t["HBM"] < 0.125
    assert ms == max(t.values())


def test_sass_units():
    assert SMOKE.sass_unit("FFMA.RM") == "FP32"
    assert SMOKE.sass_unit("FMUL") == "FP32"
    assert SMOKE.sass_unit("IMAD.WIDE.U32") == "product"
    assert SMOKE.sass_unit("IMAD.HI.U32") == "product"
    assert SMOKE.sass_unit("IMAD.MOV.U32") == "integer multiply"
    assert SMOKE.sass_unit("IMAD") == "integer multiply"
    assert SMOKE.sass_unit("MUFU.EX2") == "MUFU"
    assert SMOKE.sass_unit("I2FP.F32.U32") == "I2FP"
    assert SMOKE.sass_unit("F2I.TRUNC") == "conversion"
    assert SMOKE.sass_unit("LOP3.LUT") == "ALU"
    assert SMOKE.sass_unit("FSET.BF.GE.AND") == "ALU"
    for op in ("UIADD3", "UIMAD.WIDE.U32", "BRA", "LDS", "STG.E", "BAR.SYNC"):
        assert SMOKE.sass_unit(op) is None


SASS = """
	code for sm_90a
		Function : _ZN4rls14uniform_kernelEPfii5uint2
	.headerflags	@"EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   ISETP.GE.AND P0, PT, R5, UR4, PT ;
        /*0020*/              @!P0 BRA 0x90 ;
        /*0030*/                   IMAD.WIDE.U32 R2, R4, -0x2d4e1ead, RZ ;
        /*0040*/                   LOP3.LUT R6, R3, R7, R8, 0x96, !PT ;
        /*0050*/                   I2FP.F32.U32 R9, R6 ;
        /*0060*/                   FFMA R9, R9, 1.1920928955078125e-07, R10 ;
        /*0070*/                   UIADD3 UR4, UR4, 0x2, URZ ;
        /*0080*/               @P1 BRA 0x30 ;
        /*0090*/                   IMAD.WIDE.U32 R2, R4, -0x2d4e1ead, RZ ;
        /*00a0*/                   I2FP.F32.U32 R9, R6 ;
        /*00b0*/               @P1 BRA 0x90 ;
        /*00c0*/                   EXIT ;
		Function : _ZN4rls20uniform_block_kernelEPfii5uint2
        /*0000*/                   EXIT ;
"""


def test_sass_loop_and_counts():
    """The longest loop (a backward branch to its target), and per rep
    each unit's instructions and all of them: here a loop of 6
    instructions with one I2FP, so one rep a pass."""
    ops = SMOKE.sass_loop(SASS, "14uniform_kernelE")
    assert ops == ["IMAD.WIDE.U32", "LOP3.LUT", "I2FP.F32.U32", "FFMA",
                   "UIADD3", "BRA"]
    c = SMOKE.sass_counts(ops, "I2F", 1)
    assert c == {"reps_per_loop": 1, "instructions": 6.0, "product": 1.0,
                 "ALU": 1.0, "I2FP": 1.0, "FP32": 1.0}
    assert SMOKE.sass_counts(ops * 4, "I2F", 2)["instructions"] == 12.0
    with pytest.raises(ValueError, match="whole number"):
        SMOKE.sass_counts(ops, "I2F", 4)
    with pytest.raises(ValueError, match="no loop"):
        SMOKE.sass_loop(SASS, "20uniform_block_kernelE")
    with pytest.raises(ValueError, match="no SASS function"):
        SMOKE.sass_loop(SASS, "11exp_kernelE")


@pytest.mark.parametrize("name", list(SASS_PER_REP))
def test_build_issues_at_least_the_needs(name):
    """The sm_90a build holds, per rep, at least the instructions of each
    unit that BODY_NEEDS charges (so no bound is too long); one product
    fewer than the needs is a shortfall."""
    needs, got = SMOKE.BODY_NEEDS[name], SASS_PER_REP[name]
    assert SMOKE.sass_shortfall(needs, got) == {}
    unit = "product" if "product" in needs else "FP32"
    short = dict(got, **{unit: needs[unit] - 1})
    assert SMOKE.sass_shortfall(needs, short) == {
        unit: (needs[unit] - 1, needs[unit])}


def test_place_cases_reach_the_kernels_edges():
    """``PLACE_CASES`` hold one canvas and 33, offsets 0 and 2944, a
    repeated offset, offsets one row apart and rep counts of 1, 7 and one
    that fills neither the kernel's blocks of 2048 offsets nor its reads
    of four; every offset lies in range; each case builds on the CPU."""
    cases = prim.PLACE_CASES
    last = prim.CANVAS_ROWS - prim.WIN_ROWS
    assert {n for _, n, _ in cases} == {1, 33}
    offsets = [o for _, _, offs in cases for o in offs]
    assert min(offsets) == 0 and max(offsets) == last == 2944
    reps = {len(offs) for _, _, offs in cases}
    assert {1, 7} <= reps
    assert any(r > 2048 and r % 2048 and r % 4 for r in reps)
    assert any(len(set(offs)) < len(offs) for _, _, offs in cases)
    assert any(offs == tuple(range(offs[0], offs[0] + len(offs)))
               and len(offs) > 1 for _, _, offs in cases)
    name, canvas, offs = prim.place_add_case(0)
    assert canvas.shape == (1, prim.CANVAS_ROWS, prim.COLS)
    assert offs.dtype == torch.int32 and name == cases[0][0]


def test_rep_markers_name_every_elementwise_body():
    elementwise = set(prim.NAMES) - {"place_add", "sgemm", "tf32x3"}
    assert set(SMOKE.REP_MARKERS) == set(SMOKE.BODY_NEEDS) == elementwise


@pytest.mark.parametrize("fma,blocks,unit", [
    (2.0e9, 1.0e6, "issue"),                # K3-like: taps dominate
    (1.0e8, 5.0e7, "integer multiply"),     # K4-like: draws dominate
    (0.0, 0.0, "HBM")])
def test_k3_k4_philox_terms(fma, blocks, unit):
    """K3's and K4's bounds: FMAs at the FP32 rate, each PHILOX_BLOCK's 16
    products (32 integer multiply slots) and 16 XORs, and every one of
    those instructions an issue slot, in parallel, against the bytes."""
    nbytes = 4.0 * 2 * 2048 * 2048
    work = SMOKE.fma_philox_work(fma, blocks)
    assert work == {"FP32": fma, "integer multiply": 32 * blocks,
                    "ALU": 16 * blocks, "issue": fma + 32 * blocks}
    ms, got, t = SMOKE.unit_bound(work, SMS, CLOCK, nbytes)
    want = {"FP32": 1e3 * fma / (128 * SM_CLOCKS),
            "issue": 1e3 * (fma + 32 * blocks) / (128 * SM_CLOCKS),
            "integer multiply": 1e3 * 32 * blocks / (64 * SM_CLOCKS),
            "HBM": 1e3 * nbytes / SMOKE.PEAK_BYTES}
    assert got == unit
    assert math.isclose(ms, max(want.values()))
    assert math.isclose(ms, want[unit])
    assert all(math.isclose(t.get(u, 0.0), v) for u, v in want.items())
