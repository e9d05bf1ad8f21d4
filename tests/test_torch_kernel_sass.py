"""scripts/kernel_sass.py: the SASS instruction-mix counter, on text in the
form ``cuobjdump -sass`` prints (the tool itself runs only where the CUDA
toolkit is installed)."""

import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "kernel_sass.py"
_SPEC = importlib.util.spec_from_file_location("kernel_sass", _PATH)
kernel_sass = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(kernel_sass)

SASS = """
\tcode for sm_90a
\t\tFunction : _Z8kernel_av
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 MUFU.EX2 R4, R5 ;                      /* 0x0000000500047308 */
        /*0020*/                   MUFU.RCP R6, R7 ;                      /* 0x0000000700067308 */
        /*0030*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;  /* 0x000000100c08723c */
        /*0040*/               @P1 BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000001b1d */
        /*0050*/                   LDSM.16.MT88.2 R2, [R3] ;              /* 0x000000000302783b */
        /*0060*/                   LDS.U.128 R20, [R3+0x10] ;             /* 0x0000100003147984 */
        /*0070*/                   FFMA R2, R3, R4, R2 ;                  /* 0x0000000403027223 */
        /*0080*/                   EXIT ;                                 /* 0x000000000000794d */
\t\t..........

\t\tFunction : _Z8kernel_bv
        /*0000*/             @!UP0 SYNCS.ARRIVE.TRANS64 RZ, [UR4], RZ ;   /* 0x000000ffff0079a7 */
        /*0010*/                   UTMALDG.4D [UR8], [UR4] ;              /* 0x00000008040075b4 */
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ; /* 0x */
        /*0030*/                   MUFU.EX2 R4, R5 ;                      /* 0x0000000500047308 */
        /*0040*/                   MUFU.EX2 R6, R7 ;                      /* 0x0000000700067308 */
        /*0050*/                   FMNMX R2, R3, R4, !PT ;                /* 0x0000000403027209 */
"""


def test_instruction_mix_counts_each_class_per_function():
    mix = kernel_sass.instruction_mix(SASS)
    assert set(mix) == {"_Z8kernel_av", "_Z8kernel_bv"}
    a, b = mix["_Z8kernel_av"], mix["_Z8kernel_bv"]
    # MUFU.RCP is not an exponential; predicated instructions count.
    assert (a["MUFU.EX2"], a["HMMA"], a["BAR"], a["LDSM"], a["LDS"], a["FFMA"]) == (
        1, 1, 1, 1, 1, 1
    )
    assert a["total"] == 9 and a["HGMMA"] == 0
    assert (b["SYNCS"], b["UTMALDG"], b["HGMMA"], b["MUFU.EX2"], b["FMNMX"]) == (
        1, 1, 1, 2, 1
    )
    assert b["total"] == 6


@pytest.mark.parametrize(
    "opcode,cls",
    [
        ("MUFU.EX2", "MUFU.EX2"),
        ("MUFU.RSQ", None),
        ("LDS.U.128", "LDS"),
        ("LDSM.16.MT88.4", "LDSM"),
        ("LDG.E.128.CONSTANT", "LDG"),
        ("HGMMA.64x64x16.F32.BF16", "HGMMA"),
        ("IMAD.WIDE", None),
    ],
)
def test_classify_by_opcode_before_the_first_dot(opcode, cls):
    assert kernel_sass.classify(opcode) == cls


def test_per_exponential_ratios_and_no_exponentials():
    mix = kernel_sass.instruction_mix(SASS)
    ratios = kernel_sass.per_exponential(mix["_Z8kernel_bv"])
    assert ratios["f32_per_ex2"] == 0.5  # one FMNMX over two MUFU.EX2
    assert ratios["mma_per_ex2"] == 0.5
    assert ratios["instructions_per_ex2"] == 3.0
    no_exp = dict(mix["_Z8kernel_av"], **{"MUFU.EX2": 0})
    assert kernel_sass.per_exponential(no_exp) is None
