"""The CPU side of ``tools/onepass_schedule.py``: its builds of
``csrc/glm_variants.cu`` are cut from the sources' text, and its SASS
reading gives ``chip_smoke.EPILOGUE_ISSUE``, the accurate epilogues' part of
the variants' bound."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import onepass_schedule  # noqa: E402

# Two one-pass instances as cuobjdump prints them: Floor's stage loop
# (0x10-0x30) and one whose loop (0x10-0x70) holds a branch over two
# instructions (0x30, 0x40), which not every pass issues.
_SASS = """
\t\tFunction : _ZN1a18glm_onepass_kernelINS_5FloorELb0ELb1ELb1EEEvi
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   FADD R1, R1, R2 ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4].tnspB, R24 ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   EXIT ;
\t\tFunction : _ZN1a18glm_onepass_kernelINS_8LogisticELb0ELb1ELb1EEEvi
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   FADD R1, R1, R2 ;
        /*0020*/               @P1 BRA 0x50 ;
        /*0030*/                   MUFU.EX2 R3, R3 ;
        /*0040*/                   FFMA R3, R3, R3, R3 ;
        /*0050*/                   FMUL R4, R4, R4 ;
        /*0060*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4].tnspB, R24 ;
        /*0070*/               @P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""


def test_sass_rows_count_what_every_pass_of_the_stage_loop_issues():
    rows = onepass_schedule.sass_rows(_SASS)
    floor, logistic = rows.values()
    assert floor == {"instructions": 3, "branches": 1, "always": 3, "fp32_always": 1, "mufu_always": 0,
                     "per_element_over_floor": {"always": 0.0, "fp32_always": 0.0, "mufu_always": 0.0}}
    assert (logistic["instructions"], logistic["branches"], logistic["always"]) == (7, 2, 5)
    assert (logistic["fp32_always"], logistic["mufu_always"]) == (2, 0)
    assert logistic["per_element_over_floor"] == {"always": 2 / 32, "fp32_always": 1 / 32, "mufu_always": 0.0}


@pytest.mark.parametrize("part", ["onepass", "onepass_no_g_product", "onepass_no_epilogue_math",
                                  "onepass_alternate", "onepass_stamps", "overlap_stamps",
                                  "overlap_epilogue_200", "overlap_no_epilogue_math"])
def test_split_parts_are_cut_from_the_sources(part):
    # Every cut is found once in the sources (else split_sources raises),
    # and each part differs from the shipped pair.
    sources = onepass_schedule.split_sources()
    assert sources[part] != sources["overlap"]
