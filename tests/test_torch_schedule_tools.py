"""The CPU side of ``tools/onepass_schedule.py``: its builds of
``csrc/glm_variants.cu`` are cut from the sources' text, and its SASS
reading gives ``chip_smoke.EPILOGUE_ISSUE``, the accurate epilogues' part of
the variants' bound."""

import sys
from pathlib import Path

import numpy as np
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


_OV_SASS = """
\t\tFunction : _ZN1a18glm_overlap_kernelINS_5FloorEEEvi
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4].tnspB, R24 ;
        /*0020*/               @P0 BRA 0x0 ;
\t\tFunction : _ZN1a18glm_overlap_kernelINS_10ExpHoistedEEEvi
        /*0000*/                   MUFU.EX2 R3, R3 ;
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4].tnspB, R24 ;
        /*0020*/               @P0 BRA 0x0 ;
"""


def test_sass_rows_count_overlap_instances_over_the_overlap_floor():
    rows = onepass_schedule.sass_rows(_OV_SASS)
    exp = next(v for k, v in rows.items() if "ExpHoisted" in k)
    assert exp["per_element_over_floor"] == {"always": 0.0, "fp32_always": 0.0, "mufu_always": 1 / 32}
    # The same from another text's Floor (the overlap_floor part's build).
    floor_only = onepass_schedule.sass_rows(_OV_SASS.split("\t\tFunction : _ZN1a18glm_overlap_kernelINS_10")[0])
    exp_only = "\t\tFunction : _ZN1a18glm_overlap_kernelINS_10" + _OV_SASS.split(
        "\t\tFunction : _ZN1a18glm_overlap_kernelINS_10")[1]
    (row,) = onepass_schedule.sass_rows(exp_only, floor_only).values()
    assert row["per_element_over_floor"]["mufu_always"] == 1 / 32


@pytest.mark.parametrize("part", ["onepass", "onepass_no_g_product", "onepass_no_epilogue_math",
                                  "onepass_alternate", "onepass_stamps", "overlap_stamps",
                                  "overlap_epilogue_200", "overlap_no_epilogue_math", "overlap_floor",
                                  "exp_libm", "exp_mufu", "exp_only_expf", "exp_only_log1pf",
                                  "exp_only_division", "exp_overlap_libm", "exp_overlap_flat",
                                  "exp_overlap_mufu", "exp_counts", "mm1_pair_stamps",
                                  "mm1_pair_no_reloads", "mm1_pair_no_remote", "mm1_pair_two_accumulators"])
def test_split_parts_are_cut_from_the_sources(part):
    # Every cut is found once in the sources (else split_sources raises),
    # and each part differs from the shipped pair.
    sources = onepass_schedule.split_sources()
    assert sources[part] != sources["overlap"]


def test_the_shipped_exp_form_is_the_flat_part():
    sources = onepass_schedule.split_sources()
    assert sources["exp_flat"] == sources["overlap"]


@pytest.mark.parametrize("form,kept", [("libm", ("expf(", "1.f / (1.f + t)", "log1pf(")),
                                       ("mufu", ()), ("only_expf", ("expf(",)),
                                       ("only_division", ("1.f / (1.f + t)",)),
                                       ("only_log1pf", ("log1pf(",))])
def test_exp_forms_keep_their_libm_parts(form, kept):
    # Each ablation keeps its part of libm and takes the MUFU form of the rest.
    body = onepass_schedule.exp_body(form)
    for part, mufu in (("expf(", "ex2_approx("), ("1.f / (1.f + t)", "rcp_approx("), ("log1pf(", "lg2_approx(")):
        assert (part in body) == (part in kept)
        assert (mufu in body) == (part not in kept)
    src = onepass_schedule.with_exp_form(onepass_schedule.split_sources()["overlap"][1], form)
    assert body in src


def test_flat_form_has_no_libm_slow_paths():
    body = onepass_schedule.exp_body("flat")
    assert "log1pf" not in body and "/" not in body and "rcp_rn_unit(u)" in body


def test_counting_build_ballots_each_libm_part():
    src = onepass_schedule.split_sources()["exp_counts"][1]
    for i, (part, pred) in enumerate(onepass_schedule.LIBM_OTHER_PATHS.items()):
        assert f"exp_count({i}, {pred});" in src, part
    assert "exp_accuracy" in src and "rcp_check_kernel" in src


def test_pair_stamp_summary_reads_rounds_and_exchanges():
    c, r = onepass_schedule.PAIR_STAMP_CLUSTERS, onepass_schedule.PAIR_STAMP_ROUNDS
    raw = np.zeros((c, 8, r, 4), dtype=np.int64)
    base = np.arange(r)[None, None, :] * 1000
    raw[..., 0] = base
    raw[..., 1] = base + 400
    raw[..., 2] = base + 700
    raw[..., 3] = base + 750
    raw[:, 1, :, 1] += 20  # rank 1 publishes 20 cycles later
    out = onepass_schedule.pair_stamp_summary(raw.ravel(), k=4, rounds=20)
    cyc = out["cycles_a_round"]
    assert cyc["exchange_reads"] == 50.0 and cyc["to_next_round"] == 250.0
    assert out["publish_spread_cycles"] == 20.0
    assert out["cluster_cycles"] == 19 * 1000 + 750
