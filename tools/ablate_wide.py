"""Where the time of the GLM kernels goes, by ablation, on the card.

    PYTHONPATH=. python3 tools/ablate_wide.py [wide] [onepass] [k3] [int8] [f32]   # from the repository's root

Builds variants of ``mlx_mcmc_tpu_torch/csrc/glm_fused.cu`` that each change
one part of a kernel's work, and times K1 with each, in turns, by CUDA
events and by torch.profiler's device time per kernel.

``wide`` (the default): K1's wide bf16 path at glm1000_fused's shape
(C = 256, N = 100K, D = 1000, bf16 X):

- ``full``: the source as it is;
- ``no_epilogue_math``: the value kernel's likelihood epilogue (tanhf, logf)
  replaced by one addition per element (the residual stores and the ll sums
  stay);
- ``no_reloads``: the producers load each ring stage once and then only
  signal it, so the MMAs run on stale tiles without waiting for memory;
- ``neither``: both.

``k3``: the Poisson kernel (``csrc/poisson_fused.cu``) at poisson1000_cov's
shape (C = 512, G = 1000, n = 100, K = 4):

- ``full``: the source as it is (the accurate ``expf``);
- ``fast_exp``: ``ex2.approx`` of s log2(e), with no range reduction;
- ``no_exp``: the exp replaced by one addition;
- ``full_splits_per_sm_2``, ``_4``: the source as it is with the slab sized
  for 2 or 4 group splits per SM instead of 1.

``onepass``: the one-pass bf16 kernel at glm100_fused's shape (C = 4096,
N = 10K, D = 100), K1 and K2 (no transcendentals):

- ``full``: the source as it is (the MUFU form of the epilogue);
- ``accurate``: the accurate tanhf/logf epilogue instead;
- ``no_epilogue_math``: the epilogue replaced by one addition per element
  (the residual's conversion to A fragments and the ll sums stay);
- ``no_s_product``, ``no_g_product``: the wgmma of S^T = Zb X^T, or of
  G^T += R^T X, left out (the loads, barriers and the rest stay).

``int8``: K1 on int8 X (the reference's quantized storage, the scales
folded into Z) through the widening stage, in the one-pass kernel at
glm100_fused's shape and in the wide pair at glm1000_fused's:

- ``full``: the source as it is;
- ``no_convert``: the widening loads and stores each stage but replaces the
  int8-to-bf16 conversion by one XOR per pair;
- ``no_widen``: the widening warps only fence and arrive, so the stage's
  bf16 boxes are never written (the MMAs read stale tiles).

``f32``: K1 on f32 X (the reference's X in float32) through the 3xTF32
pair, at glm100_fused's shape (C = 4096, N = 10K, D = 100) and at
glm1000_fused's (C = 256, N = 100K, D = 1000, unit-scale positions):

- ``full``: the source as it is (the MUFU epilogue);
- ``no_split``: the split warps only fence and arrive, so the B_hi and
  B_lo boxes are never written from the raw ones (the MMAs read stale
  tiles);
- ``accurate``: the value kernel's accurate tanhf/logf epilogue (right
  values);
- ``hi_hi_only``: one TF32 product per slice (A_hi B_hi) instead of three;
- ``no_mma``: no wgmma at all (loads, splits, flushes and epilogues stay);
- ``no_epilogue_math``: the value kernel's epilogue replaced by one
  addition per element (the residual stores and the ll sums stay);
- ``no_reloads``: the loaders load their first ring's worth of stages
  only, then signal each stage without loading (stale tiles);
- ``no_store``: the value kernel's R^T stores left out;
- ``no_split_no_mma``: neither the split nor any wgmma.

The variants that change the math compute wrong values by construction;
only their times mean anything. The variants are cut from the source's
text, so an edit to the lines named below makes this script stop with an
error, not measure something else. Prints one JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from mlx_mcmc_tpu_torch import _build
from mlx_mcmc_tpu_torch.bench import device_ms, kernels_ms
from mlx_mcmc_tpu_torch.models import make_logistic_regression, make_poisson_event_rates
from mlx_mcmc_tpu_torch.ops import glm, poisson

_EPILOGUE = ("              Epilogue::apply(ya, sa, ta, ra);\n"
             "              Epilogue::apply(yb, sb, tb, rb);\n")
_EPILOGUE_OFF = ("              ta = ra = sa + ya;\n"
                 "              tb = rb = sb + yb;\n")


def _reloads_off(src: str) -> str:
    """Each producer issues the loads of its first ring's worth of stages
    only; later stages are signalled without loading."""
    for producer, first in (
        ("          mbar_expect_tx(&full[stage], kInt8 ? 2 * kHalfBoxBytes : kVStageBytes);\n",
         "(t - tile_begin) * nk + kc < kVStages"),
        ("        mbar_expect_tx(&full[stage], kInt8 ? kRBytes : kStageBytes);\n",
         "ch - chunk_begin < kStages")):
        head, sep, tail = src.partition(producer)
        if not sep:
            raise ValueError("the producer's loads were not found in the source")
        body_end = tail.index("if (++stage ==")
        indent = producer[: len(producer) - len(producer.lstrip())]
        src = (head + f"{indent}if ({first}) {{\n" + producer + tail[:body_end]
               + f"}} else {{\n{indent}  mbar_arrive(&full[stage]);\n{indent}}}\n{indent}"
               + tail[body_end:])
    return src


_ONEPASS_EPILOGUE = ("          Epilogue::apply(yv[j][0], s[4 * j + 2 * h], ta, ra);\n"
                     "          Epilogue::apply(yv[j][1], s[4 * j + 2 * h + 1], tb, rb);\n")
_ONEPASS_EPILOGUE_OFF = ("          ta = ra = s[4 * j + 2 * h] + yv[j][0];\n"
                         "          tb = rb = s[4 * j + 2 * h + 1] + yv[j][1];\n")
_ONEPASS_MUFU = "constexpr bool kOnePassAccurate = false;"


def _cut(src: str, old: str, new: str, what: str, times: int = 1) -> str:
    if src.count(old) != times:
        raise ValueError(f"{what} was not found {times} times in the source")
    return src.replace(old, new)


_K3_EXP = "    const float lam = expf(s);\n"
_K3_FAST_EXP = ("    float lam;\n"
                "    asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(lam) : \"f\"(1.44269504f * s));\n")
_K3_NO_EXP = "    const float lam = s + 1.f;\n"


_WIDEN_CONVERT = ('  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(x), '
                  '"r"(0x3F803F80u), "r"(neg));\n')
_WIDEN_LOOP = "  for (int p = wt; p < kLines * kSteps; p += 32 * kWidenWarps) {\n"


_ONEPASS_S = ("        wgmma_m64n64k16(s, sw128_desc(zs + b * kOZBox, 16) + 2 * kk,\n"
              "                        sw128_desc(st + b * kOXBox, 16) + 2 * kk);\n")
_ONEPASS_G = "          wgmma_m64n128k16_rs(g, a[kk], sw128_desc(st, kOXBox) + 128 * kk);\n"


_TF32_SMALL = (
    "  for (int k = 0; k < kTK / 8; ++k) wgmma_m64n128k8_tf32(acc, ah[k], bl + 2 * k, k > 0);\n"
    "#pragma unroll\n"
    "  for (int k = 0; k < kTK / 8; ++k) wgmma_m64n128k8_tf32(acc, al[k], bh + 2 * k, 1);\n"
    "#pragma unroll\n")
_TF32_BIG = "  for (int k = 0; k < kTK / 8; ++k) wgmma_m64n128k8_tf32(acc, ah[k], bh + 2 * k, 1);\n"
_TF32_SPLIT_LOOP = "  for (int p = wt; p < (int)(kTBox / 16); p += 32 * kSplitWarps) {\n"
_TF32_LOADER = "    const bool loader = threadIdx.x == 2 * 128, splitter = threadIdx.x >= 2 * 128 + 32;\n"
_TF32_EXPECT = "            mbar_expect_tx(&rawf[stage], 2 * kTBox);\n"
_TF32_STORE = ("            tma_store_2d(&rt_map, stg, r0, c0);\n"
               "            tma_store_2d(&rt_map, stg + kTStgBytes, r0 + 32, c0);\n")


def _tf32_reloads_off(src: str) -> str:
    """Each f32 kernel's loader issues the loads of its first ring's worth
    of stages only; later stages are signalled without loading."""
    src = _cut(src, _TF32_LOADER, _TF32_LOADER + "    int loads = 0;\n", "the f32 loaders", 2)
    src = _cut(src, "mbar_expect_tx(&rawf[stage], 2 * kTBox);",
               "if (++loads > kTStages) mbar_arrive(&rawf[stage]);\n"
               "          else mbar_expect_tx(&rawf[stage], 2 * kTBox);", "the f32 loaders' expects", 2)
    for load in ("tma_load_2d(st, &z_map", "tma_load_2d(st + kTBox, &x_map", "tma_load_2d(st, &rt_map",
                 "tma_load_2d(st + kTBox / 2, &rt_map", "tma_load_2d(st + kTBox, &xt_map"):
        src = _cut(src, load, "if (loads <= kTStages) " + load, "an f32 load")
    return src


_TF32_ACCURATE = "constexpr bool kTF32Accurate = false;"
_TF32_EPILOGUE = ("              Epilogue::apply(ya, tot[4 * j + 2 * h], ta, ra);\n"
                  "              Epilogue::apply(yb, tot[4 * j + 2 * h + 1], tb, rb);\n")
_TF32_EPILOGUE_OFF = ("              ta = ra = tot[4 * j + 2 * h] + ya;\n"
                      "              tb = rb = tot[4 * j + 2 * h + 1] + yb;\n")


def variants(target: str) -> dict:
    if target == "k3":
        src = (_build.CSRC_DIR / "poisson_fused.cu").read_text()
        return {"full": src, "fast_exp": _cut(src, _K3_EXP, _K3_FAST_EXP, "K3's exp"),
                "no_exp": _cut(src, _K3_EXP, _K3_NO_EXP, "K3's exp")}
    src = (_build.CSRC_DIR / "glm_fused.cu").read_text()
    if target == "int8":
        return {"full": src,
                "no_convert": _cut(src, _WIDEN_CONVERT, "  r = x ^ neg;\n", "the int8 conversion"),
                "no_widen": _cut(src, _WIDEN_LOOP, _WIDEN_LOOP.replace("kLines * kSteps", "0"),
                                 "the widening loop")}
    if target == "f32":
        return {"full": src,
                "no_split": _cut(src, _TF32_SPLIT_LOOP, _TF32_SPLIT_LOOP.replace(
                    "(int)(kTBox / 16)", "0"), "the split loop"),
                "accurate": _cut(src, _TF32_ACCURATE, _TF32_ACCURATE.replace("false", "true"),
                                 "the f32 epilogue switch"),
                "hi_hi_only": _cut(_cut(src, _TF32_SMALL, "", "the small products"), _TF32_BIG,
                                   _TF32_BIG.replace("k, 1);", "k, k > 0);"), "the large product"),
                "no_mma": _cut(_cut(src, _TF32_SMALL, "", "the small products"), _TF32_BIG, "",
                               "the large product"),
                "no_epilogue_math": _cut(src, _TF32_EPILOGUE, _TF32_EPILOGUE_OFF,
                                         "the f32 value kernel's epilogue"),
                "no_reloads": _tf32_reloads_off(src),
                "no_store": _cut(src, _TF32_STORE, "", "the R^T stores"),
                "no_split_no_mma": _cut(_cut(_cut(src, _TF32_SMALL, "", "the small products"),
                                             _TF32_BIG, "", "the large product"),
                                        _TF32_SPLIT_LOOP, _TF32_SPLIT_LOOP.replace(
                                            "(int)(kTBox / 16)", "0"), "the split loop")}
    if target == "onepass":
        return {"full": src,
                "accurate": _cut(src, _ONEPASS_MUFU, _ONEPASS_MUFU.replace("false", "true"),
                                 "the one-pass epilogue switch"),
                "no_epilogue_math": _cut(src, _ONEPASS_EPILOGUE, _ONEPASS_EPILOGUE_OFF,
                                         "the one-pass kernel's epilogue"),
                "no_s_product": _cut(src, _ONEPASS_S, "", "the one-pass S^T product"),
                "no_g_product": _cut(src, _ONEPASS_G, "", "the one-pass G^T product")}
    no_math = _cut(src, _EPILOGUE, _EPILOGUE_OFF, "the value kernel's epilogue")
    return {"full": src, "no_epilogue_math": no_math, "no_reloads": _reloads_off(src),
            "neither": _reloads_off(no_math)}


def build_all(sources: dict, target: str) -> dict:
    """One nvcc per variant, all started together; {name: library path}."""
    out_dir = _build.BUILD_DIR.parent / f"ablate_{target}"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [f"{'poisson' if target == 'k3' else 'glm'}_{name}" for name in sources]
    for name, text in zip(names, sources.values()):
        (out_dir / f"{name}.cu").write_text(text)
    _build.build(names, src_dir=out_dir, out_dir=out_dir)
    return {name: _build.library_path(lib, out_dir) for name, lib in zip(sources, names)}


def ablate_k3() -> dict:
    libs = build_all(variants("k3"), "k3")
    spec = make_poisson_event_rates(num_groups=1000, obs_per_group=100, covariate_dim=4, seed=0)
    data = poisson.prepare_fused_poisson_data(spec.y, spec.X)
    gen = torch.Generator(device="cuda").manual_seed(1)
    theta = 1.0 + 0.5 * torch.randn(512, 1000, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(512, 4, generator=gen, device="cuda")
    args = (data["X"], data["y"], data["shat"], data["lamhat"], theta, beta)
    # The source as it is, also with the slab sized for 2 and 4 splits per SM
    # (the wrapper's plan; 1 as shipped).
    runs = [(name, lib, poisson._SPLITS_PER_SM) for name, lib in libs.items()]
    runs += [(f"full_splits_per_sm_{k}", libs["full"], k) for k in (2, 4)]
    rows = {name: {"K3": {"ms": [], "kernels_ms": None}} for name, _, _ in runs}
    shipped = poisson._SPLITS_PER_SM
    try:
        for _ in range(2):
            for name, lib, per_sm in runs:
                poisson.use_kernel_library(lib)
                poisson._SPLITS_PER_SM = per_sm
                call = lambda: poisson.fused_poisson_vag_cuda(*args)  # noqa: E731
                rows[name]["K3"]["ms"].append(device_ms(call))
                rows[name]["K3"]["kernels_ms"] = kernels_ms(call)
    finally:
        poisson._SPLITS_PER_SM = shipped
    return rows


def _int8_call(d: int, n: int, c: int, scale: float):
    """K1 on the GLM dataset of width d and n rows stored as int8, at c
    chain positions of the given scale (the column scales folded in)."""
    spec = make_logistic_regression(num_features=d, num_obs=n, seed=0, data_dtype=torch.bfloat16)
    data = glm.prepare_fused_logistic_data(spec.X, spec.y, quantize="int8")
    gen = torch.Generator(device="cuda").manual_seed(1)
    Z = scale * torch.randn(c, d, generator=gen, device="cuda") * data["col_scale"]
    return lambda: glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z)


def _f32_call(d: int, n: int, c: int):
    """K1 on the GLM dataset of width d and n rows with X in float32, at c
    unit-scale chain positions."""
    spec = make_logistic_regression(num_features=d, num_obs=n, seed=0, data_dtype=torch.float32)
    data = glm.prepare_fused_logistic_data(spec.X, spec.y)
    Z = torch.randn(c, d, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    return lambda: glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z, data["XpT"])


def ablate(target: str) -> dict:
    if target == "k3":
        return ablate_k3()
    libs = build_all(variants(target), target)
    if target == "int8":
        calls = {"K1_int8": _int8_call(100, 10_000, 4096, 1.0),
                 "K1_int8_wide": _int8_call(1000, 100_000, 256, 0.05)}
    elif target == "f32":
        calls = {"K1_f32": _f32_call(100, 10_000, 4096), "K1_f32_glm1000": _f32_call(1000, 100_000, 256)}
    else:
        wide = target == "wide"
        d, n, c = (1000, 100_000, 256) if wide else (100, 10_000, 4096)
        spec = make_logistic_regression(num_features=d, num_obs=n, seed=0, data_dtype=torch.bfloat16)
        data = glm.prepare_fused_logistic_data(spec.X, spec.y)
        gen = torch.Generator(device="cuda").manual_seed(1)
        Z = (0.05 if wide else 1.0) * torch.randn(c, d, generator=gen, device="cuda")
        calls = {"K1": lambda: glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z)}
        if not wide:
            y_lin = data["Xp"][:, :d].float() @ torch.randn(d, generator=gen, device="cuda")
            calls["K2"] = lambda: glm.fused_linear_vag_cuda(data["Xp"], y_lin, Z)
    rows = {name: {key: {"ms": [], "kernels_ms": None} for key in calls} for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            glm.use_kernel_library(lib)
            for key, call in calls.items():
                rows[name][key]["ms"].append(device_ms(call))
                rows[name][key]["kernels_ms"] = kernels_ms(call)
    return rows


def main() -> None:
    targets = [a for a in sys.argv[1:] if a in ("wide", "onepass", "k3", "int8", "f32")] or ["wide"]
    out = {target: ablate(target) for target in targets}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "variants": out}))


if __name__ == "__main__":
    main()
