"""Where the time of K1's wide bf16 path goes, by ablation, on the card.

    PYTHONPATH=. python3 tools/ablate_wide.py     # from the repository's root

Builds variants of ``mlx_mcmc_tpu_torch/csrc/glm_fused.cu`` that each remove
one part of the value kernel's work, and times K1 at glm1000_fused's shape
(C = 256, N = 100K, D = 1000, bf16 X) with each, in turns, by CUDA events
and by torch.profiler's device time per kernel:

- ``full``: the source as it is;
- ``no_epilogue_math``: the likelihood epilogue (tanhf, logf) replaced by
  one addition per element (the residual stores and the ll sums stay);
- ``no_reloads``: the producers load each ring stage once and then only
  signal it, so the MMAs run on stale tiles without waiting for memory;
- ``neither``: both.

The variants compute wrong values by construction; only their times mean
anything. The variants are cut from the source's text, so an edit to the
lines named below makes this script stop with an error, not measure
something else. Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

from mlx_mcmc_tpu_torch import _build
from mlx_mcmc_tpu_torch.bench import device_ms, kernels_ms
from mlx_mcmc_tpu_torch.models import make_logistic_regression
from mlx_mcmc_tpu_torch.ops import glm

_EPILOGUE = ("              Epilogue::apply(ya, sa, ta, ra);\n"
             "              Epilogue::apply(yb, sb, tb, rb);\n")
_EPILOGUE_OFF = ("              ta = ra = sa + ya;\n"
                 "              tb = rb = sb + yb;\n")


def _reloads_off(src: str) -> str:
    """Each producer issues the loads of its first ring's worth of stages
    only; later stages are signalled without loading."""
    for producer, first in (("          mbar_expect_tx(&full[stage], kVStageBytes);\n",
                             "(t - tile_begin) * nk + kc < kVStages"),
                            ("        mbar_expect_tx(&full[stage], kGStageBytes);\n",
                             "ch - chunk_begin < kGStages")):
        head, sep, tail = src.partition(producer)
        if not sep:
            raise ValueError("the producer's loads were not found in the source")
        body_end = tail.index("if (++stage ==")
        indent = producer[: len(producer) - len(producer.lstrip())]
        src = (head + f"{indent}if ({first}) {{\n" + producer + tail[:body_end]
               + f"}} else {{\n{indent}  mbar_arrive(&full[stage]);\n{indent}}}\n{indent}"
               + tail[body_end:])
    return src


def variants() -> dict:
    src = (_build.CSRC_DIR / "glm_fused.cu").read_text()
    if src.count(_EPILOGUE) != 1:
        raise ValueError("the value kernel's epilogue was not found in the source")
    no_math = src.replace(_EPILOGUE, _EPILOGUE_OFF)
    return {"full": src, "no_epilogue_math": no_math, "no_reloads": _reloads_off(src),
            "neither": _reloads_off(no_math)}


def build_all(sources: dict) -> dict:
    """One nvcc per variant, all started together; {name: library path}."""
    out_dir = _build.BUILD_DIR.parent / "ablate_wide"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [f"glm_{name}" for name in sources]
    for name, text in zip(names, sources.values()):
        (out_dir / f"{name}.cu").write_text(text)
    _build.build(names, src_dir=out_dir, out_dir=out_dir)
    return {name: _build.library_path(lib, out_dir) for name, lib in zip(sources, names)}


def main() -> None:
    libs = build_all(variants())
    spec = make_logistic_regression(num_features=1000, num_obs=100_000, seed=0,
                                    data_dtype=torch.bfloat16)
    data = glm.prepare_fused_logistic_data(spec.X, spec.y)
    Z = 0.05 * torch.randn(256, 1000, generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")

    def call():
        return glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z)

    rows = {name: {"ms": [], "kernels_ms": None} for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            glm.use_kernel_library(lib)
            rows[name]["ms"].append(device_ms(call))
            rows[name]["kernels_ms"] = kernels_ms(call)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "variants": rows}))


if __name__ == "__main__":
    main()
