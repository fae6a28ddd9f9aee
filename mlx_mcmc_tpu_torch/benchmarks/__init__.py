"""The reference's kernel microbenchmarks, on the card.

``glm_kernel_variants`` and ``flagship_decomposition`` are the
counterparts of the repository's ``benchmarks/glm_kernel_variants.py`` and
``benchmarks/flagship_decomposition.py``: they time the variants of the
fused GLM kernel's body (``ops/glm_variants.py``, ``csrc/glm_variants.cu``)
beside the production kernel. Run each with ``python -m``; both need a GPU.
"""
