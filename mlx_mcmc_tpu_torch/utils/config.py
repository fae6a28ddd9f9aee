"""Typed run configurations: the port's own copy of
``mlx_mcmc_tpu/utils/config.py``.

``sample(..., config=SamplerConfig(...))`` is the same run as spelling the
fields out; ``to_kwargs()`` flattens a config into ``sample()``'s keyword
arguments, keeping only the knobs the selected kernel takes.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AdaptationConfig:
    """Warmup adaptation settings (Stan-style windowed schedule)."""

    adapt_step_size: bool = True
    adapt_mass_matrix: bool = True
    target_accept: Optional[float] = None  # the kernel's default
    init_buffer: int = 75
    term_buffer: int = 50
    base_window: int = 25


@dataclass(frozen=True)
class SamplerConfig:
    """A whole run's settings."""

    kernel: str = "nuts"
    num_samples: int = 1000
    num_warmup: int = 1000
    num_chains: int = 1
    # 'auto': the Stan-style step-size probe of the gradient kernels
    # (Metropolis takes 0.1)
    step_size: object = "auto"
    num_leapfrog_steps: int = 10  # hmc only
    max_tree_depth: int = 10  # nuts only
    max_leapfrog_steps: int = 1000  # chees only: the trajectory's cap
    seed: int = 0
    jitter: float = 0.0
    thin: int = 1
    # The draw store: store_dtype='bfloat16' halves it; draw_chunk=k fetches
    # every k draws to the host (bit-identical draws either way).
    store_dtype: Optional[str] = None
    draw_chunk: Optional[int] = None
    adaptation: AdaptationConfig = field(default_factory=AdaptationConfig)

    def to_kwargs(self) -> dict:
        kw = asdict(self)
        ad = kw.pop("adaptation")
        if kw.get("store_dtype") is None:
            kw.pop("store_dtype")
        if kw.get("draw_chunk") is None:
            kw.pop("draw_chunk")
        if kw.get("thin") == 1:
            kw.pop("thin")
        kw.update(
            adapt_step_size=ad["adapt_step_size"],
            adapt_mass_matrix=ad["adapt_mass_matrix"],
            target_accept=ad["target_accept"],
        )
        # Only the knobs the kernel takes (step_size and the adaptation
        # flags pass through for every kernel).
        if self.kernel != "hmc":
            kw.pop("num_leapfrog_steps")
        if self.kernel != "nuts":
            kw.pop("max_tree_depth")
        if self.kernel != "chees":
            kw.pop("max_leapfrog_steps")
        return kw


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for sharded sampling."""

    chains: Optional[int] = None  # mesh axis size; None = all devices
    data: int = 1
    axis_names: Tuple[str, str] = ("chains", "data")

    def build(self):
        """The mesh: :func:`chain_mesh` of ``chains`` ranks when ``data`` is
        1, else :func:`data_chain_mesh` (every rank of the world, as
        ``parallel/mesh.py`` lays them out)."""
        from mlx_mcmc_tpu_torch.parallel.mesh import chain_mesh, data_chain_mesh

        if self.data == 1:
            return chain_mesh(num_devices=self.chains)
        return data_chain_mesh(self.chains, self.data)
