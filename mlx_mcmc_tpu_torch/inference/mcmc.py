"""High-level ``MCMC`` facade: the reference's class API.

Counterpart of ``mlx_mcmc_tpu/inference/mcmc.py:26-247``: the same
constructor (``MCMC(log_prob_fn)``), the same ``run(initial_params,
num_samples, num_warmup, method, proposal_scale, random_seed, verbose,
num_chains, jitter, chain_method, **kwargs)`` dispatch, the Metropolis
warmup run followed by a restart of every chain from its last warmup draw
at ``random_seed + 1``, the same ``summary`` keys
(mean/std/median/'2.5%'/'97.5%'/n_eff/r_hat), ``print_summary``,
``diagnostics()`` and ``stats``. ``**kwargs`` pass through to
:func:`~mlx_mcmc_tpu_torch.inference.api.sample` for every method,
``device`` included (the reference's Metropolis ignores them).

The reference's method 'ensemble' and ``chain_method='sharded'`` are not
ported yet: they raise ``NotImplementedError`` naming their ROADMAP item,
and nothing falls back to another method.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from mlx_mcmc_tpu_torch.inference.api import MCMCResult, sample

_METHODS = ("metropolis", "hmc", "nuts", "chees", "mala")
_NOT_PORTED = {"ensemble": "A.9"}


class MCMC:
    """High-level MCMC inference interface over a dict-of-params model.

    >>> from mlx_mcmc_tpu_torch import Normal, MCMC
    >>> def log_prob(params):
    ...     return Normal(0, 10).log_prob(params['mu'])
    >>> samples = MCMC(log_prob).run({'mu': 0.0}, num_samples=1000, device='cpu')
    """

    def __init__(self, log_prob_fn):
        self.log_prob_fn = log_prob_fn
        self.samples: Optional[Dict[str, np.ndarray]] = None
        self.acceptance_rate: Optional[float] = None
        self.result: Optional[MCMCResult] = None

    def run(
        self,
        initial_params: Any,
        num_samples: int = 1000,
        num_warmup: int = 1000,
        method: str = "metropolis",
        proposal_scale: float = 0.1,
        random_seed: int = 0,
        verbose: bool = True,
        num_chains: int = 1,
        jitter: float = 0.0,
        chain_method: str = "vmap",
        **kwargs,
    ) -> Dict[str, np.ndarray]:
        """Run MCMC sampling; returns {name: np.ndarray of draws}, each
        ``(num_chains * num_samples, *event_shape)``.

        ``method``: 'metropolis' | 'hmc' | 'nuts' | 'chees' | 'mala'. Extra
        kwargs go to ``sample()``: ``step_size``, ``num_leapfrog_steps``,
        ``adapt_step_size``, ``target_accept`` (hmc); ``step_size``,
        ``max_tree_depth``, ``adapt_step_size``, ``target_accept`` (nuts);
        ``max_leapfrog_steps`` (chees);
        and ``transforms``, ``data``, ``value_and_grad_fn``,
        ``store_dtype``, ``device`` and the rest for any method.
        Metropolis runs ``num_warmup`` draws at the fixed ``proposal_scale``
        (no adaptation), then restarts every chain from its last warmup
        draw with seed ``random_seed + 1``.
        """
        if method not in _METHODS + tuple(_NOT_PORTED):
            raise ValueError(f"Unknown sampling method: {method}")
        if chain_method not in ("vmap", "sharded"):
            raise ValueError(f"Unknown chain_method: {chain_method}")
        if method in _NOT_PORTED:
            raise NotImplementedError(
                f"method={method!r} is not ported yet (ROADMAP {_NOT_PORTED[method]})")
        if chain_method == "sharded":
            raise NotImplementedError("chain_method='sharded' is not ported yet (ROADMAP A.10)")

        if verbose:
            print("=" * 70)
            print(f"mlx-mcmc-tpu: {method.upper()} sampling "
                  f"({num_chains} chain{'s' if num_chains != 1 else ''}, "
                  f"{num_warmup} warmup + {num_samples} draws)")
            print("=" * 70)

        if method == "metropolis":
            fixed = dict(num_warmup=0, num_chains=num_chains, kernel="metropolis",
                         step_size=proposal_scale, adapt_step_size=False,
                         adapt_mass_matrix=False, **kwargs)
            start, batched_start = initial_params, False
            if num_warmup > 0:
                warm = sample(self.log_prob_fn, start, num_samples=num_warmup,
                              seed=random_seed, jitter=jitter, **fixed)
                if verbose:
                    print(f"Warmup acceptance rate: {warm.acceptance_rate:.2%}")
                # Restart every chain from its last warmup draw.
                start = {k: v[:, -1] for k, v in warm.samples.items()}
                batched_start = True
            result = sample(
                self.log_prob_fn, start, num_samples=num_samples,
                seed=random_seed + 1 if num_warmup > 0 else random_seed,
                jitter=0.0 if batched_start else jitter, batched_initial=batched_start,
                **fixed)
        else:
            result = sample(self.log_prob_fn, initial_params, num_samples=num_samples,
                            num_warmup=num_warmup, num_chains=num_chains, kernel=method,
                            seed=random_seed, jitter=jitter, **kwargs)

        self.result = result
        self.acceptance_rate = result.acceptance_rate
        self.samples = result.flat_samples()

        if verbose:
            print(f"Sampling acceptance rate: {self.acceptance_rate:.2%}")
            if result.divergences:
                print(f"Divergent transitions: {result.divergences}")
            print("Sampling complete!")

        return self.samples

    def _require_run(self) -> MCMCResult:
        if self.result is None:
            raise ValueError("Must run sampling first. Call run() method.")
        return self.result

    @property
    def stats(self):
        """Per-draw TransitionInfo with (chains, draws) tensors."""
        return self._require_run().info

    def diagnostics(self) -> Dict[str, Dict[str, float]]:
        """Split R-hat / ESS per parameter."""
        return self._require_run().diagnostics()

    def summary(self, credible_interval: float = 0.95) -> Dict[str, Dict[str, float]]:
        """Posterior summary, keyed as the reference's (``name`` or
        ``name[i]``; mean/std/median/percentile interval/n_eff/r_hat)."""
        return self._require_run().summary(credible_interval)

    def print_summary(self, credible_interval: float = 0.95) -> None:
        """Formatted posterior table: the reference's format, with n_eff and
        r_hat columns; the interval keys looked up by name."""
        summary = self.summary(credible_interval)
        ci_pct = int(credible_interval * 100)
        alpha = 1 - credible_interval
        lower_key = f"{100 * alpha / 2:.1f}%"
        upper_key = f"{100 * (1 - alpha / 2):.1f}%"
        print("\nPosterior Summary:")
        print("=" * 96)
        print(f"{'Parameter':<15} {'Mean':<10} {'Std':<10} {'Median':<10} "
              f"{f'{ci_pct}% CI':<22} {'n_eff':<8} {'r_hat':<6}")
        print("-" * 96)
        for name, stats in summary.items():
            ci_str = f"[{stats[lower_key]:.3f}, {stats[upper_key]:.3f}]"
            print(f"{name:<15} {stats['mean']:<10.3f} {stats['std']:<10.3f} "
                  f"{stats['median']:<10.3f} {ci_str:<22} "
                  f"{stats['n_eff']:<8.0f} {stats['r_hat']:<6.3f}")
        print("=" * 96)
