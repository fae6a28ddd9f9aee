"""Adversarial NUTS validation of the port: the counterpart of
``tests/test_nuts_exactness.py``, against the port's ``sample(device="cpu")``.

Moment-recovery tests cannot catch a subtly wrong multinomial weighting that
happens to preserve a Gaussian's first two moments. These can:

1. Distribution-level KS exactness against analytic CDFs at large draw
   counts, on a skewed target (Gumbel) as well as a Gaussian, with the
   reference's bound ``D * sqrt(n_eff) < 2.5``. The reference's own runs
   (8 chains x 30,000 draws after 500 warmup) take ~3 minutes each through
   the port's eager CPU loop and are marked ``slow``; the tier-1 cases keep
   the same bound and more draws in all (256 chains x 1,000 draws after 500
   warmup: 256,000), so the bound sees at least the reference's ``n``.
2. A cross-check against an independently written recursive multinomial
   NUTS (Betancourt's textbook formulation, in plain numpy with its own RNG)
   on an ill-conditioned correlated Gaussian at the reference's fixed
   tunables (step size 0.22, no adaptation): both samplers must agree with
   the analytic quantiles and with each other, within the reference's
   bounds. The reference's kernel run (4 chains x 5,000 draws after 200
   warmup) takes ~2 minutes here and is marked ``slow``; the tier-1 case
   draws as many (64 chains x 313 draws: 20,032) in ~16 s.
"""

import math

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.diagnostics.stats import effective_sample_size


def _ks_distance(draws: np.ndarray, cdf) -> float:
    x = np.sort(draws.ravel())
    n = x.size
    f = cdf(x)
    grid = np.arange(1, n + 1) / n
    return float(np.max(np.maximum(np.abs(grid - f), np.abs(f - (grid - 1 / n)))))


def _effective_n(draws: np.ndarray) -> float:
    ess = effective_sample_size(draws[..., None])
    # Antithetic NUTS can report ESS > n; the KS bound needs n_eff <= n.
    return float(min(np.min(ess), draws.size))


# (chains, draws) of the reference's runs and of the tier-1 cases; 500
# warmup steps in both.
REFERENCE_SHAPE = (8, 30_000)
TIER1_SHAPE = (256, 1_000)
SHAPES = [
    pytest.param(TIER1_SHAPE, id="256x1000"),
    pytest.param(REFERENCE_SHAPE, id="8x30000", marks=pytest.mark.slow),
]


def _draws(log_prob, x0, shape, seed):
    chains, draws = shape
    res = sample(log_prob, {"x": x0}, num_samples=draws, num_warmup=500,
                 num_chains=chains, kernel="nuts", seed=seed, device="cpu")
    return res.samples["x"].numpy().astype(np.float64)


class TestKSExactness:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_standard_normal_quantile_exactness(self, shape):
        from scipy.stats import norm

        draws = _draws(lambda p: -0.5 * p["x"] ** 2, 0.0, shape, seed=0)
        assert draws.size >= REFERENCE_SHAPE[0] * REFERENCE_SHAPE[1]
        d = _ks_distance(draws, norm.cdf)
        n_eff = _effective_n(draws)
        # sqrt(n) * D ~ Kolmogorov; 1.95 is the alpha=0.001 critical value,
        # 2.5 adds slack for the ESS plug-in. A weighting bug shows up orders
        # of magnitude above this (e.g. D ~ 0.01 at n_eff ~ 1e5 -> stat > 3).
        assert d * math.sqrt(n_eff) < 2.5, (d, n_eff)

    @pytest.mark.parametrize("shape", SHAPES)
    def test_gumbel_skewed_exactness(self, shape):
        # Gumbel(0,1): log p = -(x + e^{-x}), CDF = exp(-exp(-x)): smooth,
        # heavily skewed; catches errors that preserve Gaussian moments.
        draws = _draws(lambda p: -(p["x"] + torch.exp(-p["x"])), 0.5, shape, seed=1)
        d = _ks_distance(draws, lambda x: np.exp(-np.exp(-x)))
        n_eff = _effective_n(draws)
        assert d * math.sqrt(n_eff) < 2.5, (d, n_eff)


# ---------------------------------------------------------------------------
# Independent recursive multinomial NUTS oracle (numpy, own RNG), as the
# reference's test has it
# ---------------------------------------------------------------------------


class _RecursiveNUTS:
    """Textbook recursive multinomial NUTS with biased progressive doubling
    (Betancourt 2017, App. A; Stan's transition). Deliberately written from
    the paper, NOT from the reference's iterative kernel, as a trusted oracle."""

    def __init__(self, logp_and_grad, eps, max_depth=8, delta_max=1000.0,
                 rng=None):
        self.f = logp_and_grad
        self.eps = eps
        self.max_depth = max_depth
        self.delta_max = delta_max
        self.rng = rng or np.random.default_rng(0)

    def _leapfrog(self, z, r, grad, direction):
        eps = direction * self.eps
        r = r + 0.5 * eps * grad
        z = z + eps * r
        logp, grad = self.f(z)
        r = r + 0.5 * eps * grad
        return z, r, logp, grad

    def _energy(self, logp, r):
        return -logp + 0.5 * float(r @ r)

    def _build(self, z, r, grad, logp, depth, direction, e0):
        if depth == 0:
            z, r, logp, grad = self._leapfrog(z, r, grad, direction)
            e = self._energy(logp, r)
            diverging = (e - e0) > self.delta_max
            log_w = e0 - e  # multinomial weight relative to the start energy
            return dict(
                z_minus=z, r_minus=r, grad_minus=grad, logp_minus=logp,
                z_plus=z, r_plus=r, grad_plus=grad, logp_plus=logp,
                z_prop=z, logp_prop=logp, grad_prop=grad,
                log_w=log_w, r_sum=r.copy(), turning=False,
                diverging=bool(diverging),
            )
        first = self._build(z, r, grad, logp, depth - 1, direction, e0)
        if first["turning"] or first["diverging"]:
            return first
        if direction > 0:
            second = self._build(
                first["z_plus"], first["r_plus"], first["grad_plus"],
                first["logp_plus"], depth - 1, direction, e0,
            )
            first["z_plus"] = second["z_plus"]
            first["r_plus"] = second["r_plus"]
            first["grad_plus"] = second["grad_plus"]
            first["logp_plus"] = second["logp_plus"]
        else:
            second = self._build(
                first["z_minus"], first["r_minus"], first["grad_minus"],
                first["logp_minus"], depth - 1, direction, e0,
            )
            first["z_minus"] = second["z_minus"]
            first["r_minus"] = second["r_minus"]
            first["grad_minus"] = second["grad_minus"]
            first["logp_minus"] = second["logp_minus"]
        # Uniform multinomial choice between the two equal-size subtrees.
        log_w = np.logaddexp(first["log_w"], second["log_w"])
        p_second = math.exp(second["log_w"] - log_w) if np.isfinite(log_w) else 0.0
        if self.rng.uniform() < p_second:
            first["z_prop"] = second["z_prop"]
            first["logp_prop"] = second["logp_prop"]
            first["grad_prop"] = second["grad_prop"]
        first["log_w"] = log_w
        r_sum = first["r_sum"] + second["r_sum"]
        turning = (
            (r_sum @ first["r_minus"] <= 0) or (r_sum @ first["r_plus"] <= 0)
        )
        first["r_sum"] = r_sum
        first["turning"] = second["turning"] or bool(turning)
        first["diverging"] = second["diverging"]
        return first

    def step(self, z):
        logp, grad = self.f(z)
        r = self.rng.standard_normal(z.shape)
        e0 = self._energy(logp, r)
        tree = dict(
            z_minus=z, r_minus=r, grad_minus=grad, logp_minus=logp,
            z_plus=z, r_plus=r, grad_plus=grad, logp_plus=logp,
            z_prop=z, logp_prop=logp, grad_prop=grad,
            log_w=0.0, r_sum=r.copy(), turning=False, diverging=False,
        )
        depth = 0
        while not tree["turning"] and not tree["diverging"] and depth < self.max_depth:
            direction = 1.0 if self.rng.uniform() < 0.5 else -1.0
            if direction > 0:
                sub = self._build(
                    tree["z_plus"], tree["r_plus"], tree["grad_plus"],
                    tree["logp_plus"], depth, direction, e0,
                )
                if not sub["turning"] and not sub["diverging"]:
                    tree["z_plus"] = sub["z_plus"]
                    tree["r_plus"] = sub["r_plus"]
                    tree["grad_plus"] = sub["grad_plus"]
                    tree["logp_plus"] = sub["logp_plus"]
            else:
                sub = self._build(
                    tree["z_minus"], tree["r_minus"], tree["grad_minus"],
                    tree["logp_minus"], depth, direction, e0,
                )
                if not sub["turning"] and not sub["diverging"]:
                    tree["z_minus"] = sub["z_minus"]
                    tree["r_minus"] = sub["r_minus"]
                    tree["grad_minus"] = sub["grad_minus"]
                    tree["logp_minus"] = sub["logp_minus"]
            valid = not sub["turning"] and not sub["diverging"]
            # Biased progressive transition: favor the new half.
            p_move = min(1.0, math.exp(min(sub["log_w"] - tree["log_w"], 0.0)))
            if valid and self.rng.uniform() < p_move:
                tree["z_prop"] = sub["z_prop"]
                tree["logp_prop"] = sub["logp_prop"]
            tree["log_w"] = np.logaddexp(tree["log_w"], sub["log_w"])
            if valid:
                r_sum = tree["r_sum"] + sub["r_sum"]
                tree["turning"] = sub["turning"] or bool(
                    (r_sum @ tree["r_minus"] <= 0)
                    or (r_sum @ tree["r_plus"] <= 0)
                )
                tree["r_sum"] = r_sum
            else:
                tree["turning"] = tree["turning"] or sub["turning"]
                tree["diverging"] = sub["diverging"]
            depth += 1
        return tree["z_prop"]


class TestRecursiveOracleCrossCheck:
    """Both implementations target a correlated 2D Gaussian with identical
    fixed tunables; each must match the analytic marginals, and their
    marginal quantiles must agree with each other."""

    RHO = 0.9
    EPS = 0.22
    N_ORACLE = 4_000
    N_KERNEL = 20_000

    def _logp_grad_np(self):
        rho = self.RHO
        prec = np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]]))

        def f(z):
            g = -prec @ z
            return -0.5 * float(z @ prec @ z), g

        return f

    def _oracle_draws(self):
        sampler = _RecursiveNUTS(
            self._logp_grad_np(), eps=self.EPS, max_depth=8,
            rng=np.random.default_rng(123),
        )
        z = np.zeros(2)
        out = np.empty((self.N_ORACLE, 2))
        for i in range(self.N_ORACLE):
            z = sampler.step(z)
            out[i] = z
        return out[200:]  # drop burn-in

    def _kernel_draws(self, chains):
        rho = self.RHO
        prec = torch.linalg.inv(torch.tensor([[1.0, rho], [rho, 1.0]]))

        def model(p):
            z = p["z"]
            return -0.5 * z @ prec @ z

        res = sample(
            model,
            {"z": torch.zeros(2)},
            num_samples=-(-self.N_KERNEL // chains),
            num_warmup=200,
            num_chains=chains,
            kernel="nuts",
            seed=5,
            step_size=self.EPS,
            adapt_step_size=False,
            adapt_mass_matrix=False,
            max_tree_depth=8,
            device="cpu",
        )
        assert float(res.tunables.step_size) == np.float32(self.EPS)
        assert torch.all(res.tunables.inv_mass_diag == 1.0)
        return res.samples["z"].numpy().astype(np.float64).reshape(-1, 2)

    @pytest.mark.parametrize("chains", [
        pytest.param(64, id="64x313"),
        pytest.param(4, id="4x5000", marks=pytest.mark.slow),
    ])
    def test_both_match_analytic_and_each_other(self, chains):
        from scipy.stats import norm

        oracle = self._oracle_draws()
        kernel = self._kernel_draws(chains)
        assert len(kernel) >= self.N_KERNEL

        qs = np.array([0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95])
        analytic = norm.ppf(qs)  # each marginal is N(0, 1)

        # MC error on a quantile ~ sqrt(q(1-q)/n_eff)/pdf(q); with heavy
        # autocorrelation at fixed eps, n_eff is conservatively ~n/20.
        tol_oracle = 4 * np.sqrt(qs * (1 - qs) / (len(oracle) / 20)) / norm.pdf(
            analytic
        )
        tol_kernel = 4 * np.sqrt(qs * (1 - qs) / (len(kernel) / 20)) / norm.pdf(
            analytic
        )
        for dim in range(2):
            qo = np.quantile(oracle[:, dim], qs)
            qk = np.quantile(kernel[:, dim], qs)
            assert np.all(np.abs(qo - analytic) <= tol_oracle), (qo, analytic)
            assert np.all(np.abs(qk - analytic) <= tol_kernel), (qk, analytic)
            assert np.all(np.abs(qk - qo) <= tol_oracle + tol_kernel), (qk, qo)

        # The hard direction of the correlated Gaussian: z0 - z1 has
        # std sqrt(2(1-rho)) = 0.447; multinomial-weighting bias inflates
        # or deflates it noticeably.
        hard_o = (oracle[:, 0] - oracle[:, 1]).std()
        hard_k = (kernel[:, 0] - kernel[:, 1]).std()
        target = math.sqrt(2 * (1 - self.RHO))
        assert abs(hard_o - target) < 0.1 * target, hard_o
        assert abs(hard_k - target) < 0.1 * target, hard_k
