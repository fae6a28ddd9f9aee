"""``build_sampler(..., collect_warmup=True)`` on the CPU, 8 chains of a
small anisotropic Gaussian.

- For every kernel the draws, the tunables, every info field and the host
  syncs are bit-identical with and without collecting, and ``run``
  returns ``(ChainResult, (positions, infos))`` in the reference's layout
  (``mlx_mcmc_tpu/inference/engine.py:416, 504-505``): positions ``(W, C,
  D)`` float32, infos stacked on a leading step axis, ChEES's with its
  endpoint fields; None for an empty warmup segment.
- The last collected position is the sampling phase's start.
- Warmup segments' collections concatenate to the whole run's.
- NUTS's executed leapfrogs, read from the collected and stored leaf
  counts (``bench.lockstep_leaves``), are exactly the value+grad calls.
"""

import pytest
import torch

from mlx_mcmc_tpu.kernels.base import TransitionInfo as JTransitionInfo
from mlx_mcmc_tpu.kernels.chees import ChEESInfo as JChEESInfo
from mlx_mcmc_tpu_torch.bench import lockstep_leaves
from mlx_mcmc_tpu_torch.inference.engine import build_sampler

C, D, W, S = 8, 4, 30, 20
SCALE = torch.tensor([0.5, 1.0, 2.0, 3.0])


def _vag(Z):
    return -0.5 * ((Z / SCALE) ** 2).sum(-1), -Z / SCALE**2


def _z0():
    return torch.linspace(-1.0, 1.0, C * D).reshape(C, D)


def _sampler(kernel, collect=False, vag=_vag, **kw):
    settings = dict(kernel=kernel, num_warmup=W, num_samples=S, value_and_grad_fn=vag,
                    max_tree_depth=6, num_leapfrog_steps=5, collect_warmup=collect)
    if kernel == "metropolis":
        settings["step_size"] = 0.5
    settings.update(kw)
    return build_sampler(None, D, **settings)


def _same(a, b):
    assert torch.equal(a.positions, b.positions)
    for x, y in zip(a.info, b.info):
        assert torch.equal(x, y)
    for x, y in zip(a.final_tunables, b.final_tunables):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert a.host_syncs == b.host_syncs and a.probe_evals == b.probe_evals


@pytest.mark.parametrize("kernel", ["nuts", "hmc", "chees", "mala", "metropolis"])
def test_collecting_changes_no_bit(kernel):
    plain = _sampler(kernel)(3, _z0())
    res, (positions, infos) = _sampler(kernel, collect=True)(3, _z0())
    _same(plain, res)
    assert positions.dtype == torch.float32 and tuple(positions.shape) == (W, C, D)
    want = JChEESInfo if kernel == "chees" else JTransitionInfo
    assert type(infos)._fields == want._fields
    for name, x in zip(type(infos)._fields, infos):
        width = (D,) if name in ("proposal_position", "end_velocity") else ()
        assert tuple(x.shape) == (W, C) + width, name
    assert torch.isfinite(positions).all()


@pytest.mark.parametrize("kernel", ["nuts", "chees"])
def test_last_collected_position_starts_the_draws(kernel):
    whole = _sampler(kernel)(3, _z0())
    warm, (positions, _) = _sampler(kernel, collect=True, num_samples=0)(3, _z0())
    assert torch.equal(positions[-1], warm.final_state.position)
    # the draws, continued from the last collected position
    rest = _sampler(kernel)(3, positions[-1], resume_state=(warm.final_adapt, warm.final_traj),
                           warmup_start=W, warmup_stop=W)
    assert torch.equal(rest.positions, whole.positions)


def test_segments_concatenate_to_the_whole_collection():
    _, (positions, infos) = _sampler("nuts", collect=True)(3, _z0())
    k = 12
    first, (p1, i1) = _sampler("nuts", collect=True, num_samples=0, warmup_stop=k)(3, _z0())
    _, (p2, i2) = _sampler("nuts", collect=True)(
        3, first.final_state.position, resume_state=(first.final_adapt, first.final_traj),
        warmup_start=k)
    assert torch.equal(torch.cat([p1, p2]), positions)
    for x1, x2, x in zip(i1, i2, infos):
        assert torch.equal(torch.cat([x1, x2]), x)
    # an empty segment collects nothing
    _, collected = _sampler("nuts", collect=True)(
        3, first.final_state.position, resume_state=(first.final_adapt, first.final_traj),
        warmup_start=W)
    assert collected is None


def test_collected_counts_give_the_executed_leapfrogs():
    calls = [0]

    def counting(Z):
        calls[0] += 1
        return _vag(Z)

    res, (_, infos) = _sampler("nuts", collect=True, vag=counting)(3, _z0())
    executed = (lockstep_leaves(infos.num_integration_steps.T).sum()
                + lockstep_leaves(res.info.num_integration_steps).sum())
    # one call a leapfrog for every chain; the first evaluates the starts
    assert calls[0] == 1 + res.probe_evals + int(executed)
