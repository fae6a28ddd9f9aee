"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name
   and power limit as nvidia-smi gives them.
2. Build: compiles every CUDA source (``glm_fused`` with its one-pass and
   wide paths, ``poisson_fused``, ``philox``, ``glm_variants``; one
   ``nvcc`` each, started together, sm_90a) into
   ``build/mlx_mcmc_tpu_torch/`` and prints the build time and ptxas's
   register report and performance remarks.
3. Kernels against their plain versions on the card, at each path's shape
   and at a ragged one, with CUDA-event timings and the bound (the largest
   of bytes, tensor-core, float32, transcendental and integer work at the
   H100's peaks, with the unit that binds): K1 (logistic) and K2 (linear)
   at C=4096, N=10K, D=100 bf16 through the one-pass TMA + wgmma kernel
   (K1 with its torch.profiler split), and K1 there on int8 X through the
   same kernel's widening stage (timed, with its split; also at N=777,
   D=37); K1 on the wide path at glm1000's shape (C=256, N=100K, D=1000) in
   bf16 and int8 (the TMA + wgmma value and gradient kernels, int8 widened
   in shared memory: their torch.profiler split, the two products as
   torch.matmul on (widened) bf16 X as a yardstick; bf16 also the design
   floor), with the seconds the glm1000 data took, and K2 there in bf16; K1
   wide and int8, K2 wide and K4 (hoisted) at ragged wide shapes; K1, K2
   and K4 on f32 X (the 3xTF32 TMA + wgmma pair, on the reference's X in
   float32) at the glm100 shape (timed, with the two products as
   torch.matmul in float32 as a yardstick) and at C=70, N=777, D=300, and
   K1 there at glm1000's shape (timed); against ll and g computed in
   float64 from the same X, y and Z, the f32 kernels' max errors (ll per
   chain, g) must be at most twice the plain float32 version's (K1, K2, K4
   at glm100, K1 at glm1000); K4 at the glm100 shape, with its
   rebuilt ll against K1's (the reference's rejected variant, measured); K3
   (Poisson) at C=512, G=1000, n=100, K=4 (with its profiler split) and
   C=300, G=37, n=61, K=3; Philox at the glm100 step shape (4096 chains,
   D=100, a 32-row uniform table). Bits: two calls give the same bits and
   chains 0-3 of a C=4 call equal those of the full call, for K1, K2 and K4
   one-pass, K1 int8 one-pass and K1, K2 and K4 f32 at glm100 (C=4096), K1
   wide and int8 wide at glm1000 (C=256) and K3 (C=512). The int8 kernels are held to
   the bf16 tolerances (int8 values widen to bf16 exactly), int8 wide at
   glm1000 to the wide g tolerance below.
3b. The microbenchmark variants of K1's body (``ops/glm_variants.py``,
   ``csrc/glm_variants.cu``; no sampling path): the two benchmark entry
   points (``mlx_mcmc_tpu_torch.benchmarks.glm_kernel_variants`` and
   ``.flagship_decomposition``'s ablation and grid sweep, then its depth
   sweep) are the path, with the launch counts set to 0 before and read
   after each; then each variant at the reference's shape (the flagship
   operands, 10,240 x 128 bf16, C = 4096; mm1_pair with 1,024-row tiles)
   and floor at Dp = 256 and 1024 (the wide pair) against its plain
   version, two calls to the same bits, timed.
3c. CUDA graphs of the NUTS transition (``inference/graphs.py``) against
   the eager loop (one host check per pair iteration): three steps at
   fixed tunables from the engine's per-chain draws through K1 on bf16 X
   (glm100, 4096 chains; also with ``static_schedule=True``), K1 on int8
   and f32 X, K1 wide (glm1000, 256 chains), K2 (linear, 4096 chains), K3
   (poisson1000_cov, 512 chains), the sufficient-statistic vags of
   hier1000 and poisson1000 (512 chains) and the generic autograd
   value+grad (the funnel, 512 chains, and glm100's plain GLM over f32 X,
   4096 chains; captured because their models declare ``graph_safe``, and
   reported as eager if they did not). Every output of every step must be
   bit-identical, twice (capture, then replays of the cached graphs).
3d. HMC (10 leapfrogs), Metropolis and MALA transitions as one CUDA graph
   each (``graphs.GraphedStep``) against the eager loop: three steps at
   fixed tunables through K1 on bf16 X (glm100, 4096 chains), every output
   bit for bit, no host read inside a transition, two replays after the
   first (eager) step; and three ChEES transitions of 3, 1 and 5 leapfrogs
   through ``graphs.GraphedTrajectory`` (a start graph, a one-leapfrog
   graph replayed n times, an end graph) the same way, the endpoint fields
   too.
4. ``glm100_fused`` at full width through ``sample()`` and K1 (100 params,
   10K obs, bf16 X, 4096 chains, 300 warmup + 2000 draws, depth 6, target
   0.8, bf16 store) on the reference's dataset (its threefry streams):
   accept 0.8 +- 0.05, mean tree depth < 5, divergence rate <= 1%, finite
   draws, posterior moments against a Laplace approximation; the
   statistics are printed beside the reference's (BENCH_r05.json).
4e. Checkpoints at glm100_fused's full width through K1, right after
   phase 4 and against its run (the same data, vag, seed and settings):
   ``run_warmup(..., stop=150)``, ``save_checkpoint`` into a temporary
   directory, ``load_checkpoint``, ``resume_warmup(..., num_samples=2000)``;
   then ``sample()`` at 300 + 1000, save, load and ``resume(...,
   num_samples=1000)``, and ``resume`` again from the live result. The
   draws and every info field equal phase 4's bit for bit (the resumed
   ones its draws [1000, 2000), the first run's its [0, 1000)), the
   mid-warmup tunables phase 4's. Launches are exact, over each path's two
   segments: K1 phase 4's + 1 (the continuation evaluates its start) - 3
   (below), Philox phase 4's, host syncs phase 4's (the continuation's
   probe evaluations 0), and the second resume launches what the first
   did. Every segment has phase 4's settings, value+grad (the model is
   None) and data, so each runs on phase 4's cached runner and replays its
   graphs: no segment captures a graph (``graphs.capture.count``), and no
   path repeats the capture's eager warm-up that phase 4's K1 holds (a
   root and ``graphs.PAIRS_PER_REPLAY`` pair iterations: 3 launches).
   Prints each segment's wall, the save and load seconds and the file's
   bytes.
4f. Parallel tempering at glm100_fused's full width through K1, run
   right after phase 4e: ``sample_tempered(kernel="nuts")`` with 512
   chains x 8 rungs (geometric, ``beta_min`` 0.1: 4096 rows a K1 launch),
   300 + 1000, depth 6, target 0.8, phase 4's data and fused vag, the
   reference bench's value path as ``log_prob``. Every K1 launch at 4096
   rows; K1 exactly 1 (init) + each transition's root and two per pair
   iteration + 3 (the capture's warm-up), the swaps none; Philox one step
   draw and one raw-word launch (the swap uniforms) a transition. The cold
   rung: accept within 0.05 of 0.8, divergences <= 1%, finite draws of
   shape (512, 1000, 100), the Laplace check, every posterior mean within
   4 combined MCSEs of phase 4's NUTS. Swap acceptance finite in [0, 1];
   the rungs' step sizes finite and positive, the hottest above the cold.
   The final cold state's log_prob and grad against one fresh K1
   evaluation at its positions (K1's tolerances). Chains 0-3 of a 4-chain
   run (3 transitions at fixed tunables through graphs) equal the
   512-chain run's bit for bit. The busy share over a 20 + 20 run. HMC and
   MALA under tempering at the same width, 100 + 100: K1 exactly 1 + 200 x
   10 and 1 + 200, 199 replays, no host sync; accept within 0.05 of 0.8
   (HMC) or in ``ACCEPT_BAND`` (MALA), divergences, finite draws, the
   Laplace check; each called again with the same settings runs on the
   cached runner: no graph captured, the same K1 count, the same draws. Each run prints its wall, host syncs, replays, the
   per-boundary swap acceptance and the rungs' step sizes.
4g. The measurement layer at glm100_fused's full width through K1, right
   after phase 4f: (a) phase 4's ``roofline`` block (the bench line's
   ``detail.roofline``, ``bench.roofline_detail``): all twelve fields,
   ``0 < mfu_pct <= 100``, ``roofline_frac_pct <= 105``, ``lockstep_tax >=
   1``, and ``total_leapfrogs x lockstep_tax`` within 10% of the
   chain-leapfrogs phase 4's K1 launches imply (K1 - 1 - its probe
   evaluations, times the chains; warmup is an estimate); (b)
   ``build_sampler(..., collect_warmup=True)`` at 50 + 50 (4096 chains):
   draws, every info field and the tunables bit-identical to the same run
   without collecting, K1 and Philox launches and host syncs equal, the
   positions float32 of shape (50, 4096, 100), the infos stacked (steps,
   chains), and K1 exactly 1 + the probe's + the capture's warm-up + the
   executed leapfrogs of both phases (``bench.lockstep_leaves`` of the
   collected warmup counts and the draws'); (c) the native R-hat and ESS
   (``csrc/fastdiag.c``, gcc) against the numpy path on 512 chains x 2,000
   draws x 16 parameters of phase 4's draws in float64: ESS within rtol
   1e-6, R-hat 1e-8, both times printed; (d) ``utils.trace_to`` around a
   5 + 5 run through K1: one Chrome trace that names
   ``glm_onepass_kernel``.
4h. Chains over ranks (``parallel.sample_sharded``) at glm100_fused's full
   width through K1, on a world of one, right after phase 4g: (a)
   ``initialize_distributed()`` starts nccl with one rank (the NCCL
   version printed; the first collective, which builds the communicator,
   timed on its own); (b) ``sample_sharded`` with phase 4's settings, data,
   vag and seed (4096 chains, 300 + 2000, depth 6, target 0.8, bf16 store)
   and ``device_diagnostics=True``: phase 4's sampler bands, the Laplace
   check, every posterior mean within 4 combined MCSEs of phase 4's NUTS,
   ``device_stats`` (max R-hat, min ESS) printed beside phase 4's and
   within 1e-6 relative of the single-device ``device_rhat`` and
   ``device_ess_chunked`` of the same draws; the wall beside phase 4's,
   K1 and Philox launches, host syncs, replays, and the count and time of
   the collectives (adaptation, diagnostics, and the final gather apart);
   (c) ``sample_sharded`` and ``sample()`` at 4096 chains with phase 4's
   adapted step size and metric (``init_inv_mass_diag``), adaptation off,
   50 + 200: the draws and every info field bit for bit, the K1 and
   Philox launches equal; (d) the facade's ``chain_method='sharded'``
   (NUTS, 100 + 100) through K1: K1 launched, finite draws; (e) the
   process group destroyed.
4i. Observation sharding and sharded checkpoints at glm100_fused's full
   width through K1, on a world of one (nccl), right after phase 4h: (a)
   ``sample_sharded`` on ``data_chain_mesh(1, 1)`` with ``data_axis='data'``,
   phase 4's data packed by ``prepare_fused_logistic_data(num_shards=1)``
   (phase 4's bits) and split by ``fused_data_specs``, the likelihood-only
   K1 value+grad (``include_prior=False``) and the closed-form N(0, 1)
   prior as ``log_prior_fn``, NUTS forced to its static schedule (depth 6,
   4096 chains, 300 + 500, target 0.8, bf16 store): phase 4's sampler bands,
   the Laplace check and means within 4 combined MCSEs of phase 4's NUTS;
   K1 launches exactly 1 (init) + the probe's + 63 a transition + 63 (the
   capture's eager warm-up), one data-axis sum a K1 launch (counted inside
   the graphs), Philox a step and the probe's, host syncs the probe's only
   (none inside a transition), three replays a transition and three
   captures; the wall printed. (b) on ``chain_mesh()``, phase 4's vag and
   data: ``sample_sharded`` 100 + 400, then 100 + 200, ``save_checkpoint``,
   ``load_checkpoint`` and ``resume(..., mesh=...)`` 200, and
   ``run_warmup(mesh=..., stop=50)`` then ``resume_warmup(mesh=...)``: the
   draws and every info field the uninterrupted run's bit for bit, no
   graph captured by any continuation; resuming that checkpoint on
   ``data_chain_mesh(1, 1)`` with a data axis raises.
4a. The same on int8 X (``quantize="int8"``) through the int8 one-pass
   kernel, cut to 100 + 100: the same checks, the Laplace approximation
   on the dequantized X; and on f32 X (``x_dtype="float32"``, the
   reference's X before its bf16 cast) through the 3xTF32 pair, cut to
   100 + 100: the same checks, the Laplace approximation on that X.
4b. ``glm1000_fused`` at full width through ``sample()`` and K1's wide path
   (1000 params, 100K obs, bf16 X, 256 chains, 400 + 400, depth 8, target
   0.8, f32 store): accept 0.8 +- 0.05, mean tree depth < 7, divergence
   rate <= 1%, finite draws of shape (256, 400, 1000), the Laplace check at
   D = 1000.
4c. HMC at glm100_fused's full width through the ``MCMC`` facade and K1,
   run right after phase 4e:
   ``MCMC(None).run(method="hmc", num_chains=4096, num_warmup=300,
   num_samples=2000, num_leapfrog_steps=10)`` with the fused K1 vag, the
   reference's dataset and a bf16 store. Prints wall, host syncs, graph
   replays, K1 and Philox launches, mean accept, divergences and min-ESS.
   K1 launches must be exactly 2300 x 10 + 1 (init) + the probe's (its
   host syncs: an HMC transition reads nothing on the host), Philox 2300 +
   1, replays one per transition after the first; mean accept within 0.05
   of 0.8, divergences <= 1%, the Laplace check, and every posterior mean
   within 4 combined MCSEs of the NUTS main path's.
4d. ChEES and MALA at glm100_fused's full width through K1 (the same data,
   chains, 300 + 2000 and bf16 store), run right after phase 4c:
   ``MCMC(None).run(method="chees")`` through the facade, ``sample(kernel=
   "mala")``, and MALA again with ``draw_chunk=500``. Each prints wall, host
   syncs, graph replays, K1 and Philox launches, mean accept, divergences
   and (the first two) min-ESS and min-ESS per wall second. Launches must be
   exact, against the probe's evaluations as the run reports them
   (``probe_evals``): Philox 2300 + 1 on each path; ChEES K1 1 (init) + the
   probe's + the sum of the 2,300 transitions' leapfrog counts, its host
   syncs the probe's + 300 + 1 (a count read per warmup step, one for the
   draws); MALA K1 2300 + 1 + the probe's, host syncs the probe's, 2,299
   replays; chunked MALA K1 3 more (each continuation evaluates its start),
   the same host syncs, and 2,300 replays and no capture: it runs on the
   unchunked run's runner and graphs (the chunk size is no key of the
   runner cache).
   ChEES's counts must be equal across chains in every draw and equal to
   those read, its final trajectory length finite and above its step size.
   Mean accept in ``ACCEPT_BAND`` (below), divergences <= 1%, finite bf16 draws, the Laplace check and every
   posterior mean within 4 combined MCSEs of phase 4's NUTS; the chunked
   run's draws and every info field equal the unchunked run's bit for bit.
5. Funnel detail: centered eight schools at the bench's detail-row settings
   (``bench.FUNNEL_DETAIL``: 512 chains, 400 + 400, target 0.9, depth 10),
   through the generic autograd value+grad replayed as CUDA graphs (the
   model declares ``graph_safe``; run eagerly, the full row took 919 s on
   the H100 and the smoke cut it).
6. Linear path through K2: Gaussian linear regression, 100 features, 10K
   obs, bf16 X, 4096 chains, 300 + 2000, depth 6, target 0.8, bf16 store:
   accept 0.8 +- 0.05, depth < 5, divergence rate <= 1%, posterior mean and
   sd against the exact Gaussian posterior on the same bf16 X (float64).
7. ``poisson1000_cov`` at full width through K3 (1000 groups x 100 counts,
   K=4, 512 chains, 400 + 400, depth 8, target 0.9, bf16 store): accept
   0.9 +- 0.05, mean depth < 7, divergence rate <= 1%, finite draws, beta,
   mu and tau posterior means within 4 posterior sd (+0.02) of the
   generator's truth.
7b. The reference's other bench configs through ``sample()`` at their full
   bench settings, each on the reference's dataset and through CUDA graphs:
   ``hier1000`` (998 groups x 100 observations through the sufficient
   statistics, 512 chains, 400 + 1000, depth 10, bf16 store),
   ``hier1000_full`` (every observation through autograd, 128 chains, 400 +
   400), ``poisson1000`` (1000 groups x 100 counts through the sufficient
   statistics, 512 chains, 400 + 1000, depth 10, target 0.9), ``glm100``
   and ``glm1000`` (autograd over f32 X: 4096 chains, 500 + 500, depth 8;
   16 chains, 400 + 400, depth 8), and the standalone ``funnel8`` at its
   full width (1024 chains, depth 10, target 0.8), cut to 100 + 100. Each
   prints its wall, host syncs, graph replays and Philox launches, and
   fails with no replay or no Philox launch; accept within 0.05 of its
   target, mean depth below its cap less 1, divergences <= 1% (the funnel
   exempt, as in phase 5) and finite draws. Posteriors: hier1000's mu and
   tau = exp(log_tau) within 4 posterior sd (+0.02) of the generator's
   truth; hier1000 against hier1000_full, mu's and log_tau's means within 4
   combined Monte Carlo standard errors (sd / sqrt(ESS), ESS on the card);
   poisson1000's mu and tau against the truth as in phase 7; glm100 and
   glm1000 against the Laplace approximation on the same f32 X.
7c. ADVI: ``fit_advi`` on glm100's plain model at full width (f32 X,
   10K x 100, autograd), 'meanfield' (learning rate 0.05) and 'fullrank'
   (``ADVI_FULLRANK_LR``), 1000 steps of 8 draws each: q's mean and
   marginal sd against the Laplace approximation on the same X, within
   ``ADVI_BAND``; then ``sample(init_strategy='advi')`` at
   poisson1000_cov's bench settings, K3 (the model's fused vag) driving
   the fit and the transitions: phase 7's checks; the fit, timed inside
   that run, launching K3 exactly 500 times (one a step, at 8 rows) + 1
   (the starts' densities) and Philox 500 + 1 (the starts); the run's K3
   exactly the fit's + 1 (init) + the probe's + each transition's root and
   two per pair iteration + 3 if it captured its graphs (the capture's
   eager warm-up; it runs on phase 7's runner, so it need not); Philox the
   fit's + 1 (the probe's draw) + 800.
8. Layout invariance: three NUTS steps at fixed tunables, driven by the
   engine's per-chain draws and replayed as the transition's CUDA graphs,
   through a small elementwise model (4 and 8 chains), glm100_fused's K1
   vag on bf16, int8 and f32 X (4 and 4096 chains) and poisson1000_cov's
   K3 vag (4 and 512 chains) and hier1000's sufficient-statistic vag (4
   and 512 chains): chains 0-3 must be bit-identical. The same for three
   HMC and three Metropolis transitions through one graph each (the
   elementwise model at 4 and 8 chains; HMC also through K1, 4 and 4096).
9. The README quick start (``README.md:9-27``'s model over 1,000 N(3, 1.5)
   draws from numpy's seed 0) through ``MCMC.run`` with 'nuts', 'hmc',
   'metropolis' and 'hmc' with ``transforms={"sigma": "log"}``, 8 chains,
   1000 + 1000, eagerly (the model declares no ``graph_safe``):
   ``print_summary()``, each run's wall, host syncs and Philox launches;
   mu's and sigma's means within 4 MCSE of the posterior means by
   quadrature (float64), R-hat < 1.05, every sigma draw positive.
9b. The other samplers on the card: ``sample_tempered`` on
   ``tests/test_tempered.py``'s bimodal model (declared ``graph_safe``) at
   512 chains x 8 rungs (``beta_min`` 0.02, 800 + 1200, NUTS depth 6): the
   cold chains' share in the right mode in (0.2, 0.8). ``sample_ensemble``
   on ``tests/test_ensemble.py``'s Gaussian and correlated targets at its
   settings and through ``MCMC.run(method="ensemble")``, with that test's
   bounds; then at glm100_fused's data with 4096 walkers, 300 + 2000, on
   the bench's plain bf16 value path: mean accept inside
   ``ENSEMBLE_ACCEPT_BAND``, Philox one step draw (the starts) and 2,300
   raw-word launches; wall and min-ESS printed. ``sample_smc`` on
   ``tests/test_smc.py``'s three targets at 16,384 particles with its
   bounds (stages, host reads and walls printed). The posterior predictive
   of phase 4's draws cut to 64 chains x 100 draws (y ~ Bernoulli(sigmoid(X
   beta)) over the 10K rows, one ``torch.Generator`` a chain on the card
   under ``torch.func.vmap(randomness="different")``): shape (64, 100,
   10000), mean rate within 0.01 of y's mean, chains 0-1 the same with 2
   chains. ``pointwise_log_likelihood`` of the same draws, ``waic`` and
   ``psis_loo``: finite, the two elpds within twice the larger standard
   error; p_waic, p_loo and the share of k > 0.7 printed.
10. The kernels JSON line (K1 one-pass, K1 wide, K1 int8 one-pass and wide,
   K2, K3, K4, Philox, and K1, K2 and K4 on f32 X, K1 also at glm1000; K4,
   int8 wide, K2 and K4 f32 and K1 f32 at glm1000, on no sampling path,
   with their phase-3 launches; K1 f32 with the f32 cut run's; the
   variants with their launches from phase 3b's entry points; K1 one-pass
   with phase 4c's HMC, phase 4d's ChEES, MALA and chunked MALA and phase
   4e's checkpoint paths' and phase 4f's, 4g's, 4h's and 4i's, K3 with phase
   7c's, and Philox with its launches on each path of phases 4c, 4d, 4e, 4f,
   4g, 4h, 4i, 7b, 7c, 9 and 9b beside the main path's, and its raw-word kernel's on 4f's and 9b's
   paths), then the
   contract line
   ``{"ok": true, "device": {...}}`` last.

Every path runs with the launch counts set to 0 just before it and read
just after; a path that launched one of its kernels no time fails. Phases
4-7 sample through ``sample()``, whose transitions replay CUDA graphs
wherever the value+grad declares that they may (every fused path): each
prints its wall, host syncs, graph replays and the pair iterations per
replay, and a path whose value+grad declares ``graph_safe`` (every one
since phase 7b's configs) that replayed no graph fails. Launches inside a
graph are counted at capture and added at every replay.
Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): dense bf16 tensor cores,
# float32 outside the tensor cores, 32-bit integer issue (64 INT32 lanes
# per SM against 128 FP32: half the float32 rate), HBM3.
H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12
H100_INT32_OPS = 33.5e12
H100_BYTES_PER_S = 3.35e12
# Transcendentals (exp, log, tanh, sin, ...): the special-function units do
# 16 per clock per SM, 132 SMs at the 1.98 GHz boost clock.
H100_MUFU_OPS = 16 * 132 * 1.98e9

# GLM (K1, K2, K4) tolerances against the plain version, which rounds at the
# same points (bf16 and int8 X; f32 X rounds nowhere, see below):
# - ll: both sum 10K f32 terms of O(1) in different orders (~1e-3 nats);
#   0.05 nats stays well below the 0.1-0.5 nats of noise that collapsed
#   adaptation in the reference (its rejected hoisted kernel).
# - g: a last-bit change of s in another summation order can flip the bf16
#   rounding of single residuals (one bf16 ulp, 2^-9 relative), which moves
#   g by about 1e-3 of max|g|.
LL_TOL_NATS = 0.05
G_TOL_REL, G_TOL_ABS = 1e-2, 1e-3
# The wide bf16 kernels at glm1000's shape (N = 100K): there max|g| ~ 150 to
# 650 grows with N while a single residual flip does not, so 1e-2 of max|g|
# would let a whole 64-row chunk of the gradient kernel's split schedule be
# dropped or taken twice. Their measured error is ~1e-5 of max|g|; g is held
# to 1e-4 of max|g| (+1e-3), still ~10x that.
WIDE_G_TOL_REL = 1e-4
# Sums that grow with N add 1e-6 of their size: the linear ll (a sum of
# squares, ~1e4 nats), K4's sum of softplus, and K1's ll at N = 100K, where
# |ll| ~ 7e4 and one float32 ulp is 0.0078 nats, so the summation order
# alone moves ll by several ulps.
LL_TOL_REL = 1e-6
# f32 X: nothing is rounded, so single residuals no longer flip by a bf16 ulp
# and g is held to 1e-4 of max|g| (+1e-4): summation order and the 3xTF32
# split (~2^-22 of each product) move it by a few f32 ulps of its terms. ll
# as above. Against float64 (ll and g from the same X, y and Z), the f32
# kernels' max error may be at most F64_ERR_RATIO times the plain float32
# version's: float32-class accuracy, which TF32 alone would miss by ~1000x.
F32_G_TOL_REL, F32_G_TOL_ABS = 1e-4, 1e-4
F64_ERR_RATIO = 2.0
# K3 is float32 throughout: FMA contraction and summation order move single
# rates by an ulp, so its gradients get 1e-4 of their max (+1e-3) and its
# centered ll the same 0.05 nats (+1e-6 relative).
K3_G_TOL_REL = 1e-4
# Philox: words and uniforms bit for bit; normals to the last ulp of
# logf/sincosf against torch's log/cos/sin (|z| < 5.8).
NORMAL_TOL = 2e-6
# The variants of K1's body (accurate epilogues, no MUFU form): ll per chain
# within 1e-3 + 1e-5 of |ll| (f32 sums of 10K rows in another order), g
# within 1e-4 of max|g| + 1e-5 and two residual flips (a last-bit change of
# s flips the bf16 rounding of a residual now and then, moving g by up to
# max|x| times a bf16 ulp of the residual: glm_variants.residual_flip).
# mm1_pair's ll within 1e-4 relative, except chains where one bf16(ll)
# rounds the other way (the plain version with that one rounding flipped
# matches them within 1e-4): where the running ll passes near a bf16
# rounding boundary, or is small beside the terms it sums, another
# summation order or accumulation of s may round it the other way (on the
# H100, chains 2, 9 and 2304 f32 ulps from a boundary did). The chains
# within one ulp of a boundary may be at most 0.1% of them, the flipped
# ones 0.5% (0.1% measured).
VAR_LL_TOL_ABS, VAR_LL_TOL_REL = 1e-3, 1e-5
VAR_G_TOL_REL, VAR_G_TOL_ABS = 1e-4, 1e-5
PAIR_LL_TOL_REL, PAIR_BOUNDARY_SHARE, PAIR_FLIP_SHARE = 1e-4, 1e-3, 5e-3


# ChEES's and MALA's mean accept at glm100_fused over 300 + 2000: at least
# the target less 0.05 (ChEES 0.651, MALA 0.574); at most 0.05 above the
# highest that either package gave there over seeds and chain counts
# (tools/glm100_chees_mala_accept.py: both packages on the CPU at 64, 256
# and 512 chains, the port on the H100 at 4096). Dual averaging's averaged
# step size, which the draws use, lands conservative of the target in the
# reference as here: ChEES 0.672-0.771 (two modes of the adapted
# trajectory, near 3 and near 5.5), MALA 0.718-0.746. A step size adapted
# too large shows below the band, one collapsed toward 0 above it.
ACCEPT_BAND = {"chees": (0.651 - 0.05, 0.82), "mala": (0.574 - 0.05, 0.80)}

# Phase 4f: parallel tempering at glm100_fused's data, 512 chains x 8 rungs
# (4096 rows a K1 launch), warmup + draws.
TEMPER_CHAINS, TEMPER_RUNGS, TEMPER_SETTINGS = 512, 8, (300, 1000)
# Phase 9b: the ensemble sampler at glm100_fused's data (300 + 2000),
# tempered SMC's populations and tempering's chains on the bimodal target.
ENSEMBLE_WALKERS, SMC_PARTICLES, BIMODAL_CHAINS = 4096, 16384, 512
# The ensemble's mean accept there (tools/glm100_ensemble_accept.py, both
# packages on the CPU): 0.1535-0.1584 at 512 walkers over seeds 0-3 in
# either package; at 4096 walkers (seed 0) 0.1442 in the reference and
# 0.1441 in the port. The walker count moves it, so the band is taken at
# the smoke's 4096: those readings +- 0.01, twice the 512-walker spread
# over seeds. A stretch scale or log-ratio gone wrong moves it far outside.
ENSEMBLE_ACCEPT_BAND = (0.134, 0.155)

# ADVI at glm100 (phase 7c), 1000 steps, against the Laplace approximation
# on the same X: max |mu - MAP| / sd at most the first number, q's marginal
# sd over the Laplace sd in the range. Set from both packages on the CPU,
# seeds 0-11 (tools/glm100_advi_bands.py): mean-field (learning rate 0.05)
# gaps 0.113-0.148 in the reference, 0.107-0.150 in the port, sd ratios
# 0.966-1.039 and 0.966-1.056; full-rank at ADVI_FULLRANK_LR gaps
# 0.258-0.274 and 0.255-0.271 (the mean still closing on the MAP, in both
# alike), ratios 1.000-1.041 and 1.001-1.036. The bands: the reference's
# highest gap plus ~0.1 sd, the sd ratio within 10% (phase 4's band for
# the draws). Full-rank at the default 0.05 diverges in both packages
# (gaps 9-107 sd); at 0.01 two of the reference's twelve seeds and one of
# the port's went astray (gaps 2.2-2.7 sd).
ADVI_FULLRANK_LR = 0.005
ADVI_BAND = {"meanfield": (0.25, (0.9, 1.1)), "fullrank": (0.35, (0.9, 1.1))}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def roofline_ms(nbytes: float, tensor_flops: float = 0.0, f32_ops: float = 0.0,
                transcendentals: float = 0.0, int32_ops: float = 0.0,
                tf32_flops: float = 0.0) -> tuple:
    """The least time for the work: the largest of the bytes over the HBM
    rate, bf16 tensor-core operations over 989 TFLOP/s, TF32 tensor-core
    operations over 495 TFLOP/s, float32 operations over 67 TFLOP/s,
    transcendentals over the special-function units' rate and 32-bit
    integer operations over their rate. Returns (ms, bound_by, detail):
    ``bound_by`` is "bytes" or "operations", ``detail`` names the unit that
    binds."""
    times = {"bytes": nbytes / H100_BYTES_PER_S, "tensor cores": tensor_flops / H100_BF16_FLOPS,
             "tf32 tensor cores": tf32_flops / H100_TF32_FLOPS,
             "float32": f32_ops / H100_F32_FLOPS, "transcendentals": transcendentals / H100_MUFU_OPS,
             "int32": int32_ops / H100_INT32_OPS}
    detail = max(times, key=times.get)
    return times[detail] * 1e3, "bytes" if detail == "bytes" else "operations", detail


def glm_bound_ms(n: int, d: int, c: int, epilogue_ops: int, transcendentals: int,
                 x_bytes: int = 2) -> tuple:
    """Least time for one K1/K2/K4 call: bytes (X at ``x_bytes`` per value,
    y, Z in; ll, g out), the two products (4NDC on bf16 tensor cores for
    bf16 and int8 X; for f32 X three times that on the TF32 tensor cores,
    the 3xTF32 design's own work), the epilogue's float32 operations per
    (row, chain) (~12 logistic and hoisted, ~4 linear) and its
    transcendentals per (row, chain) (2 logistic and hoisted: an exp and a
    log; 0 linear)."""
    nbytes = n * d * x_bytes + n * 4 + c * d * 4 + c * 4 + c * d * 4
    products = 4.0 * n * d * c
    f32 = x_bytes == 4
    return roofline_ms(nbytes, tensor_flops=0.0 if f32 else products,
                       tf32_flops=3 * products if f32 else 0.0, f32_ops=epilogue_ops * n * c,
                       transcendentals=transcendentals * n * c)


def ffma_bound_ms(n: int, d: int, c: int, epilogue_ops: int) -> float:
    """Least time of an f32 K1/K2/K4 call with both products on the CUDA
    cores (float32 FMA, 67 TFLOP/s): the bound of the FFMA design the
    3xTF32 pair replaced."""
    return (4.0 * n * d * c + epilogue_ops * n * c) / H100_F32_FLOPS * 1e3


def wide_design_floor_ms(n: int, d_pad: int, c: int) -> float:
    """Least time of the two-kernel wide bf16 design by its bytes: X read
    by both kernels and the bf16 residual R^T (chains padded to 256, rows
    to 128) written once and read once, over HBM rate."""
    rt_bytes = -(-c // 256) * 256 * (-(-n // 128) * 128) * 2
    return (2 * n * d_pad * 2 + 2 * rt_bytes) / H100_BYTES_PER_S * 1e3


def poisson_bound_ms(c: int, g: int, n: int, k: int) -> tuple:
    """Least time for one K3 call: X, y, shat, lamhat, theta, beta in and
    ll, r_theta, g_beta out, against (4K + 8) f32 operations per (row,
    chain): K FMAs for s, the exp, ~7 for ll, r and r_theta, K FMAs for
    g_beta; and the exp on the special-function units."""
    rows = g * n
    nbytes = 4 * (rows * k + rows + 2 * g + c * g + c * k + c + c * g + c * k)
    return roofline_ms(nbytes, f32_ops=(4 * k + 8) * rows * c, transcendentals=rows * c)


def philox_bound_ms(c: int, dim: int, n_slots: int) -> tuple:
    """Least time for one Philox step: chain indices in, normals and the
    uniform table out, against ~100 32-bit integer operations per Philox
    call (10 rounds of two multiplies, their high words, three XORs and two
    key additions), ~40 f32 operations per Box-Muller pair and its four
    transcendentals (log, sqrt, sin, cos)."""
    blocks = -(-dim // 4)
    calls = c * (blocks + n_slots)
    nbytes = c * 8 + c * dim * 4 + c * n_slots * 16
    pairs = 2 * c * blocks
    return roofline_ms(nbytes, f32_ops=40 * pairs, transcendentals=4 * pairs,
                       int32_ops=100 * calls)


def variant_bound_ms(name: str, n: int, d_pad: int, c: int) -> tuple:
    """Least time of one variant call on the padded operands: X, y (where
    read), Z in, ll and g out; the products on the bf16 tensor cores (4 N
    Dp C, half that for mm1_sum); per (row, chain) ~12 float32 operations
    and 2 transcendentals for the tanh and exp epilogues (tanh and log, exp
    and log1p), ~2 operations for the sums and casts of the others."""
    nbytes = n * d_pad * 2 + (n * 4 if name in ("tanh_y", "split2") else 0) + 2 * c * d_pad * 4 + c * 4
    products = (2.0 if name == "mm1_sum" else 4.0) * n * d_pad * c
    epilogue = name in ("tanh_y", "tanh_hoist", "exp_hoist", "split2")
    return roofline_ms(nbytes, tensor_flops=products, f32_ops=(12 if epilogue else 2) * n * c,
                       transcendentals=(2 if epilogue else 0) * n * c)


def timed_row(row, kernel_call, plain_call, bound) -> dict:
    """Device times of the kernel and of its plain version, the bound, and
    ``call_ms``: the wrapper's time per call when the host sets the pace."""
    from mlx_mcmc_tpu_torch.bench import device_ms

    row["ms"] = device_ms(kernel_call)
    row["plain_ms"] = device_ms(plain_call, reps=5, inner=3)
    row["call_ms"] = device_ms(kernel_call, hide_host=False)
    row["bound_ms"], row["bound_by"], row["bound_detail"] = bound
    row["bound_share"] = row["bound_ms"] / row["ms"]
    log(f"  kernel {row['ms']:.4f} ms (per wrapper call {row['call_ms']:.4f} ms), "
        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_detail']}; "
        f"{100 * row['bound_share']:.1f}% of it)")
    return row


def device_breakdown_ms(fn, parts) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches (the bench's
    ``kernels_ms``), summed by the first of ``parts`` that its name
    contains. A diagnostic: if the profiler records no device time here, it
    says so and the smoke goes on."""
    from mlx_mcmc_tpu_torch.bench import kernels_ms

    try:
        out = dict.fromkeys(parts, 0.0)
        for name, ms in kernels_ms(fn).items():
            part = next((p for p in parts if p in name), None)
            if part is not None:
                out[part] += ms
    except Exception as exc:  # noqa: BLE001 -- a diagnostic must not end the smoke
        log(f"  breakdown: not measured ({type(exc).__name__}: {exc})")
        return {}
    if not any(out.values()):
        log("  breakdown: not measured (the profiler saw no device time)")
        return {}
    log("  breakdown per call: " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def check_glm(family: str, name: str, Xp, y, Z, timed: bool, ll_rel: float = None,
              g_rel: float = None, float64: bool = False, XpT=None) -> dict:
    """K1 (logistic), K2 (linear) or K4 (hoisted: y unused; ll is its sum
    of softplus) against the plain version. For int8 ``Xp``, ``Z`` is the
    scaled operand; f32 ``Xp`` comes with its ``XpT``. ``ll_rel`` defaults to 0 for K1, LL_TOL_REL otherwise;
    ``g_rel`` to F32_G_TOL_REL for f32 X, G_TOL_REL otherwise. With
    ``float64``, both are also held against ll and g in float64: the
    kernel's max error at most F64_ERR_RATIO times the plain version's."""
    from mlx_mcmc_tpu_torch.ops import glm

    if family == "hoisted":
        kernel = lambda: glm.fused_hoisted_vag_cuda(Xp, Z, XpT)  # noqa: E731
        plain = lambda: glm.fused_hoisted_vag_reference(Xp, Z)  # noqa: E731
    else:
        k, p = {
            "logistic": (glm.fused_logistic_vag_cuda, glm.fused_logistic_vag_reference),
            "linear": (glm.fused_linear_vag_cuda, glm.fused_linear_vag_reference),
        }[family]
        kernel = lambda: k(Xp, y, Z, XpT)  # noqa: E731
        plain = lambda: p(Xp, y, Z)  # noqa: E731
    tag = {"logistic": "K1", "linear": "K2", "hoisted": "K4"}[family]
    ll_k, g_k = kernel()
    ll_p, g_p = plain()
    torch.cuda.synchronize()
    if not (torch.isfinite(ll_k).all() and torch.isfinite(g_k).all()):
        fail(f"{tag} {name}: non-finite output")
    err_ll = float((ll_k - ll_p).abs().max())
    err_g = float((g_k - g_p).abs().max())
    g_max = float(g_p.abs().max())
    if ll_rel is None:
        ll_rel = 0.0 if family == "logistic" else LL_TOL_REL
    ll_tol = LL_TOL_NATS + ll_rel * float(ll_p.abs().max())
    c, d = Z.shape
    n, d_pad = Xp.shape
    dtype = {torch.int8: "int8", torch.float32: "f32"}.get(Xp.dtype, "bf16")
    g_abs = F32_G_TOL_ABS if dtype == "f32" else G_TOL_ABS
    if g_rel is None:
        g_rel = F32_G_TOL_REL if dtype == "f32" else G_TOL_REL
    log(f"{tag} {name}: C={c} N={n} D={d} Dp={d_pad} {dtype} max|dll|={err_ll:.3e} nats "
        f"(tol {ll_tol:.3e}) max|dg|={err_g:.3e} (tol {g_rel * g_max + g_abs:.3e}, "
        f"max|g|={g_max:.3e})")
    if err_ll > ll_tol:
        fail(f"{tag} {name}: ll error {err_ll} > {ll_tol}")
    if err_g > g_rel * g_max + g_abs:
        fail(f"{tag} {name}: grad error {err_g} > {g_rel} * {g_max} + {g_abs}")
    row = {"shape_c_n_d": [c, n, d], "x_dtype": dtype, "max_abs_err": max(err_ll, err_g),
           "max_abs_err_ll": err_ll, "max_abs_err_g": err_g}
    if float64:
        ll_d, g_d = glm.vag_float64(family, Xp, y, Z)
        for what, got_k, got_p, ref in (("ll", ll_k, ll_p, ll_d), ("g", g_k, g_p, g_d)):
            err_k = float((got_k.double() - ref).abs().max())
            err_p = float((got_p.double() - ref).abs().max())
            row[f"float64_err_{what}"] = {"kernel": err_k, "plain": err_p}
            log(f"  vs float64: {what} kernel {err_k:.4e}, plain f32 {err_p:.4e} "
                f"(ratio {err_k / err_p if err_p else float('inf'):.3f}; max|{what}| "
                f"{float(ref.abs().max()):.4e})")
            if err_k > F64_ERR_RATIO * err_p:
                fail(f"{tag} {name}: {what} error against float64 {err_k} > {F64_ERR_RATIO} x the "
                     f"plain float32 version's {err_p}")
        del ll_d, g_d
    if timed:
        ops, trans = (4, 0) if family == "linear" else (12, 2)
        timed_row(row, kernel, plain, glm_bound_ms(n, d, c, ops, trans, Xp.element_size()))
        if dtype == "f32":
            row["ffma_bound_ms"] = ffma_bound_ms(n, d, c, ops)
            log(f"  the FFMA design's bound (float32): {row['ffma_bound_ms']:.4f} ms")
    return row


def bits_check(label: str, call, Z, *rest) -> None:
    """A kernel is reproducible and batch-invariant: two calls of
    ``call(Z, *rest)`` give the same bits, and chains 0-3 of a call with
    only those four chains (the first four rows of ``Z`` and of each of
    ``rest``) give the bits of the full call."""
    a = call(Z, *rest)
    b = call(Z, *rest)
    four = call(*(t[:4].contiguous() for t in (Z, *rest)))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{label}: two calls on the same inputs give different bits")
    if not all(torch.equal(x[:4], y) for x, y in zip(a, four)):
        fail(f"{label}: chains 0-3 of a C=4 call differ from those of the C={Z.shape[0]} call")
    log(f"{label}: two calls bit-identical; chains 0-3 bit-identical at C=4 and C={Z.shape[0]}")


def glm_bits_check(label: str, Xp, y, Z, XpT=None) -> None:
    from mlx_mcmc_tpu_torch.ops import glm

    bits_check(label, lambda z: glm.fused_logistic_vag_cuda(Xp, y, z, XpT), Z)


def products_yardstick_ms(Xp, Z, chain_tile: int = 256) -> float:
    """A GLM call's two products alone as torch.matmul in X's type (bf16;
    f32 with TF32 off, as the port sets it) at the kernels' shapes (X Z^T
    with chains padded to ``chain_tile``, then R^T X): what the library's
    GEMMs take for them. A yardstick only; the port never calls it."""
    from mlx_mcmc_tpu_torch.bench import device_ms

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the f32 yardstick would not be float32")
    n, d_pad = Xp.shape
    c_pad = -(-Z.shape[0] // chain_tile) * chain_tile
    zb = torch.zeros(c_pad, d_pad, dtype=Xp.dtype, device=Xp.device)
    zb[: Z.shape[0], : Z.shape[1]] = Z
    rt = torch.randn(c_pad, n, device=Xp.device).to(Xp.dtype)

    def products():
        torch.matmul(Xp, zb.T)
        torch.matmul(rt, Xp)

    t = device_ms(products)
    log(f"  yardstick: the two products as torch.matmul ({Xp.dtype}) {t:.4f} ms")
    return t


def hoisted_gap(data, Z) -> dict:
    """K4's rebuilt ll (yX . bf16(z) - sum softplus) against K1's one-pass
    ll on the same inputs, in nats over the chains: the reference rejected
    K4 for 0.1-0.5 nats of such noise on its TPU. Fails only on non-finite
    output."""
    from mlx_mcmc_tpu_torch.ops import glm

    yX = glm.hoisted_outcomes(data["Xp"], data["yp"], data["dim"])
    ll_h, _ = glm.hoisted_logistic_value_and_grad(data["Xp"], yX, Z)
    ll_1, _ = glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z)
    gap = (ll_h - ll_1).abs()
    if not bool(torch.isfinite(gap).all()):
        fail("K4 rebuilt ll: non-finite")
    out = {"max_abs_dll_vs_k1": float(gap.max()), "median_abs_dll_vs_k1": float(gap.median())}
    log(f"K4 rebuilt ll vs K1 ll over {Z.shape[0]} chains: max |dll| "
        f"{out['max_abs_dll_vs_k1']:.4e} nats, median {out['median_abs_dll_vs_k1']:.4e} nats "
        f"(|ll| ~ {float(ll_1.abs().mean()):.1f})")
    return out


def check_poisson(name: str, data: dict, theta, beta, timed: bool) -> dict:
    from mlx_mcmc_tpu_torch.ops.poisson import (
        fused_poisson_vag_cuda,
        fused_poisson_vag_reference,
    )

    args = (data["X"], data["y"], data["shat"], data["lamhat"], theta, beta)
    out_k = fused_poisson_vag_cuda(*args)
    out_p = fused_poisson_vag_reference(*args)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in out_k):
        fail(f"K3 {name}: non-finite output")
    errs = [float((a - b).abs().max()) for a, b in zip(out_k, out_p)]
    maxes = [float(b.abs().max()) for b in out_p]
    g, n, k = data["X"].shape
    c = theta.shape[0]
    log(f"K3 {name}: C={c} G={g} n={n} K={k} max|dll|={errs[0]:.3e} nats "
        f"(max|ll|={maxes[0]:.3e}) max|dr_theta|={errs[1]:.3e} (max {maxes[1]:.3e}) "
        f"max|dg_beta|={errs[2]:.3e} (max {maxes[2]:.3e})")
    if errs[0] > LL_TOL_NATS + 1e-6 * maxes[0]:
        fail(f"K3 {name}: ll error {errs[0]}")
    for err, mx, what in zip(errs[1:], maxes[1:], ("r_theta", "g_beta")):
        if err > K3_G_TOL_REL * mx + G_TOL_ABS:
            fail(f"K3 {name}: {what} error {err} > {K3_G_TOL_REL} * {mx} + {G_TOL_ABS}")
    row = {"shape_c_g_n_k": [c, g, n, k], "max_abs_err": max(errs),
           "max_abs_err_ll": errs[0], "max_abs_err_r_theta": errs[1],
           "max_abs_err_g_beta": errs[2]}
    if timed:
        timed_row(row, lambda: fused_poisson_vag_cuda(*args),
                  lambda: fused_poisson_vag_reference(*args), poisson_bound_ms(c, g, n, k))
    return row


def check_philox(name: str, chains, dim: int, n_slots: int, timed: bool) -> dict:
    from mlx_mcmc_tpu_torch.ops import random as prng

    seed, step = 0x0123456789ABCDEF, 1234
    z_k, u_k = prng.step_draws_cuda(seed, chains, step, dim, n_slots)
    z_p, u_p = prng.step_draws_reference(seed, chains, step, dim, n_slots)
    w_k = [prng.words_cuda(seed, chains, step, 4, s) for s in (0, 1)]
    w_p = [prng.words(seed, chains, step, 4, s) for s in (0, 1)]
    torch.cuda.synchronize()
    err_z = float((z_k - z_p).abs().max())
    log(f"philox {name}: C={chains.shape[0]} D={dim} slots={n_slots} "
        f"max|dz|={err_z:.3e}, uniforms equal {torch.equal(u_k, u_p)}, "
        f"words equal {all(torch.equal(a, b) for a, b in zip(w_k, w_p))}")
    if not all(torch.equal(a, b) for a, b in zip(w_k, w_p)):
        fail(f"philox {name}: the kernel's words differ from the plain version's")
    if not torch.equal(u_k, u_p):
        fail(f"philox {name}: uniforms differ")
    if err_z > NORMAL_TOL:
        fail(f"philox {name}: normal error {err_z} > {NORMAL_TOL}")
    row = {"shape_c_d_slots": [chains.shape[0], dim, n_slots], "max_abs_err": err_z}
    if timed:
        timed_row(row, lambda: prng.step_draws_cuda(seed, chains, step, dim, n_slots),
                  lambda: prng.step_draws_reference(seed, chains, step, dim, n_slots),
                  philox_bound_ms(chains.shape[0], dim, n_slots))
    return row


VARIANT_SOURCE = "mlx_mcmc_tpu_torch/csrc/glm_variants.cu"
# The reference's kernels each variant replaces (floor: two, one body).
VARIANT_REPLACES = {
    "floor": ["benchmarks/glm_kernel_variants.py:53", "benchmarks/flagship_decomposition.py:68"],
    "mm1_sum": ["benchmarks/flagship_decomposition.py:60"],
    "floor_nosum": ["benchmarks/flagship_decomposition.py:82"],
    "tanh_y": ["benchmarks/glm_kernel_variants.py:68"],
    "tanh_hoist": ["benchmarks/glm_kernel_variants.py:89"],
    "exp_hoist": ["benchmarks/glm_kernel_variants.py:108"],
    "split2": ["benchmarks/flagship_decomposition.py:110"],
    "mm1_pair": ["benchmarks/flagship_decomposition.py:95"],
}


def check_variant(name: str, label: str, Xp, yp, Z) -> dict:
    """A variant of K1's body against its plain version on the card (the
    tolerances above), two calls to the same bits, timed."""
    from mlx_mcmc_tpu_torch.ops import glm_variants

    kernel, plain = glm_variants.VARIANTS[name]
    kw = {"tile_rows": 1024} if name == "mm1_pair" else {}
    call = lambda: kernel(Xp, yp, Z, **kw)  # noqa: E731
    plain_call = lambda: plain(Xp, yp, Z, **kw)  # noqa: E731
    out, again = call(), call()
    ll_p, g_p = plain_call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"{label}: two calls on the same inputs give different bits")
    ll_k, g_k = out
    if not (torch.isfinite(ll_k).all() and torch.isfinite(g_k).all()):
        fail(f"{label}: non-finite output")
    d_ll = (ll_k - ll_p).abs()
    err_g = float((g_k - g_p).abs().max())
    g_max = float(g_p.abs().max())
    c = Z.shape[0]
    n, d_pad = Xp.shape
    row = {"shape_c_n_dp": [c, n, d_pad], "max_abs_err": max(float(d_ll.max()), err_g),
           "max_abs_err_ll": float(d_ll.max()), "max_abs_err_g": err_g}
    if name == "mm1_pair":
        agree = glm_variants.mm1_pair_agreement(Xp, Z, ll_k, 1024, PAIR_LL_TOL_REL)
        row.update(boundary_chains=len(agree["boundary"]), flipped_chains=len(agree["flipped"]),
                   unexplained_chains=len(agree["unexplained"]),
                   max_rel_err_off_flipped=agree["max_rel_err"],
                   margins_of_flipped_ulps=agree["margins_of_flipped"].tolist())
        log(f"{label}: C={c} N={n} Dp={d_pad} max rel |dll| {agree['max_rel_err']:.3e} off the "
            f"{row['flipped_chains']} chains with one bf16(ll) rounded the other way (their margins "
            f"in f32 ulps {row['margins_of_flipped_ulps']}); {row['boundary_chains']} chains within "
            f"one ulp of a bf16 boundary; {row['unexplained_chains']} unexplained; |ll| up to "
            f"{float(ll_p.abs().max()):.3e}")
        if row["unexplained_chains"]:
            fail(f"{label}: ll of chains {agree['unexplained'][:10].tolist()} off by more than "
                 f"{PAIR_LL_TOL_REL} relative, not by one flipped bf16 rounding")
        if row["boundary_chains"] > PAIR_BOUNDARY_SHARE * c or row["flipped_chains"] > PAIR_FLIP_SHARE * c:
            fail(f"{label}: {row['boundary_chains']} chains within one ulp of a bf16 boundary "
                 f"(at most {PAIR_BOUNDARY_SHARE:.1%}) or {row['flipped_chains']} flipped (at most "
                 f"{PAIR_FLIP_SHARE:.1%}) of {c}")
        if bool(g_k.any()):
            fail(f"{label}: g is not zero")
    else:
        ll_tol = VAR_LL_TOL_ABS + VAR_LL_TOL_REL * ll_p.abs()
        g_tol = VAR_G_TOL_REL * g_max + VAR_G_TOL_ABS + 2 * glm_variants.residual_flip(name, Xp, Z)
        log(f"{label}: C={c} N={n} Dp={d_pad} max|dll|={float(d_ll.max()):.3e} (worst share of its "
            f"tol {float((d_ll / ll_tol).max()):.3f}) max|dg|={err_g:.3e} (tol {g_tol:.3e}, "
            f"max|g|={g_max:.3e})")
        if bool((d_ll > ll_tol).any()):
            fail(f"{label}: ll error above {VAR_LL_TOL_ABS} + {VAR_LL_TOL_REL} |ll|")
        if err_g > g_tol:
            fail(f"{label}: grad error {err_g} > {g_tol}")
    timed_row(row, call, plain_call, variant_bound_ms(name, n, d_pad, c))
    row["device_breakdown_ms"] = device_breakdown_ms(call, (
        "round_z", "glm_onepass", "glm_split2", "glm_mm1_pair", "glm_hopper_value",
        "glm_hopper_grad", "sum_splits"))
    return row


def variants_phase() -> list:
    """Phase 3b: the benchmark entry points as the path, then every
    variant against its plain version. Returns the variants' kernels rows."""
    from mlx_mcmc_tpu_torch.benchmarks import flagship_decomposition as fd
    from mlx_mcmc_tpu_torch.benchmarks import glm_kernel_variants as gkv
    from mlx_mcmc_tpu_torch.ops import glm_variants

    def emit(line):
        log(f"  {line}")

    glm_variants.reset_launch_counts()
    log("benchmarks.glm_kernel_variants:")
    gkv.run(emit)
    log("benchmarks.flagship_decomposition, ablation and grid sweep:")
    fd.ablation(emit)
    fd.grid_sweep(emit)
    launches = glm_variants.launch_counts()
    glm_variants.reset_launch_counts()
    log("benchmarks.flagship_decomposition, depth sweep:")
    fd.depth_sweep(emit)
    launches["floor_wide"] = glm_variants.launch_counts()["floor"]
    log(f"variant launches of the entry points: {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"the benchmark entry points launched {name} no time")

    Xp, yp, Z = fd.make_operands(10240, 128, 4096)
    rows = {name: check_variant(name, name, Xp, yp, Z) for name in glm_variants.VARIANTS}
    wide = {}
    for d_pad, n in ((256, 5120), (1024, 1280)):
        Xs, ys, Zs = fd.make_operands(n, d_pad, 4096, seed=1)
        wide[d_pad] = check_variant("floor", f"floor wide Dp={d_pad}", Xs, ys, Zs)
    kernels = []
    for key, row in list(rows.items()) + [("floor_wide", wide[1024])]:
        name = "floor" if key == "floor_wide" else key
        sums = ["sum_splits_kernel", "sum_splits_ll_kernel"]
        devs = {"mm1_pair": ["round_z_kernel", "glm_mm1_pair_kernel"],
                "split2": ["round_z_kernel", "glm_split2_kernel"] + sums,
                "floor_wide": ["round_z_kernel", "glm_hopper_value_kernel", "glm_hopper_grad_kernel"]
                + sums}.get(key, ["round_z_kernel", "glm_onepass_kernel"] + sums)
        extra = {k: v for k, v in row.items() if k not in ("ms", "plain_ms", "bound_ms", "bound_by")}
        extra.update(device_kernels=devs, sampling_path=False, also_replaces=VARIANT_REPLACES[name][1:])
        if key == "floor_wide":
            extra["variants"] = {"dp_256": wide[256]}
        kernels.append(dict(
            {"name": "glm_variant_" + ("floor:wide" if key == "floor_wide" else key), "route": "cuda",
             "source": VARIANT_SOURCE, "replaces": VARIANT_REPLACES[name][0],
             "launches": launches[key], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": None},
            **extra))
    return kernels


def drive(label: str, cfg: dict, problem=None) -> tuple:
    """One run of ``cfg`` through ``sample()``, launch counts set to 0 just
    before it and read just after. A path whose value+grad declares that
    graphs capture it must have replayed them."""
    from mlx_mcmc_tpu_torch.bench import build_problem, launch_counts, reset_launch_counts, run_config
    from mlx_mcmc_tpu_torch.inference import graphs

    problem = problem or build_problem(cfg)
    reset_launch_counts()
    metrics, result, _ = run_config(cfg, seed=1, problem=problem)
    metrics["launches"] = launch_counts()
    log(f"{label}: " + json.dumps(metrics))
    graphed = graphs.captures(problem[3].get("value_and_grad_fn") or problem[0])
    log(f"{label}: wall {metrics['wall_seconds']:.2f} s, host syncs {metrics['host_syncs']}, "
        f"graph replays {metrics['graph_replays']}, pairs per replay "
        f"{metrics['pairs_per_replay']}" + ("" if graphed else " (eager: not captured)"))
    if graphed and metrics["graph_replays"] == 0:
        fail(f"{label}: its value+grad is graph_safe, but no graph was replayed")
    return metrics, result


def bind(vag, data):
    """``vag(Z, data)`` as a one-argument value+grad, graph-safe as ``vag``."""
    from mlx_mcmc_tpu_torch.inference import graphs

    def bound(Z):
        return vag(Z, data)

    bound.graph_safe = graphs.captures(vag)
    return bound


def elementwise_vag():
    """A diagonal Gaussian's value+grad on the card (its constants made
    here: a capture may not copy host data to the card)."""
    inv_var = torch.tensor([1.0, 0.25, 4.0], device="cuda")

    def vag(Z):
        return -0.5 * (Z * Z * inv_var).sum(-1), -Z * inv_var

    vag.graph_safe = True
    return vag


def graphs_vs_eager(label: str, vag, dim: int, num_chains: int, step_size: float,
                    max_tree_depth: int, init_scale: float = 1.0, static: bool = False) -> dict:
    """Phase 3c: three NUTS steps at fixed tunables through ``vag`` from the
    engine's per-chain draws, eagerly (one host check per pair iteration)
    and through the transition's CUDA graphs (with ``static``, also the
    ``static_schedule`` graphs), twice each: every output bit for bit.
    Returns host-clock ms per step (eager; graphs after capture)."""
    from mlx_mcmc_tpu_torch.inference import graphs
    from mlx_mcmc_tpu_torch.inference.engine import step_inputs
    from mlx_mcmc_tpu_torch.kernels.base import Tunables
    from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
    from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel
    from mlx_mcmc_tpu_torch.ops.random import step_draws

    tun = Tunables(torch.tensor(step_size, device="cuda"), torch.ones(dim, device="cuda"))
    chains = torch.arange(num_chains, device="cuda")
    z0 = init_scale * step_draws(11, chains, 999, dim, 0)[0]

    def three(step_fn):
        state = HMCState(z0, *vag(z0))
        outs, syncs = [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(3):
            r0, U = step_inputs(11, chains, t, tun.inv_mass_diag, 1 << (max_tree_depth - 1))
            state, info, n = step_fn(state, tun, r0, U)
            syncs += n
            outs.append([x.clone() for x in (*state, *info)])
        torch.cuda.synchronize()
        return outs, syncs, (time.perf_counter() - t0) / 3 * 1e3

    if not graphs.captures(vag):
        log(f"graphs vs eager ({label}): the value+grad is not graph_safe; it runs eagerly")
        return {"captured": False}
    _, eager_step = make_nuts_kernel(vag, max_tree_depth=max_tree_depth)
    three(eager_step)
    ref, ref_syncs, eager_ms = three(eager_step)
    out = {"captured": True, "eager_ms_per_step": eager_ms, "eager_host_syncs": ref_syncs}
    runs = {"graphs": False, "static_schedule graphs": True} if static else {"graphs": False}
    for name, static_schedule in runs.items():
        transition = graphs.GraphedTransition(vag, max_tree_depth, static_schedule)
        for attempt in ("capture", "replay"):
            got, syncs, ms = three(transition.step)
            for t, (a, b) in enumerate(zip(ref, got)):
                for field, x, y in zip(_STEP_FIELDS, a, b):
                    if x.dtype != y.dtype or not torch.equal(x, y):
                        fail(f"graphs vs eager ({label}, {name}, {attempt}): step {t} {field} "
                             "differs from the eager loop's")
        if static_schedule and syncs != 0:
            fail(f"graphs vs eager ({label}): static_schedule made {syncs} host syncs")
        out[f"{name}_ms_per_step"] = ms
        out[f"{name}_host_syncs"] = syncs
        out[f"{name}_replays"] = transition.replays
    log(f"graphs vs eager ({label}): bit-identical over 3 steps; " + json.dumps(out))
    return out


_STEP_FIELDS = ("position", "log_prob", "grad", "accept_prob", "is_accepted", "is_divergent",
                "energy", "info.log_prob", "num_integration_steps", "tree_depth", "step_size")


def check_sampler(label, metrics, target, max_depth, need, divergences: bool = True) -> None:
    for kernel in need:
        if metrics["launches"][kernel] == 0:
            fail(f"{label} launched {kernel} no time")
    if abs(metrics["mean_accept"] - target) > 0.05:
        fail(f"{label}: mean accept {metrics['mean_accept']} outside {target} +- 0.05")
    if metrics["mean_tree_depth"] >= max_depth:
        fail(f"{label}: mean tree depth {metrics['mean_tree_depth']} >= {max_depth}")
    if divergences and metrics["divergence_rate"] > 0.01:
        fail(f"{label}: divergence rate {metrics['divergence_rate']} > 1%")


def draw_moments(draws):
    """Mean and sd per parameter of a (chains, draws, D) store, float64."""
    d = draws.shape[-1]
    flat = draws.reshape(-1, d)
    mean = torch.zeros(d, dtype=torch.float64, device=draws.device)
    sq = torch.zeros(d, dtype=torch.float64, device=draws.device)
    for chunk in flat.split(1 << 20):
        chunk = chunk.double()
        mean += chunk.sum(0)
        sq += (chunk * chunk).sum(0)
    mean /= flat.shape[0]
    return mean, torch.sqrt(sq / flat.shape[0] - mean * mean)


def moment_gap(beta_draws, center, sd_ref):
    mean, sd = draw_moments(beta_draws)
    ratio = sd / sd_ref
    return float(((mean - center).abs() / sd_ref).max()), float(ratio.min()), float(ratio.max())


def laplace_fit(data):
    """The Laplace approximation of the logistic posterior (unit normal
    prior): Newton MAP and the inverse Hessian's sd, float64, on the same
    bf16-rounded X, or int8 X times its column scales."""
    d = data["dim"]
    X = data["Xp"][:, :d].double()
    if "col_scale" in data:
        X = X * data["col_scale"].double()
    y = data["yp"].double()
    b = torch.zeros(d, dtype=torch.float64, device=X.device)
    eye = torch.eye(d, dtype=torch.float64, device=X.device)
    for _ in range(50):
        p = torch.sigmoid(X @ b)
        grad = X.T @ (y - p) - b
        hess = (X * (p * (1 - p))[:, None]).T @ X + eye
        step = torch.linalg.solve(hess, grad)
        b = b + step
        if float(step.abs().max()) < 1e-12:
            break
    return b, torch.sqrt(torch.diagonal(torch.linalg.inv(hess)))


def laplace_check(data, beta_draws):
    """Posterior mean and sd of the logistic draws against the Laplace
    approximation (:func:`laplace_fit`). At N = 10K, D = 100 the two agree
    to ~0.1 sd."""
    return moment_gap(beta_draws, *laplace_fit(data))


def exact_gaussian_check(data, beta_draws):
    """Posterior mean and sd of the linear-regression draws against the
    exact Gaussian posterior (float64, on the same bf16-rounded X, unit
    noise and prior): precision X^T X + I, mean its inverse times X^T y."""
    d = data["dim"]
    X = data["Xp"][:, :d].double()
    y = data["yp"].double()
    cov = torch.linalg.inv(X.T @ X * data["inv_noise_var"] + torch.eye(d, dtype=torch.float64, device=X.device))
    mean = cov @ (X.T @ y) * data["inv_noise_var"]
    return moment_gap(beta_draws, mean, torch.sqrt(torch.diagonal(cov)))


def layout_invariance(label: str, vag, dim: int, counts: tuple, step_size: float,
                      max_tree_depth: int, init_scale: float = 1.0) -> None:
    """Three NUTS steps at fixed tunables through ``vag`` for chains 0-3 of
    a run of each chain count in ``counts``, each chain's start and random
    inputs from the engine's per-chain streams: chains 0-3 must come out
    bit-identical."""
    from mlx_mcmc_tpu_torch.inference import graphs
    from mlx_mcmc_tpu_torch.inference.engine import step_inputs
    from mlx_mcmc_tpu_torch.kernels.base import Tunables
    from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
    from mlx_mcmc_tpu_torch.ops.random import step_draws

    if not graphs.captures(vag):
        fail(f"layout invariance ({label}): the value+grad is not graph_safe")
    tun = Tunables(torch.tensor(step_size, device="cuda"), torch.ones(dim, device="cuda"))
    out = {}
    for c in counts:
        chains = torch.arange(c, device="cuda")
        transition = graphs.GraphedTransition(vag, max_tree_depth)
        z0 = init_scale * step_draws(11, chains, 999, dim, 0)[0]
        state = HMCState(z0, *vag(z0))
        infos = []
        for t in range(3):
            r0, U = step_inputs(11, chains, t, tun.inv_mass_diag, 1 << (max_tree_depth - 1))
            state, info, _ = transition.step(state, tun, r0, U)
            infos.append(info.tree_depth.clone())
        out[c] = (state.position[:4].clone(), state.log_prob[:4].clone(),
                  torch.stack(infos, 1)[:4])
    for a, b in zip(out[counts[0]], out[counts[1]]):
        if not torch.equal(a, b):
            fail(f"layout invariance ({label}): chains 0-3 differ between a {counts[0]}-chain "
                 f"and a {counts[1]}-chain run")
    log(f"layout invariance ({label}): chains 0-3 bit-identical over 3 steps at {counts[0]} and "
        f"{counts[1]} chains through CUDA graphs (tree depths {out[counts[0]][2].tolist()})")


def mean_mcse(draws):
    """Mean and Monte Carlo standard error (sd / sqrt(ESS), the ESS on the
    card) of one parameter's (chains, draws) store."""
    from mlx_mcmc_tpu_torch.diagnostics.device import device_ess

    mean, sd = draw_moments(draws.reshape(-1, 1))
    ess = float(device_ess(draws.float()[..., None])[0])
    return float(mean), float(sd) / math.sqrt(ess), float(sd)


def truth_check(label, draws, truth):
    """A posterior mean within 4 posterior sd (+0.02) of the truth."""
    mean, sd = draw_moments(draws.reshape(-1, 1))
    gap = abs(float(mean) - truth)
    log(f"  {label}: mean {float(mean):.4f} sd {float(sd):.4f} truth {truth:.4f}")
    if gap > 4 * float(sd) + 0.02:
        fail(f"{label}: mean {float(mean)} is {gap} from truth {truth}")


def poisson_truth_checks(label: str, s: dict, truth: dict) -> None:
    """poisson1000_cov's beta, mu and tau = exp(log_tau) posterior means
    within 4 posterior sd (+0.02) of the generator's truth."""
    checks = {f"beta[{i}]": (s["beta"][..., i], float(truth["beta"][i])) for i in range(4)}
    checks["mu"] = (s["mu"], truth["mu"])
    checks["tau"] = (torch.exp(s["log_tau"].float()), truth["tau"])
    for name, (draws, want) in checks.items():
        truth_check(f"{label} {name}", draws, want)


def plain_data(data) -> dict:
    """A plain GLM's f32 ``X`` and ``y`` as the Laplace helpers take them."""
    return {"dim": data["X"].shape[1], "Xp": data["X"], "yp": data["y"]}


def plain_laplace(data, beta):
    """``laplace_check`` on a plain GLM's f32 ``X`` and ``y``."""
    return laplace_check(plain_data(data), beta)


def advi_gap(mean, sd, center, sd_ref) -> tuple:
    """A fitted q against the Laplace approximation: max |mean - MAP| /
    sd and the range of q's marginal sd over the Laplace sd (float64)."""
    mean, sd = torch.as_tensor(mean).double(), torch.as_tensor(sd).double()
    ratio = sd.to(sd_ref.device) / sd_ref
    return (float(((mean.to(center.device) - center).abs() / sd_ref).max()),
            float(ratio.min()), float(ratio.max()))


def other_configs(CONFIGS, h_problem, po_problem, g_problem, t_start) -> dict:
    """Phase 7b: the reference's other bench configs through ``sample()``
    (see the module docstring). Returns each path's Philox launches."""
    from mlx_mcmc_tpu_torch.bench import build_problem
    from mlx_mcmc_tpu_torch.models import make_hierarchical_normal, make_poisson_event_rates

    philox = {}

    def run(name, cfg, problem=None, funnel=False):
        metrics, result = drive(name, cfg, problem)
        launched = metrics["launches"]["philox_step_draws"]
        log(f"{name}: wall {metrics['wall_seconds']:.2f} s, host syncs {metrics['host_syncs']}, "
            f"graph replays {metrics['graph_replays']}, Philox launches {launched}; accept "
            f"{metrics['mean_accept']:.4f}, depth {metrics['mean_tree_depth']:.3f}, divergences "
            f"{metrics['divergences']}, min-ESS {metrics['min_ess']:.1f}")
        if metrics["graph_replays"] == 0:
            fail(f"{name} replayed no graph")
        # the funnel's divergences are the point of it (as in phase 5)
        check_sampler(name, metrics, cfg["target_accept"], cfg["max_tree_depth"] - 1,
                      ["philox_step_draws"], divergences=not funnel)
        for k, v in result.samples.items():
            if v.shape[:2] != (cfg["num_chains"], cfg["num_samples"]):
                fail(f"{name} draws {k} have shape {tuple(v.shape)}")
            if not bool(torch.isfinite(v).all()):
                fail(f"{name} draws {k} are not finite")
        philox[name] = launched
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        return metrics, result

    hcfg = CONFIGS["hier1000"]
    _, hres = run("hier1000", hcfg, h_problem)
    truth = make_hierarchical_normal(hcfg["num_groups"], hcfg["obs_per_group"], seed=0).truth
    truth_check("hier1000 mu", hres.samples["mu"], truth["mu"])
    truth_check("hier1000 tau", torch.exp(hres.samples["log_tau"].float()), truth["tau"])
    suff = {k: mean_mcse(hres.samples[k]) for k in ("mu", "log_tau")}
    del hres
    _, fres = run("hier1000_full", CONFIGS["hier1000_full"])
    for k in ("mu", "log_tau"):
        m_s, se_s, _ = suff[k]
        m_f, se_f, _ = mean_mcse(fres.samples[k])
        log(f"  hier1000 vs hier1000_full {k}: {m_s:.5f} +- {se_s:.5f} against "
            f"{m_f:.5f} +- {se_f:.5f}")
        if abs(m_s - m_f) > 4 * math.hypot(se_s, se_f):
            fail(f"hier1000 and hier1000_full disagree on {k}: {m_s} against {m_f}")
    del fres
    po_cfg = CONFIGS["poisson1000"]
    _, pres = run("poisson1000", po_cfg, po_problem)
    truth = make_poisson_event_rates(po_cfg["num_groups"], po_cfg["obs_per_group"], seed=0).truth
    truth_check("poisson1000 mu", pres.samples["mu"], truth["mu"])
    truth_check("poisson1000 tau", torch.exp(pres.samples["log_tau"].float()), truth["tau"])
    del pres
    for name, problem in (("glm100", g_problem), ("glm1000", None)):
        cfg = CONFIGS[name]
        problem = problem or build_problem(cfg)
        _, gres = run(name, cfg, problem)
        z_gap, sd_lo, sd_hi = plain_laplace(problem[2], gres.samples["beta"])
        log(f"{name} vs Laplace on the same f32 X: max |mean - MAP| / sd = {z_gap:.4f}, "
            f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
        if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
            fail(f"{name}: posterior moments disagree with the Laplace approximation")
        del gres, problem
    cut = dict(CONFIGS["funnel8"], num_warmup=100, num_samples=100)
    log("funnel8 standalone: 1024 chains, depth 10, target 0.8, cut to 100 + 100 (the bench: "
        "500 + 500)")
    run("funnel8 (100 + 100)", cut, funnel=True)
    return philox


def fixed_trip_steps(kernel: str, vag, dim: int, num_chains: int, step_size: float,
                     init_scale: float, graphed: bool) -> tuple:
    """Three HMC (10 leapfrogs), MALA or Metropolis (on ``vag``'s value)
    transitions at fixed tunables from the engine's per-chain draws, eagerly
    or through ``graphs.GraphedStep``: every output of every step, cloned,
    and the GraphedStep."""
    from mlx_mcmc_tpu_torch.inference import graphs
    from mlx_mcmc_tpu_torch.inference.engine import make_kernel, step_inputs
    from mlx_mcmc_tpu_torch.kernels.base import Tunables
    from mlx_mcmc_tpu_torch.ops.random import step_draws

    batched = vag if kernel in ("hmc", "mala") else (lambda Z: vag(Z)[0])
    init_fn, step_fn = make_kernel(kernel, batched, num_leapfrog_steps=10)
    tun = Tunables(torch.tensor(step_size, device="cuda"), torch.ones(dim, device="cuda"))
    chains = torch.arange(num_chains, device="cuda")
    state = init_fn(init_scale * step_draws(11, chains, 999, dim, 0)[0])
    graph = graphs.GraphedStep(step_fn) if graphed else None
    outs = []
    for t in range(3):
        if kernel == "hmc":
            x, U = step_inputs(11, chains, t, tun.inv_mass_diag, 1)
        else:
            x, U = step_draws(11, chains, t, dim, 1)
        state, info, syncs = (graph.step if graphed else step_fn)(state, tun, x, U)
        if syncs:
            fail(f"{kernel}: a transition read the host {syncs} times")
        outs.append([v.clone() for v in (*state, *info)])
    return outs, graph


def fixed_trip_graphs_vs_eager(label: str, kernel: str, vag, dim: int, num_chains: int,
                               step_size: float, init_scale: float) -> None:
    """Phase 3d: three transitions through one graph each equal the eager
    loop bit for bit (the first step is the capture's eager warm-up, the
    other two replays)."""
    ref, _ = fixed_trip_steps(kernel, vag, dim, num_chains, step_size, init_scale, False)
    got, graph = fixed_trip_steps(kernel, vag, dim, num_chains, step_size, init_scale, True)
    fields = ("position", "log_prob", "grad")[:len(ref[0]) - 8] + _STEP_FIELDS[3:]
    for t, (a, b) in enumerate(zip(ref, got)):
        for field, x, y in zip(fields, a, b):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"graphs vs eager ({label}): step {t} {field} differs from the eager loop's")
    if graph.replays != 2:
        fail(f"graphs vs eager ({label}): {graph.replays} replays for steps 2 and 3")
    accepted = float(torch.stack([o[-7] for o in ref]).float().mean())
    log(f"graphs vs eager ({label}): bit-identical over 3 steps, one graph per transition, "
        f"{graph.replays} replays, accepted share {accepted:.3f}")


def chees_graphs_vs_eager(label: str, vag, dim: int, num_chains: int, step_size: float,
                          init_scale: float, counts: tuple = (3, 1, 5)) -> None:
    """Phase 3d: three ChEES transitions at fixed tunables, with the
    leapfrog counts ``counts``, from the engine's per-chain draws, eagerly
    and through ``graphs.GraphedTrajectory``: every output bit for bit, and
    after the first (eager) transition the start graph, n leapfrog graphs
    and the end graph replayed per transition."""
    from mlx_mcmc_tpu_torch.inference import graphs
    from mlx_mcmc_tpu_torch.inference.engine import step_inputs
    from mlx_mcmc_tpu_torch.kernels.base import Tunables
    from mlx_mcmc_tpu_torch.kernels.chees import make_chees_kernel, make_chees_parts
    from mlx_mcmc_tpu_torch.ops.random import step_draws

    tun = Tunables(torch.tensor(step_size, device="cuda"), torch.ones(dim, device="cuda"))
    chains = torch.arange(num_chains, device="cuda")

    def three(graphed):
        init_fn, step_fn = make_chees_kernel(vag)
        state = init_fn(init_scale * step_draws(11, chains, 999, dim, 0)[0])
        graph = graphs.GraphedTrajectory(make_chees_parts(vag)) if graphed else None
        outs = []
        for t, n in enumerate(counts):
            r0, U = step_inputs(11, chains, t, tun.inv_mass_diag, 1)
            state, info, syncs = (graph.step if graphed else step_fn)(state, tun, r0, U, n)
            if syncs:
                fail(f"ChEES: a transition read the host {syncs} times")
            outs.append([v.clone() for v in (*state, *info)])
        return outs, graph

    ref, _ = three(False)
    got, graph = three(True)
    fields = ("position", "log_prob", "grad") + _STEP_FIELDS[3:] + (
        "proposal_position", "end_velocity")
    for t, (a, b) in enumerate(zip(ref, got)):
        for field, x, y in zip(fields, a, b):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"graphs vs eager ({label}): step {t} {field} differs from the eager loop's")
    want = sum(n + 2 for n in counts[1:])
    if graph.replays != want:
        fail(f"graphs vs eager ({label}): {graph.replays} replays, want {want} (start, "
             f"{counts[1:]} leapfrogs and end for steps 2 and 3)")
    accepted = float(torch.stack([o[4] for o in ref]).float().mean())
    log(f"graphs vs eager ({label}): bit-identical over 3 steps of {counts} leapfrogs, "
        f"{graph.replays} replays, accepted share {accepted:.3f}")


def fixed_trip_layout(label: str, kernel: str, vag, dim: int, counts: tuple, step_size: float,
                      init_scale: float) -> None:
    """Three HMC or Metropolis transitions through one graph each for a
    run of each chain count in ``counts``: chains 0-3 bit-identical."""
    out = {}
    for c in counts:
        steps, _ = fixed_trip_steps(kernel, vag, dim, c, step_size, init_scale, True)
        out[c] = [v[:4] for step in steps for v in step if v.dim() > 0]
    for a, b in zip(out[counts[0]], out[counts[1]]):
        if not torch.equal(a, b):
            fail(f"layout invariance ({label}): chains 0-3 differ between a {counts[0]}-chain "
                 f"and a {counts[1]}-chain run")
    log(f"layout invariance ({label}): chains 0-3 bit-identical over 3 steps at {counts[0]} and "
        f"{counts[1]} chains, one graph per transition")


def param_mean_mcse(draws) -> tuple:
    """Per parameter of a (chains, draws, P) store: mean, Monte Carlo
    standard error (sd / sqrt(ESS), the ESS on the card) and the ESS."""
    from mlx_mcmc_tpu_torch.diagnostics.device import device_ess_chunked

    mean, sd = draw_moments(draws)
    ess = device_ess_chunked(draws).double()
    return mean, sd / torch.sqrt(ess), ess


def hmc_full_width(cfg, init, data, vag, nuts_mean, nuts_se) -> dict:
    """Phase 4c: HMC at glm100_fused's full width through the ``MCMC``
    facade and K1 (see the module docstring). Returns the path's launches."""
    from mlx_mcmc_tpu_torch import MCMC
    from mlx_mcmc_tpu_torch.bench import launch_counts, reset_launch_counts

    L = 10
    mcmc = MCMC(None)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(init, num_samples=cfg["num_samples"], num_warmup=cfg["num_warmup"], method="hmc",
             num_chains=cfg["num_chains"], num_leapfrog_steps=L, value_and_grad_fn=vag, data=data,
             store_dtype="bfloat16", verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = launch_counts()
    res = mcmc.result
    del mcmc  # the facade's numpy copy of the draws
    transitions = cfg["num_warmup"] + cfg["num_samples"]
    k1, philox = launched["glm_fused_logistic"], launched["philox_step_draws"]
    beta = res.samples["beta"]
    mean, se, ess = param_mean_mcse(beta)
    accept = float(res.info.accept_prob.float().mean())
    log(f"glm100_fused HMC (facade, {L} leapfrogs): wall {wall:.2f} s (the facade's numpy copy "
        f"of the draws included), host syncs {res.host_syncs}, graph replays "
        f"{res.graph_replays}, K1 launches {k1}, Philox launches {philox}; mean accept "
        f"{accept:.4f} (accepted share {res.acceptance_rate:.4f}), divergences "
        f"{res.divergences}, min-ESS {float(ess.min()):.1f}, final step size "
        f"{float(res.tunables.step_size):.5f}")
    # init, one per probe evaluation and L per transition; the probe's
    # evaluations are the only host reads (HMC's transitions read nothing)
    probes = res.probe_evals
    want = transitions * L + 1 + probes
    if k1 != want:
        fail(f"glm100_fused HMC: {k1} K1 launches, want {transitions} x {L} + 1 (init) + "
             f"{probes} (probe) = {want}")
    if res.host_syncs != probes or probes < 1:
        fail(f"glm100_fused HMC: {res.host_syncs} host syncs, want {probes} (the probe's)")
    if philox != transitions + 1:
        fail(f"glm100_fused HMC: {philox} Philox launches, want {transitions} + 1 (probe)")
    if res.graph_replays != transitions - 1:
        fail(f"glm100_fused HMC: {res.graph_replays} graph replays, want one per transition "
             f"after the first ({transitions - 1})")
    if tuple(beta.shape) != (cfg["num_chains"], cfg["num_samples"], cfg["num_features"]) \
            or beta.dtype != torch.bfloat16 or not bool(torch.isfinite(beta).all()):
        fail(f"glm100_fused HMC: draws {tuple(beta.shape)} {beta.dtype} or non-finite")
    if abs(accept - 0.8) > 0.05:
        fail(f"glm100_fused HMC: mean accept {accept} outside 0.8 +- 0.05")
    if res.divergences > 0.01 * cfg["num_chains"] * cfg["num_samples"]:
        fail(f"glm100_fused HMC: {res.divergences} divergences")
    z_gap, sd_lo, sd_hi = laplace_check(data, beta)
    log(f"glm100_fused HMC vs Laplace: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail("glm100_fused HMC: posterior moments disagree with the Laplace approximation")
    z = (mean - nuts_mean).abs() / torch.hypot(se, nuts_se)
    log(f"glm100_fused HMC vs NUTS (the main path): max |mean gap| / combined MCSE = "
        f"{float(z.max()):.3f} over {z.numel()} parameters (HMC MCSE median "
        f"{float(se.median()):.2e}, NUTS {float(nuts_se.median()):.2e})")
    if float(z.max()) > 4:
        fail("glm100_fused HMC: posterior means disagree with NUTS's beyond 4 combined MCSEs")
    del res, beta
    from mlx_mcmc_tpu_torch import sample
    from mlx_mcmc_tpu_torch.bench import _device_busy

    # The device's busy share under the profiler: over 20 + 20 transitions,
    # as the bench measures every config (the probe, the capture and the
    # first, eager transition weigh on it), and over 100 + 200.
    busy = {}
    for warmup, draws in ((20, 20), (100, 200)):
        busy[f"{warmup}+{draws}"] = _device_busy(lambda: sample(
            None, init, data=data, value_and_grad_fn=vag, kernel="hmc",
            num_chains=cfg["num_chains"], num_warmup=warmup, num_samples=draws,
            num_leapfrog_steps=L, store_dtype="bfloat16"))
    log("glm100_fused HMC under the profiler: " + json.dumps(busy))
    return {"K1": k1, "philox": philox, "wall_seconds": wall, "busy": busy}


def posterior_checks(label: str, cfg, data, beta, nuts_mean, nuts_se) -> dict:
    """A glm100_fused path's draws: shape, bf16, finite; the Laplace check;
    every posterior mean within 4 combined MCSEs of NUTS's (the main path).
    Returns the min-ESS."""
    if tuple(beta.shape) != (cfg["num_chains"], cfg["num_samples"], cfg["num_features"]) \
            or beta.dtype != torch.bfloat16 or not bool(torch.isfinite(beta).all()):
        fail(f"{label}: draws {tuple(beta.shape)} {beta.dtype} or non-finite")
    z_gap, sd_lo, sd_hi = laplace_check(data, beta)
    log(f"{label} vs Laplace: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail(f"{label}: posterior moments disagree with the Laplace approximation")
    mean, se, ess = param_mean_mcse(beta)
    z = (mean - nuts_mean).abs() / torch.hypot(se, nuts_se)
    log(f"{label} vs NUTS (the main path): max |mean gap| / combined MCSE = "
        f"{float(z.max()):.3f} over {z.numel()} parameters ({label} MCSE median "
        f"{float(se.median()):.2e}, NUTS {float(nuts_se.median()):.2e})")
    if float(z.max()) > 4:
        fail(f"{label}: posterior means disagree with NUTS's beyond 4 combined MCSEs")
    return float(ess.min())


def chees_mala_full_width(cfg, init, data, vag, nuts_mean, nuts_se) -> dict:
    """Phase 4d: ChEES through the ``MCMC`` facade, MALA through
    ``sample()`` and MALA with ``draw_chunk=500`` at glm100_fused's full
    width through K1 (see the module docstring). Returns each path's K1 and
    Philox launches."""
    from mlx_mcmc_tpu_torch import MCMC, sample
    from mlx_mcmc_tpu_torch.bench import launch_counts, reset_launch_counts

    transitions = cfg["num_warmup"] + cfg["num_samples"]
    chains, draws = cfg["num_chains"], cfg["num_samples"]
    run_kw = dict(num_chains=chains, num_warmup=cfg["num_warmup"], num_samples=draws,
                  value_and_grad_fn=vag, data=data, store_dtype="bfloat16")
    out = {}

    def drive_path(label, run):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launch_counts()
        k1, philox = launched["glm_fused_logistic"], launched["philox_step_draws"]
        out[label] = {"K1": k1, "philox": philox, "wall_seconds": wall}
        accept = float(np.mean(res.info.accept_prob, dtype=np.float32)) if isinstance(
            res.info.accept_prob, np.ndarray) else float(res.info.accept_prob.float().mean())
        log(f"{label}: wall {wall:.2f} s, host syncs {res.host_syncs}, graph replays "
            f"{res.graph_replays}, K1 launches {k1}, Philox launches {philox}; mean accept "
            f"{accept:.4f} (accepted share {res.acceptance_rate:.4f}), divergences "
            f"{res.divergences}, final step size {float(res.tunables.step_size):.5f}")
        if philox != transitions + 1:
            fail(f"{label}: {philox} Philox launches, want {transitions} + 1 (probe)")
        if res.divergences > 0.01 * chains * draws:
            fail(f"{label}: {res.divergences} divergences")
        return res, accept, k1, wall

    def check_accept(label, accept, kernel):
        lo, hi = ACCEPT_BAND[kernel]
        if not lo <= accept <= hi:
            fail(f"{label}: mean accept {accept} outside [{lo}, {hi}]")

    # ChEES through the facade: K1 once at init, once per probe and once
    # per leapfrog; the host reads each warmup step's count and the draws'
    # counts once.
    label = "glm100_fused ChEES (facade)"
    mcmc = MCMC(None)
    res, accept, k1, wall = drive_path(label, lambda: (mcmc.run(
        init, method="chees", verbose=False, **run_kw), mcmc.result)[1])
    del mcmc  # the facade's numpy copy of the draws
    counts = res.leapfrog_counts
    steps = res.info.num_integration_steps
    probes = res.probe_evals
    traj, eps = float(res.tunables.trajectory_length), float(res.tunables.step_size)
    log(f"{label}: trajectory length {traj:.5f} ({traj / eps:.2f} step sizes), leapfrogs per "
        f"transition mean {sum(counts) / len(counts):.3f}, warmup {sum(counts[:cfg['num_warmup']])}"
        f", draws {sum(counts[cfg['num_warmup']:])}; probe evaluations {probes}")
    if len(counts) != transitions or probes < 1:
        fail(f"{label}: {len(counts)} counts read, {probes} probe evaluations")
    if res.host_syncs != probes + cfg["num_warmup"] + 1:
        fail(f"{label}: {res.host_syncs} host syncs, want {probes} (probe) + "
             f"{cfg['num_warmup']} (warmup counts) + 1 (the draws' counts)")
    if k1 != 1 + probes + sum(counts):
        fail(f"{label}: {k1} K1 launches, want 1 (init) + {probes} (probe) + {sum(counts)} "
             "(the leapfrogs)")
    if not bool((steps == steps[:1]).all()) or steps[0].tolist() != list(counts[cfg["num_warmup"]:]):
        fail(f"{label}: the chains' leapfrog counts differ within a draw, or from those read")
    if not (math.isfinite(traj) and traj > eps):
        fail(f"{label}: final trajectory length {traj} is not finite or not above the step "
             f"size {eps}")
    check_accept(label, accept, "chees")
    ess = posterior_checks(label, cfg, data, res.samples["beta"], nuts_mean, nuts_se)
    out[label].update(min_ess=ess, min_ess_per_second=ess / wall, accept=accept,
                      host_syncs=res.host_syncs, replays=res.graph_replays, trajectory_length=traj)
    log(f"{label}: min-ESS {ess:.1f}, {ess / wall:.1f} per wall second")
    del res, steps

    # MALA through sample(): one K1 per transition, no host read in it.
    label = "glm100_fused MALA"
    res, accept, k1, wall = drive_path(label, lambda: sample(None, init, kernel="mala", **run_kw))
    probes = res.probe_evals
    if k1 != transitions + 1 + probes:
        fail(f"{label}: {k1} K1 launches, want {transitions} + 1 (init) + {probes} (probe)")
    if res.host_syncs != probes or probes < 1:
        fail(f"{label}: {res.host_syncs} host syncs, want {probes} (the probe's)")
    if res.graph_replays != transitions - 1:
        fail(f"{label}: {res.graph_replays} graph replays, want {transitions - 1}")
    check_accept(label, accept, "mala")
    ess = posterior_checks(label, cfg, data, res.samples["beta"], nuts_mean, nuts_se)
    out[label].update(min_ess=ess, min_ess_per_second=ess / wall, accept=accept,
                      host_syncs=res.host_syncs, replays=res.graph_replays)
    log(f"{label}: min-ESS {ess:.1f}, {ess / wall:.1f} per wall second")

    # The same with draw_chunk=500: three continuations, each evaluating
    # its start once more and replaying the first run's graphs; every draw
    # and info field the unchunked run's.
    label = "glm100_fused MALA draw_chunk"
    chunk = 500
    chunked, _, k1, _ = drive_path(label, lambda: sample(None, init, kernel="mala",
                                                         draw_chunk=chunk, **run_kw))
    continuations = -(-draws // chunk) - 1
    probes = chunked.probe_evals
    if k1 != transitions + 1 + probes + continuations:
        fail(f"{label}: {k1} K1 launches, want {transitions} + 1 (init) + "
             f"{probes} (probe) + {continuations} (continuations)")
    if chunked.host_syncs != probes or probes < 1:
        fail(f"{label}: {chunked.host_syncs} host syncs, want {probes} (the probe's)")
    if chunked.graph_replays != transitions:
        fail(f"{label}: {chunked.graph_replays} graph replays, want {transitions} (the unchunked "
             "run's runner and graphs serve every chunk: no capture)")
    if not np.array_equal(chunked.samples["beta"], res.samples["beta"].float().cpu().numpy()):
        fail(f"{label}: the draws differ from the unchunked run's")
    for field, a, b in zip(type(res.info)._fields, chunked.info, res.info):
        if not np.array_equal(a, b.cpu().numpy()):
            fail(f"{label}: info {field} differs from the unchunked run's")
    out[label].update(host_syncs=chunked.host_syncs, replays=chunked.graph_replays)
    log(f"{label}: {continuations} continuations, draws and every info field bit-identical to "
        "the unchunked run's")
    return out


def counted(fn) -> tuple:
    """``(fn(), wall s, K1, K3 and Philox launches, graphs captured)``, the
    launch counts set to 0 just before and read just after. Philox's are
    its step draws (``"philox"``) and its raw words (``"philox_words"``:
    the tempered swap, ensemble walker and SMC resampling uniforms)."""
    from mlx_mcmc_tpu_torch.bench import launch_counts, reset_launch_counts
    from mlx_mcmc_tpu_torch.inference import graphs
    from mlx_mcmc_tpu_torch.ops.random import words_cuda

    reset_launch_counts()
    words_cuda.launches = 0
    captures = graphs.capture.count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launch_counts()
    return (out, wall, {"K1": n["glm_fused_logistic"], "K3": n["poisson_fused"],
                        "philox": n["philox_step_draws"], "philox_words": words_cuda.launches},
            graphs.capture.count - captures)


def capture_warm_up_launches() -> int:
    """K1 or K3 launches of a NUTS graph capture's eager warm-up: a root
    and ``graphs.PAIRS_PER_REPLAY`` pair iterations of two leapfrogs."""
    from mlx_mcmc_tpu_torch.inference import graphs

    return 1 + 2 * graphs.PAIRS_PER_REPLAY


@contextlib.contextmanager
def timed_call(module, name: str, out: dict):
    """While open, ``module.name`` is wrapped: each call records in ``out``
    its wall (``"wall"``, the card synchronized on both sides), the K1, K3
    and Philox launches it made and its result (``"out"``)."""
    from mlx_mcmc_tpu_torch.bench import launch_counts

    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
        after = launch_counts()
        for key, kernel in (("K1", "glm_fused_logistic"), ("K3", "poisson_fused"),
                            ("philox", "philox_step_draws")):
            out[key] = after[kernel] - before[kernel]
        out["out"] = result
        return result

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def same_run(label: str, got, want, draws: slice) -> None:
    """``got``'s draws and every info field equal ``want``'s over
    ``draws``, bit for bit."""
    a, b = got.samples["beta"], want.samples["beta"][:, draws]
    if a.dtype != b.dtype or not torch.equal(a, b):
        fail(f"{label}: the draws differ from phase 4's")
    for field, x, y in zip(type(want.info)._fields, got.info, want.info):
        if not torch.equal(x, y[:, draws]):
            fail(f"{label}: info {field} differs from phase 4's")


def checkpoint_phase(cfg, init, data, vag, main, main_k1: int, main_philox: int) -> dict:
    """Phase 4e: checkpoints at glm100_fused's full width through K1 (see
    the module docstring). ``main`` is phase 4's result, ``main_k1`` and
    ``main_philox`` its launches. Returns each path's launches."""
    import os
    import tempfile

    from mlx_mcmc_tpu_torch import sample
    from mlx_mcmc_tpu_torch.io import (load_checkpoint, resume, resume_warmup, run_warmup,
                                       save_checkpoint)

    warmup, draws, half = cfg["num_warmup"], cfg["num_samples"], cfg["num_samples"] // 2
    run_kw = dict(num_chains=cfg["num_chains"], kernel="nuts", seed=1, data=data,
                  max_tree_depth=cfg["max_tree_depth"], target_accept=cfg["target_accept"],
                  store_dtype=cfg["store_dtype"], value_and_grad_fn=vag)
    out = {}

    def disk(label, obj, tmp):
        path = os.path.join(tmp, f"{label}.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, obj)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_checkpoint(path)
        load_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        log(f"glm100_fused {label} checkpoint: save {save_s:.4f} s, load {load_s:.4f} s, "
            f"{nbytes} bytes ({loaded['positions']['beta'].nbytes} of positions)")
        return loaded, {"save_seconds": save_s, "load_seconds": load_s, "bytes": nbytes}

    def check_counts(label, launched, captures, first, rest):
        """Over a path's two segments, on phase 4's runner and graphs."""
        warm_up = capture_warm_up_launches()
        k1 = sum(n["K1"] for n in launched)
        philox = sum(n["philox"] for n in launched)
        syncs = first[0] + rest.host_syncs
        log(f"{label}: K1 {k1} (phase 4: {main_k1}), Philox {philox} (phase 4: {main_philox}), "
            f"host syncs {first[0]} + {rest.host_syncs} (phase 4: {main.host_syncs}), probe "
            f"evaluations {first[1]} + {rest.probe_evals}, graphs the segments captured "
            f"{captures}")
        if k1 != main_k1 + 1 - warm_up:
            fail(f"{label}: {k1} K1 launches, want phase 4's {main_k1} + 1 (the continuation "
                 f"evaluates its start) - {warm_up} (phase 4's capture warm-up)")
        if philox != main_philox:
            fail(f"{label}: {philox} Philox launches, want phase 4's {main_philox}")
        if syncs != main.host_syncs or rest.probe_evals != 0 or first[1] != main.probe_evals:
            fail(f"{label}: host syncs {syncs}, probe evaluations {first[1]} + "
                 f"{rest.probe_evals}; want phase 4's {main.host_syncs} and {main.probe_evals} + 0")
        if captures != 0:
            fail(f"{label}: the segments captured {captures} graphs, want 0 (phase 4's replay)")

    with tempfile.TemporaryDirectory() as tmp:
        # mid-warmup: run_warmup to step 150, the disk, resume_warmup
        label = "glm100_fused mid-warmup"
        ckpt, w1, n1, cap1 = counted(lambda: run_warmup(None, init, num_warmup=warmup, stop=150,
                                                        **run_kw))
        loaded, io_stats = disk("warmup", ckpt, tmp)
        res, w2, n2, cap = counted(lambda: resume_warmup(None, loaded, num_samples=draws,
                                                          data=data, value_and_grad_fn=vag))
        log(f"{label}: run_warmup [0, 150) {w1:.2f} s, resume_warmup [150, {warmup}) and "
            f"{draws} draws {w2:.2f} s")
        same_run(label, res, main, slice(None))
        for name, x, y in zip(("step_size", "inv_mass_diag"), res.tunables, main.tunables):
            if not torch.equal(x, y):
                fail(f"{label}: tunables {name} differ from phase 4's")
        check_counts(label, (n1, n2), cap1 + cap, (ckpt["host_syncs"], ckpt["probe_evals"]), res)
        log(f"{label}: draws, every info field and the tunables bit-identical to phase 4's")
        out[label] = dict(io_stats, K1=n1["K1"] + n2["K1"], philox=n1["philox"] + n2["philox"],
                          wall_seconds=[w1, w2])
        del res, ckpt, loaded

        # mid-sampling: sample() at 300 + 1000, the disk, resume 1000 more;
        # then again from the live result
        label = "glm100_fused mid-sampling"
        first, w3, n3, cap3 = counted(lambda: sample(None, init, num_warmup=warmup,
                                                     num_samples=half, **run_kw))
        same_run(f"{label} (the first {half})", first, main, slice(0, half))
        loaded, io_stats = disk("sampling", first, tmp)
        rest, w4, n4, cap = counted(lambda: resume(None, loaded, num_samples=draws - half,
                                                   data=data, value_and_grad_fn=vag))
        same_run(f"{label} (resumed)", rest, main, slice(half, None))
        check_counts(label, (n3, n4), cap3 + cap, (first.host_syncs, first.probe_evals), rest)
        live, w5, n5, cap = counted(lambda: resume(None, first, num_samples=draws - half,
                                                   data=data, value_and_grad_fn=vag))
        same_run(f"{label} (resumed from the live result)", live, main, slice(half, None))
        if cap != 0 or n5 != n4:
            fail(f"{label}: the second resume captured {cap} graphs and launched {n5}, want 0 "
                 f"and the first resume's {n4}")
        log(f"{label}: sample {warmup} + {half} {w3:.2f} s, resume {draws - half} {w4:.2f} s, "
            f"again from the live result {w5:.2f} s (K1 {n5['K1']}, no graph captured); draws "
            "and every info field bit-identical to phase 4's")
        out[label] = dict(io_stats, K1=n3["K1"] + n4["K1"], philox=n3["philox"] + n4["philox"],
                          wall_seconds=[w3, w4, w5])
        out[f"{label}, live resume"] = {"K1": n5["K1"], "philox": n5["philox"]}
    return out


def advi_phase(g_problem, p_problem, pcfg, spec_truth) -> dict:
    """Phase 7c: ``fit_advi`` at glm100's full width and
    ``sample(init_strategy='advi')`` at poisson1000_cov's bench settings
    through K3 (see the module docstring). Returns the paths' launches."""
    from mlx_mcmc_tpu_torch import fit_advi, sample
    from mlx_mcmc_tpu_torch.inference import api

    out = {}
    g_log_prob, g_init, g_data, _ = g_problem
    laplace = laplace_fit(plain_data(g_data))
    for method, lr in (("meanfield", 0.05), ("fullrank", ADVI_FULLRANK_LR)):
        label = f"glm100 ADVI {method}"
        q, wall, n, _ = counted(lambda: fit_advi(g_log_prob, g_init, method=method,
                                                 num_steps=1000, seed=1, data=g_data,
                                                 learning_rate=lr))
        sd = torch.exp(q.log_sigma)
        gap, lo, hi = advi_gap(q.mu, sd, *laplace)
        max_gap, (sd_lo, sd_hi) = ADVI_BAND[method]
        log(f"{label} (1000 steps, 8 draws a step, learning rate {lr}): wall {wall:.2f} s, ELBO "
            f"{q.elbo:.3f}, Philox launches {n['philox']}; vs Laplace: max |mu - MAP| / sd "
            f"{gap:.4f} (band {max_gap}), sd ratio in [{lo:.4f}, {hi:.4f}] (band [{sd_lo}, "
            f"{sd_hi}])")
        if not (bool(torch.isfinite(q.mu).all()) and bool(torch.isfinite(sd).all())):
            fail(f"{label}: q's mean or sd is not finite")
        if gap > max_gap or not (sd_lo <= lo and hi <= sd_hi):
            fail(f"{label}: q is outside the band that the CPU rehearsal of both packages set")
        out[label] = {"wall_seconds": wall, "philox": n["philox"], "gap": gap,
                      "sd_ratio": [lo, hi]}

    # init_strategy='advi' at poisson1000_cov: the model's fused vag (K3)
    # drives the fit and the transitions; the fit is timed inside the run
    log_prob, init, data, extra = p_problem
    c = pcfg["num_chains"]
    label = "poisson1000_cov advi"
    fit = {}
    with timed_call(api, "advi_initialize", fit):
        res, wall, n, cap = counted(lambda: sample(
            log_prob, init, data=data, num_samples=pcfg["num_samples"],
            num_warmup=pcfg["num_warmup"], num_chains=c, kernel="nuts", seed=1,
            max_tree_depth=pcfg["max_tree_depth"], target_accept=pcfg["target_accept"],
            store_dtype=pcfg["store_dtype"], init_strategy="advi", **extra))
    starts, inv_mass = fit["out"]
    fit_steps = 500
    if fit["K3"] != fit_steps + 1 or fit["philox"] != fit_steps + 1:
        fail(f"{label}: the fit launched K3 {fit['K3']} and Philox {fit['philox']} times, want "
             f"{fit_steps} + 1 each (a step's 8 draws; the starts)")
    if not bool(torch.isfinite(starts).all()):
        fail(f"{label}: non-finite starts")
    transitions = pcfg["num_warmup"] + pcfg["num_samples"]
    probes, syncs = res.probe_evals, res.host_syncs
    # the fit's, init, the probe's, each transition's root and two per pair
    # iteration (one host read each after the root's), and the capture's
    # eager warm-up where the run captured its graphs
    warm_up = capture_warm_up_launches() if cap else 0
    want_k3 = fit["K3"] + 1 + probes + 2 * (syncs - probes) - transitions + warm_up
    want_philox = fit["philox"] + 1 + transitions
    accept = res.acceptance_rate
    depth = float(res.info.tree_depth.float().mean())
    log(f"{label}: the fit {fit['wall']:.2f} s (500 steps; K3 {fit['K3']}, Philox "
        f"{fit['philox']}), the run with its fit {wall:.2f} s; K3 {n['K3']} (want {want_k3}), "
        f"Philox {n['philox']} (want {want_philox}: the fit's, the probe's draw, {transitions} "
        f"transitions), graphs captured {cap}, host syncs {syncs}, graph replays "
        f"{res.graph_replays}; accept "
        f"{accept:.4f}, depth {depth:.3f}, divergences {res.divergences}; q's variances in "
        f"[{float(inv_mass.min()):.3e}, {float(inv_mass.max()):.3e}]")
    if n["K3"] != want_k3 or n["philox"] != want_philox:
        fail(f"{label}: K3 {n['K3']} or Philox {n['philox']} launches, want {want_k3} and "
             f"{want_philox}")
    for k, v in res.samples.items():
        if v.shape[:2] != (c, pcfg["num_samples"]) or not bool(torch.isfinite(v).all()):
            fail(f"{label} draws {k}: shape {tuple(v.shape)} or non-finite")
    check_sampler(label, {"launches": {"poisson_fused": n["K3"]}, "mean_accept": accept,
                          "mean_tree_depth": depth,
                          "divergence_rate": res.divergences / (c * pcfg["num_samples"])},
                  0.9, 7, ["poisson_fused"])
    poisson_truth_checks(label, res.samples, spec_truth)
    out[label] = {"K3": n["K3"], "philox": n["philox"], "wall_seconds": wall,
                  "fit_wall_seconds": fit["wall"], "fit_K3": fit["K3"], "host_syncs": syncs,
                  "accept": accept}
    return out


def readme_exact(y: torch.Tensor) -> dict:
    """Posterior means of the README model's mu and sigma by quadrature on
    a 1601 x 1601 grid around the MAP, in float64 on the card: the model's
    own priors and the normal likelihood of ``y``."""
    y = y.double()
    n, ybar = y.numel(), float(y.mean())
    ss = float(((y - ybar) ** 2).sum())
    s_hat = math.sqrt(ss / n)
    u = torch.linspace(-12, 12, 1601, dtype=torch.float64, device="cuda")
    M = (ybar + u * s_hat / math.sqrt(n))[:, None]
    S = (s_hat * (1 + u / math.sqrt(2 * n)))[None, :]
    lp = -M ** 2 / 200 - S ** 2 / 50 - n * torch.log(S) - (ss + n * (ybar - M) ** 2) / (2 * S ** 2)
    w = torch.exp(lp - lp.max())
    return {"mu": float((w * M).sum() / w.sum()), "sigma": float((w * S).sum() / w.sum())}


def readme_phase() -> dict:
    """Phase 9: the README quick start on the card (see the module
    docstring). Returns each run's Philox launches."""
    from mlx_mcmc_tpu_torch import MCMC, HalfNormal, Normal
    from mlx_mcmc_tpu_torch.bench import launch_counts, reset_launch_counts

    y = np.random.default_rng(0).normal(3.0, 1.5, 1000).astype(np.float32)
    data = torch.from_numpy(y).cuda()

    def log_prob(params):
        mu, sigma = params["mu"], params["sigma"]
        return (Normal(0, 10).log_prob(mu)
                + HalfNormal(5).log_prob(sigma)
                + torch.sum(Normal(mu, sigma).log_prob(data)))

    exact = readme_exact(data)
    log(f"README model: 1000 draws of N(3, 1.5) from numpy's seed 0; posterior means by "
        f"quadrature (float64): mu {exact['mu']:.5f}, sigma {exact['sigma']:.5f}")
    philox = {}
    runs = (("nuts", {}), ("hmc", {}), ("metropolis", {}),
            ("hmc", {"transforms": {"sigma": "log"}}))
    for method, kw in runs:
        label = f"README {method}" + (" with sigma sampled as its log" if kw else "")
        mcmc = MCMC(log_prob)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcmc.run({"mu": 0.0, "sigma": 1.0}, num_samples=1000, num_warmup=1000, method=method,
                 num_chains=8, verbose=False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = mcmc.result
        philox[label] = launch_counts()["philox_step_draws"]
        log(f"{label}: wall {wall:.2f} s, host syncs {res.host_syncs}, graph replays "
            f"{res.graph_replays} (the model declares no graph_safe: eager), Philox launches "
            f"{philox[label]}, acceptance {res.acceptance_rate:.4f}, divergences "
            f"{res.divergences}")
        mcmc.print_summary()
        if philox[label] == 0:
            fail(f"{label}: no Philox launch")
        diag = mcmc.diagnostics()
        for k in ("mu", "sigma"):
            draws = res.samples[k]
            if tuple(draws.shape) != (8, 1000) or not bool(torch.isfinite(draws).all()):
                fail(f"{label}: {k} draws {tuple(draws.shape)} or non-finite")
            mean, mcse, _ = mean_mcse(draws)
            log(f"  {k}: mean {mean:.5f} +- {mcse:.5f} (MCSE), exact {exact[k]:.5f}, "
                f"R-hat {diag[k]['r_hat']:.4f}")
            if abs(mean - exact[k]) > 4 * mcse:
                fail(f"{label}: {k} mean {mean} is more than 4 MCSE from {exact[k]}")
            if not diag[k]["r_hat"] < 1.05:
                fail(f"{label}: {k} R-hat {diag[k]['r_hat']} >= 1.05")
        if not bool((res.samples["sigma"] > 0).all()):
            fail(f"{label}: a sigma draw is not positive")
    return philox


ROOFLINE_FIELDS = ("total_leapfrogs", "flop_count", "achieved_tflops", "mfu_pct",
                   "arithmetic_intensity", "roofline_bound_tflops", "roofline_frac_pct",
                   "peak_tflops", "hbm_gbs", "lockstep_tax", "executed_mfu_pct",
                   "wasted_leapfrog_pct")
# Phase 4g: collect_warmup's run, warmup + draws, and trace_to's.
COLLECT_SETTINGS, TRACE_SETTINGS = (50, 50), (5, 5)


def measurement_phase(cfg, init, data, vag, metrics, main_k1: int, main_probe: int,
                      stats_draws: np.ndarray) -> dict:
    """Phase 4g: the measurement layer at glm100_fused's full width through
    K1 (see the module docstring). ``metrics`` are phase 4's, ``main_k1``
    and ``main_probe`` its K1 launches and probe evaluations,
    ``stats_draws`` a float64 slice of its draws. Returns each path's
    launches."""
    import glob
    import os
    import tempfile

    from mlx_mcmc_tpu_torch.bench import lockstep_leaves
    from mlx_mcmc_tpu_torch.diagnostics.stats import (effective_sample_size,
                                                      potential_scale_reduction)
    from mlx_mcmc_tpu_torch.inference.engine import build_sampler
    from mlx_mcmc_tpu_torch.ops.ravel import ravel_params
    from mlx_mcmc_tpu_torch.utils import gradient_evals, trace_to

    chains, dim = cfg["num_chains"], cfg["num_features"]
    # (a) phase 4's roofline block
    roof = metrics["roofline"]
    log("glm100_fused roofline: " + json.dumps(roof))
    missing = [f for f in ROOFLINE_FIELDS if f not in roof]
    if missing:
        fail(f"roofline block lacks {missing}")
    if not (0 < roof["mfu_pct"] <= 100 and roof["roofline_frac_pct"] <= 105
            and roof["lockstep_tax"] >= 1):
        fail("roofline block out of range: mfu_pct in (0, 100], roofline_frac_pct <= 105, "
             "lockstep_tax >= 1")
    # every chain runs each K1 launch but the initial evaluation, the probe's
    # and the capture's eager warm-up (which also runs every chain)
    executed = (main_k1 - 1 - main_probe) * chains
    estimate = roof["total_leapfrogs"] * roof["lockstep_tax"]
    log(f"glm100_fused roofline cross-check: total_leapfrogs x lockstep_tax = {estimate:.0f}, "
        f"K1's chain-leapfrogs (K1 - 1 - {main_probe} probe) x {chains} = {executed}, "
        f"ratio {estimate / executed:.4f}")
    if abs(estimate / executed - 1.0) > 0.10:
        fail("roofline block: leapfrogs disagree with phase 4's K1 launches by more than 10%")

    # (b) collect_warmup against the same run without collecting
    warmup, draws = COLLECT_SETTINGS
    z0 = ravel_params(init, device=data["Xp"].device)[0].expand(chains, dim).contiguous()
    runs = {}
    for collect in (False, True):
        sampler = build_sampler(None, dim, kernel="nuts", num_warmup=warmup, num_samples=draws,
                                target_accept=cfg["target_accept"],
                                max_tree_depth=cfg["max_tree_depth"],
                                store_dtype=getattr(torch, cfg["store_dtype"]),
                                value_and_grad_fn=vag, collect_warmup=collect)
        runs[collect] = counted(lambda: sampler(1, z0, data))
    (plain, _, plain_n, plain_cap), ((res, (w_pos, w_info)), wall, n, cap) = runs[False], runs[True]
    if not torch.equal(plain.positions, res.positions):
        fail("collect_warmup: the draws differ from the run without collecting")
    for field, x, y in zip(type(plain.info)._fields, plain.info, res.info):
        if not torch.equal(x, y):
            fail(f"collect_warmup: info {field} differs from the run without collecting")
    for field, x, y in zip(plain.final_tunables._fields, plain.final_tunables, res.final_tunables):
        if not torch.equal(torch.as_tensor(x), torch.as_tensor(y)):
            fail(f"collect_warmup: tunables {field} differ")
    if (n["K1"], n["philox"], res.host_syncs) != (plain_n["K1"], plain_n["philox"],
                                                  plain.host_syncs):
        fail(f"collect_warmup: K1 {n['K1']}, Philox {n['philox']}, host syncs "
             f"{res.host_syncs}; without collecting {plain_n['K1']}, {plain_n['philox']}, "
             f"{plain.host_syncs}")
    if tuple(w_pos.shape) != (warmup, chains, dim) or w_pos.dtype != torch.float32:
        fail(f"collect_warmup: positions {w_pos.dtype} {tuple(w_pos.shape)}, want float32 "
             f"{(warmup, chains, dim)}")
    if any(tuple(x.shape[:2]) != (warmup, chains) for x in w_info):
        fail("collect_warmup: infos not stacked as (warmup steps, chains)")
    w_steps = w_info.num_integration_steps.T  # (C, W)
    exec_w = int(lockstep_leaves(w_steps).sum())
    exec_s = int(lockstep_leaves(res.info.num_integration_steps).sum())
    implied = n["K1"] - 1 - res.probe_evals - (capture_warm_up_launches() if cap else 0)
    log(f"collect_warmup {warmup} + {draws} at {chains} chains: wall {wall:.2f} s (without "
        f"{runs[False][1]:.2f}), "
        f"K1 {n['K1']}, Philox {n['philox']}, host syncs {res.host_syncs}, captures {cap}; "
        f"warmup leapfrogs {gradient_evals(w_info)} useful, {exec_w} executed a chain; "
        f"sampling {exec_s}; K1 implies {implied}")
    if exec_w + exec_s != implied:
        fail(f"collect_warmup: executed leapfrogs {exec_w} + {exec_s} != the {implied} K1 "
             "launches imply")
    del plain, res, w_pos, w_info, runs

    # (c) the native R-hat and ESS against the numpy path
    times = {}
    for native in (True, False):
        t0 = time.perf_counter()
        times[native] = (effective_sample_size(stats_draws, use_native=native),
                         potential_scale_reduction(stats_draws, use_native=native))
        times[native] += (time.perf_counter() - t0,)
    (ess_n, rhat_n, t_n), (ess_p, rhat_p, t_p) = times[True], times[False]
    ess_err = float(np.max(np.abs(ess_n / ess_p - 1.0)))
    rhat_err = float(np.max(np.abs(rhat_n / rhat_p - 1.0)))
    log(f"native R-hat/ESS on {stats_draws.shape} float64: {t_n:.3f} s, numpy {t_p:.3f} s; "
        f"ESS rel err {ess_err:.2e}, R-hat {rhat_err:.2e}; min ESS {ess_n.min():.1f}")
    if not (ess_err <= 1e-6 and rhat_err <= 1e-8):
        fail("native R-hat/ESS disagree with numpy's (ESS rtol 1e-6, R-hat 1e-8)")

    # (d) trace_to around a short run through K1
    collect_label = f"glm100_fused collect_warmup ({warmup} + {draws})"
    warmup, draws = TRACE_SETTINGS
    sampler = build_sampler(None, dim, kernel="nuts", num_warmup=warmup, num_samples=draws,
                            target_accept=cfg["target_accept"],
                            max_tree_depth=cfg["max_tree_depth"], value_and_grad_fn=vag)
    with tempfile.TemporaryDirectory() as log_dir:
        with trace_to(log_dir):
            _, t_wall, t_n, _ = counted(lambda: sampler(1, z0, data))
        files = glob.glob(os.path.join(log_dir, "*.json"))
        if len(files) != 1:
            fail(f"trace_to wrote {files}, want one trace")
        with open(files[0]) as f:
            text = f.read()
    log(f"trace_to around {warmup} + {draws}: {len(text)} bytes, K1 {t_n['K1']}, "
        f"wall {t_wall:.2f} s")
    if "glm_onepass_kernel" not in text:
        fail("trace_to's trace names no glm_onepass_kernel")
    return {collect_label: n, f"glm100_fused trace_to ({warmup} + {draws})": t_n}


# Phase 4h (c): the fixed-tunables comparison's warmup + draws; (d): the
# facade's sharded route's.
SHARDED_FIXED, SHARDED_FACADE = (50, 200), (100, 100)


def sharded_metrics(res, launched: dict, wall: float) -> dict:
    """What ``check_sampler`` reads of a glm100_fused run, as
    ``bench.run_config`` gives it for phase 4."""
    draws = res.num_chains * res.num_samples
    return {"wall_seconds": wall, "launches": launched, "mean_accept": res.acceptance_rate,
            "mean_tree_depth": float(res.info.tree_depth.float().mean()),
            "divergences": res.divergences, "divergence_rate": res.divergences / draws,
            "host_syncs": res.host_syncs, "graph_replays": res.graph_replays}


def sharded_phase(cfg, init, data, vag, metrics, main_rhat: float, main_tunables: tuple,
                  nuts_mean, nuts_se) -> dict:
    """Phase 4h: ``sample_sharded`` at glm100_fused's full width through K1
    on a world of one (see the module docstring). ``metrics`` are phase
    4's, ``main_rhat`` its draws' max R-hat, ``main_tunables`` its adapted
    step size and metric. Returns each path's launches."""
    import torch.distributed as dist

    from mlx_mcmc_tpu_torch import MCMC, sample
    from mlx_mcmc_tpu_torch.bench import launch_counts, reset_launch_counts
    from mlx_mcmc_tpu_torch.diagnostics.device import device_ess_chunked, device_rhat
    from mlx_mcmc_tpu_torch.parallel import initialize_distributed, sample_sharded

    # (a) a world of one on nccl; its first collective builds the communicator
    initialize_distributed()
    if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
        fail(f"initialize_distributed(): backend {dist.get_backend()}, world "
             f"{dist.get_world_size()}; want nccl, 1")
    one = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(one)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    log(f"process group: nccl, world 1, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}; "
        f"first all_reduce (builds the communicator) {first_ms:.1f} ms")
    if float(one) != 1.0:
        fail(f"all_reduce over a world of one gave {float(one)}")
    settings = dict(data=data, value_and_grad_fn=vag, num_chains=cfg["num_chains"],
                    kernel="nuts", seed=1, max_tree_depth=cfg["max_tree_depth"],
                    target_accept=cfg["target_accept"], store_dtype=cfg["store_dtype"])
    paths = {}

    # (b) the full-width path, with the device diagnostics
    res, wall, n, _ = counted(lambda: sample_sharded(
        None, init, num_warmup=cfg["num_warmup"], num_samples=cfg["num_samples"],
        device_diagnostics=True, **settings))
    label = "glm100_fused sharded (world of one)"
    paths[label] = n
    launched = {"glm_fused_logistic": n["K1"], "philox_step_draws": n["philox"]}
    check_sampler(label, sharded_metrics(res, launched, wall), cfg["target_accept"], 5,
                  ["glm_fused_logistic", "philox_step_draws"])
    beta = res.samples["beta"]
    min_ess = posterior_checks(label, cfg, data, beta, nuts_mean, nuts_se)
    rhat, ess = res.device_stats["r_hat"], res.device_stats["n_eff"]
    one_rhat, one_ess = device_rhat(beta.float()), device_ess_chunked(beta)
    rhat_err = float(((rhat - one_rhat).abs() / one_rhat).max())
    ess_err = float(((ess - one_ess).abs() / one_ess).max())
    col = res.collectives
    log(f"{label}: wall {wall:.2f} s (phase 4: {metrics['wall_seconds']:.2f} s), K1 {n['K1']}, "
        f"Philox {n['philox']}, host syncs {res.host_syncs}, graph replays "
        f"{res.graph_replays}, probe evaluations {res.probe_evals}; accept "
        f"{res.acceptance_rate:.4f}, depth {float(res.info.tree_depth.float().mean()):.3f}, "
        f"divergences {res.divergences}; device_stats max R-hat {float(rhat.max()):.5f} (phase "
        f"4: {main_rhat:.5f}), min ESS {float(ess.min()):.1f} (phase 4: "
        f"{metrics['min_ess']:.1f}; host-side min-ESS of these draws {min_ess:.1f}); against "
        f"the single-device statistics of the same draws: R-hat rel err {rhat_err:.2e}, ESS "
        f"{ess_err:.2e}; collectives " + json.dumps(col))
    if not (rhat_err <= 1e-6 and ess_err <= 1e-6):
        fail(f"{label}: device_stats differ from the single-device R-hat/ESS beyond 1e-6")
    want = cfg["num_warmup"] + res.probe_evals  # one mean a step and a probe evaluation
    if col["adaptation"]["count"] < want or col["gather"]["count"] == 0:
        fail(f"{label}: collectives {col}; want at least {want} in the adaptation and a gather")
    paths[label] = dict(n, wall_seconds=wall, host_syncs=res.host_syncs,
                        collectives=col, first_collective_ms=first_ms)
    del res, beta, one_rhat, one_ess

    # (c) fixed tunables: sample()'s bits and launches
    warmup, draws = SHARDED_FIXED
    eps, inv_mass = main_tunables
    fixed = dict(settings, num_warmup=warmup, num_samples=draws, step_size=eps,
                 adapt_step_size=False, adapt_mass_matrix=False, init_inv_mass_diag=inv_mass)
    got, s_wall, s_n, _ = counted(lambda: sample_sharded(None, init, **fixed))
    want_res, p_wall, p_n, _ = counted(lambda: sample(None, init, **fixed))
    if not torch.equal(got.samples["beta"], want_res.samples["beta"]):
        fail("sharded fixed tunables: the draws differ from sample()'s")
    for field, x, y in zip(type(want_res.info)._fields, got.info, want_res.info):
        if x.dtype != y.dtype or not torch.equal(x, y):
            fail(f"sharded fixed tunables: info {field} differs from sample()'s")
    log(f"glm100_fused sharded fixed tunables ({warmup} + {draws}, step size {eps:.5f}): draws "
        f"and every info field bit-identical to sample()'s; K1 {s_n['K1']} (sample(): "
        f"{p_n['K1']}), Philox {s_n['philox']} ({p_n['philox']}), wall {s_wall:.2f} s "
        f"({p_wall:.2f} s), collectives " + json.dumps(got.collectives))
    if (s_n["K1"], s_n["philox"]) != (p_n["K1"], p_n["philox"]) or s_n["K1"] == 0:
        fail("sharded fixed tunables: K1 or Philox launches differ from sample()'s")
    paths[f"glm100_fused sharded fixed tunables ({warmup} + {draws})"] = s_n
    paths[f"glm100_fused sample() fixed tunables ({warmup} + {draws})"] = p_n
    del got, want_res

    # (d) the facade's sharded route
    warmup, draws = SHARDED_FACADE
    mcmc = MCMC(None)
    _, f_wall, f_n, _ = counted(lambda: mcmc.run(
        init, method="nuts", num_chains=cfg["num_chains"], num_warmup=warmup,
        num_samples=draws, chain_method="sharded", value_and_grad_fn=vag, data=data,
        max_tree_depth=cfg["max_tree_depth"], target_accept=cfg["target_accept"],
        store_dtype=cfg["store_dtype"], verbose=False))
    flat = mcmc.samples["beta"]
    log(f"glm100_fused sharded (facade, {warmup} + {draws}): wall {f_wall:.2f} s (the facade's "
        f"numpy copy included), K1 {f_n['K1']}, Philox {f_n['philox']}, accept "
        f"{mcmc.acceptance_rate:.4f}")
    if f_n["K1"] == 0 or f_n["philox"] == 0:
        fail("the facade's sharded route launched K1 or Philox no time")
    if flat.shape != (cfg["num_chains"] * draws, cfg["num_features"]) \
            or not np.isfinite(flat).all():
        fail(f"the facade's sharded route: draws {flat.shape} or non-finite")
    paths[f"glm100_fused sharded (facade, {warmup} + {draws})"] = f_n
    del mcmc, flat

    # (e)
    dist.destroy_process_group()
    return paths


# Phase 4i (a): NUTS on a data mesh of one, warmup + draws; (b): the sharded
# checkpoints' run (warmup, draws before the cut, draws after it) and
# run_warmup's stop.
DATA_AXIS_RUN = (300, 500)
SHARDED_CKPT = (100, 200, 200)
SHARDED_WARMUP_STOP = 50


def data_axis_phase(cfg, init, data, vag, nuts_mean, nuts_se) -> dict:
    """Phase 4i: observation sharding and sharded checkpoints at
    glm100_fused's full width through K1, on a world of one (see the module
    docstring). ``vag`` is phase 4's fused value+grad. Returns each path's
    launches."""
    import os
    import tempfile

    import torch.distributed as dist

    from mlx_mcmc_tpu_torch.benchmarks.collective_overhead import unit_normal_prior
    from mlx_mcmc_tpu_torch.io import (load_checkpoint, resume, resume_warmup, run_warmup,
                                       save_checkpoint)
    from mlx_mcmc_tpu_torch.ops.glm import (fused_data_specs, make_fused_logistic_vag,
                                            prepare_fused_logistic_data)
    from mlx_mcmc_tpu_torch.parallel import (chain_mesh, data_chain_mesh, initialize_distributed,
                                             sample_sharded)

    initialize_distributed()
    if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
        fail(f"initialize_distributed(): backend {dist.get_backend()}, world "
             f"{dist.get_world_size()}; want nccl, 1")
    paths = {}
    d, depth = data["dim"], cfg["max_tree_depth"]
    one = prepare_fused_logistic_data(data["Xp"][:, :d], data["yp"], num_shards=1)
    if not (torch.equal(one["Xp"], data["Xp"]) and torch.equal(one["yp"], data["yp"])):
        fail("prepare_fused_logistic_data(num_shards=1) differs from phase 4's data")

    # (a) NUTS forced to its static schedule on data_chain_mesh(1, 1)
    warmup, draws = DATA_AXIS_RUN
    label = "glm100_fused data axis (a data mesh of one)"
    res, wall, n, captures = counted(lambda: sample_sharded(
        None, init, mesh=data_chain_mesh(1, 1), data=one, data_axis="data",
        data_specs=fused_data_specs(one, "data"), log_prior_fn=unit_normal_prior,
        value_and_grad_fn=make_fused_logistic_vag(include_prior=False),
        num_chains=cfg["num_chains"], num_warmup=warmup, num_samples=draws, kernel="nuts", seed=1,
        max_tree_depth=depth, target_accept=cfg["target_accept"], store_dtype=cfg["store_dtype"]))
    launched = {"glm_fused_logistic": n["K1"], "philox_step_draws": n["philox"]}
    check_sampler(label, sharded_metrics(res, launched, wall), cfg["target_accept"], 5,
                  ["glm_fused_logistic", "philox_step_draws"])
    min_ess = posterior_checks(label, dict(cfg, num_samples=draws), data, res.samples["beta"],
                               nuts_mean, nuts_se)
    transitions, leaves = warmup + draws, 2 ** depth - 1
    # init, the probe, every transition's fixed-trip tree (the root leaf and
    # 2^(depth-1) - 1 pair iterations of two), and the capture's eager warm-up
    want_k1 = 1 + res.probe_evals + leaves * transitions + leaves
    sums = res.collectives["data"]["count"]
    log(f"{label}: wall {wall:.2f} s, K1 {n['K1']} (predicted 1 + {res.probe_evals} + {leaves} x "
        f"{transitions} + {leaves} = {want_k1}), Philox {n['philox']}, data-axis sums {sums}, "
        f"host syncs {res.host_syncs} (the probe's {res.probe_evals}), graph replays "
        f"{res.graph_replays}, graphs captured {captures}; accept {res.acceptance_rate:.4f}, "
        f"depth {float(res.info.tree_depth.float().mean()):.3f}, divergences {res.divergences}, "
        f"min-ESS {min_ess:.1f}; collectives " + json.dumps(res.collectives))
    if n["K1"] != want_k1:
        fail(f"{label}: {n['K1']} K1 launches, want {want_k1}")
    if sums != want_k1:
        fail(f"{label}: {sums} data-axis sums, want one a value+grad ({want_k1})")
    if n["philox"] != transitions + 1:
        fail(f"{label}: {n['philox']} Philox launches, want a step's and the probe's "
             f"({transitions + 1})")
    if res.host_syncs != res.probe_evals or res.graph_replays != 3 * transitions \
            or captures != 3:
        fail(f"{label}: host syncs {res.host_syncs}, replays {res.graph_replays}, captures "
             f"{captures}; want the probe's {res.probe_evals}, 3 a transition "
             f"({3 * transitions}) and root, pairs and result once")
    paths[label] = dict(n, wall_seconds=wall, data_sums=sums, host_syncs=res.host_syncs)
    del res

    # (b) sharded checkpoints on chain_mesh(): a cut run, the disk, resume;
    # run_warmup, resume_warmup; against the uninterrupted run, on its graphs
    warmup, first, rest = SHARDED_CKPT
    mesh = chain_mesh()
    kw = dict(data=data, value_and_grad_fn=vag, num_chains=cfg["num_chains"], kernel="nuts",
              seed=1, max_tree_depth=depth, target_accept=cfg["target_accept"],
              store_dtype=cfg["store_dtype"], num_warmup=warmup)
    label = "glm100_fused sharded checkpoints"
    full, w0, n0, cap0 = counted(lambda: sample_sharded(None, init, mesh=mesh,
                                                        num_samples=first + rest, **kw))
    half, w1, n1, cap1 = counted(lambda: sample_sharded(None, init, mesh=mesh, num_samples=first,
                                                        **kw))
    same_run(f"{label} (the first {first})", half, full, slice(0, first))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded.npz")
        save_checkpoint(path, half)
        loaded = load_checkpoint(path)
    cont, w2, n2, cap2 = counted(lambda: resume(None, loaded, num_samples=rest, data=data,
                                                value_and_grad_fn=vag, mesh=mesh))
    same_run(f"{label} (resumed)", cont, full, slice(first, None))
    wck, w3, n3, cap3 = counted(lambda: run_warmup(None, init, stop=SHARDED_WARMUP_STOP,
                                                   mesh=mesh, **kw))
    wres, w4, n4, cap4 = counted(lambda: resume_warmup(None, wck, num_samples=first + rest,
                                                       data=data, value_and_grad_fn=vag,
                                                       mesh=mesh))
    same_run(f"{label} (run_warmup, resume_warmup)", wres, full, slice(None))
    try:
        resume(None, loaded, num_samples=rest, data=one, value_and_grad_fn=vag,
               mesh=data_chain_mesh(1, 1), data_axis="data", log_prior_fn=unit_normal_prior)
        refused = None
    except ValueError as err:
        refused = str(err)
    if refused is None or "mesh layout differs" not in refused:
        fail(f"{label}: a chain_mesh() checkpoint on data_chain_mesh(1, 1) with a data axis: "
             f"{refused or 'resumed'}; want the layout refused")
    log(f"{label}: sample_sharded {warmup} + {first + rest} {w0:.2f} s (K1 {n0['K1']}, "
        f"{cap0} graphs captured); {warmup} + {first} {w1:.2f} s (K1 {n1['K1']}), the disk, "
        f"resume {rest} {w2:.2f} s (K1 {n2['K1']}); run_warmup [0, {SHARDED_WARMUP_STOP}) "
        f"{w3:.2f} s (K1 {n3['K1']}), resume_warmup {w4:.2f} s (K1 {n4['K1']}); draws and every "
        f"info field bit-identical to the uninterrupted run's; graphs the continuations "
        f"captured {cap1 + cap2 + cap3 + cap4}; another layout refused: {refused[:100]}")
    if cap1 + cap2 + cap3 + cap4 != 0:
        fail(f"{label}: the continuations captured {cap1 + cap2 + cap3 + cap4} graphs, want 0")
    paths[f"{label}: sample_sharded ({warmup} + {first + rest})"] = n0
    paths[f"{label}: sample_sharded ({warmup} + {first}), then resume ({rest})"] = {
        k: n1[k] + n2[k] for k in ("K1", "philox")}
    paths[f"{label}: run_warmup, resume_warmup"] = {k: n3[k] + n4[k] for k in ("K1", "philox")}
    dist.destroy_process_group()
    return paths


@contextlib.contextmanager
def k1_rows(seen: list):
    """While open, every call of K1's dispatcher records the rows of its
    Z in ``seen``: each eager launch and each captured one (a replay
    repeats a captured launch at its capture's shape)."""
    from mlx_mcmc_tpu_torch.ops import glm

    fn = glm.fused_logistic_value_and_grad

    def wrapper(Xp, y, Z, XpT=None):
        seen.append(int(Z.shape[0]))
        return fn(Xp, y, Z, XpT)

    glm.fused_logistic_value_and_grad = wrapper
    try:
        yield
    finally:
        glm.fused_logistic_value_and_grad = fn


def tempered_run(label: str, kernel: str, cfg, init, data, vag, **settings) -> tuple:
    """One ``sample_tempered`` run at glm100_fused's data through K1 with
    the reference bench's value path as ``log_prob``, the launch counts
    set to 0 just before and read just after. Returns ``(result, record)``:
    wall, host syncs, graph replays, captures, K1 and Philox launches, the
    rows of every K1 launch."""
    from mlx_mcmc_tpu_torch import sample_tempered
    from mlx_mcmc_tpu_torch.bench import fused_glm_value_log_prob
    from mlx_mcmc_tpu_torch.inference import graphs

    rows = []
    kw = dict(num_chains=TEMPER_CHAINS, num_replicas=TEMPER_RUNGS, beta_min=0.1, kernel=kernel,
              seed=1, target_accept=0.8 if kernel != "mala" else None, data=data,
              value_and_grad_fn=vag)
    kw.update(settings)
    with k1_rows(rows):
        res, wall, n, captured = counted(lambda: sample_tempered(fused_glm_value_log_prob,
                                                                 init, **kw))
    record = {"wall_seconds": wall, "host_syncs": res.host_syncs,
              "graph_replays": res.graph_replays, "graphs_captured": captured, "K1": n["K1"],
              "philox": n["philox"], "philox_words": n["philox_words"],
              "k1_rows": sorted(set(rows)),
              "swap_acceptance": [float(x) for x in res.swap_acceptance],
              "rung_step_sizes": [float(x) for x in res.replica_step_sizes]}
    log(f"{label}: wall {wall:.2f} s, host syncs {res.host_syncs}, graph replays "
        f"{res.graph_replays}, graphs captured {captured}, K1 launches {n['K1']} (rows "
        f"{record['k1_rows']}), Philox step-draw launches {n['philox']}, raw-word launches "
        f"{n['philox_words']}; swap acceptance per boundary {record['swap_acceptance']}; rung step "
        f"sizes {record['rung_step_sizes']}")
    rows_want = TEMPER_CHAINS * TEMPER_RUNGS if kw["num_chains"] == TEMPER_CHAINS else None
    if rows_want is not None and record["k1_rows"] != [rows_want]:
        fail(f"{label}: K1 launched at rows {record['k1_rows']}, want every launch at "
             f"{rows_want}")
    return res, record


def tempered_checks(label: str, res, record, transitions: int, target: tuple, data,
                    rungs: bool = False) -> float:
    """A glm100_fused tempered run's cold-rung statistics, its swap
    acceptance, its Philox launches (one step draw and one raw-word launch
    per transition) and the Laplace check; with ``rungs``, the rungs' step
    sizes too. Returns the cold draws' mean accept."""
    beta = res.samples["beta"]
    want = (TEMPER_CHAINS, res.num_samples, 100)
    if tuple(beta.shape) != want or not bool(torch.isfinite(beta).all()):
        fail(f"{label}: cold draws {tuple(beta.shape)} or non-finite, want {want}")
    accept = float(res.info.accept_prob.float().mean())
    lo, hi = target
    log(f"{label}: cold mean accept {accept:.4f} (band [{lo}, {hi}]), divergences "
        f"{res.divergences}, mean tree depth {float(res.info.tree_depth.float().mean()):.3f}")
    if not lo <= accept <= hi:
        fail(f"{label}: cold mean accept {accept} outside [{lo}, {hi}]")
    if res.divergences > 0.01 * beta.shape[0] * beta.shape[1]:
        fail(f"{label}: {res.divergences} divergences")
    swap = res.swap_acceptance
    if not (np.isfinite(swap).all() and (swap >= 0).all() and (swap <= 1).all()):
        fail(f"{label}: swap acceptance {swap} not finite in [0, 1]")
    eps = res.replica_step_sizes
    if rungs and not (np.isfinite(eps).all() and (eps > 0).all() and eps[-1] > eps[0]):
        fail(f"{label}: rung step sizes {eps} not finite and positive with the hottest above "
             f"the cold one")
    if record["philox"] != transitions or record["philox_words"] != transitions:
        fail(f"{label}: Philox launches {record['philox']} step draws and "
             f"{record['philox_words']} raw words, want {transitions} each (one a transition)")
    z_gap, sd_lo, sd_hi = laplace_check(data, beta)
    log(f"{label} vs Laplace: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail(f"{label}: posterior moments disagree with the Laplace approximation")
    return accept


def tempered_full_width(cfg, init, data, vag, nuts_mean, nuts_se) -> dict:
    """Phase 4f: parallel tempering at glm100_fused's full width through K1
    (see the module docstring). Returns each path's launches and figures."""
    from mlx_mcmc_tpu_torch import sample_tempered
    from mlx_mcmc_tpu_torch.bench import _device_busy, fused_glm_value_log_prob

    paths = {}
    warmup, draws = TEMPER_SETTINGS
    transitions = warmup + draws
    res, rec = tempered_run("glm100_fused tempered NUTS", "nuts", cfg, init, data, vag,
                            num_warmup=warmup, num_samples=draws, max_tree_depth=6)
    # K1: init, each transition's root and two per pair iteration (one host
    # read after the root and one after each pairs replay), and the
    # capture's eager warm-up
    pairs = rec["host_syncs"] - transitions
    want = 1 + transitions + 2 * pairs + capture_warm_up_launches()
    if rec["K1"] != want:
        fail(f"glm100_fused tempered NUTS: {rec['K1']} K1 launches, want 1 (init) + "
             f"{transitions} (roots) + 2 x {pairs} (pair iterations) + "
             f"{capture_warm_up_launches()} (the capture's warm-up) = {want}")
    accept = tempered_checks("glm100_fused tempered NUTS", res, rec, transitions,
                             (0.75, 0.85), data, rungs=True)
    mean, se, ess = param_mean_mcse(res.samples["beta"])
    z = (mean - nuts_mean).abs() / torch.hypot(se, nuts_se)
    log(f"glm100_fused tempered NUTS vs NUTS (the main path): max |mean gap| / combined MCSE "
        f"= {float(z.max()):.3f} over {z.numel()} parameters; cold min-ESS "
        f"{float(ess.min()):.1f}")
    if float(z.max()) > 4:
        fail("glm100_fused tempered NUTS: posterior means disagree with NUTS's beyond 4 "
             "combined MCSEs")
    # the final cold state against one fresh K1 evaluation at its positions
    final = res.final_state
    ll, g = vag(final.position, data)
    ll_err = float((final.log_prob - ll).abs().max())
    g_err = float((final.grad - g).abs().max())
    g_max = float(g.abs().max())
    log(f"glm100_fused tempered NUTS final cold state vs a fresh K1 evaluation: max |ll| error "
        f"{ll_err:.3e} nats, max |g| error {g_err:.3e} (max |g| {g_max:.3e})")
    if ll_err > LL_TOL_NATS + LL_TOL_REL * float(ll.abs().max()) \
            or g_err > G_TOL_REL * g_max + G_TOL_ABS:
        fail("glm100_fused tempered NUTS: the final state's log_prob or grad disagrees with "
             "a fresh K1 evaluation")
    paths["glm100_fused tempered nuts"] = dict(rec, mean_accept=accept,
                                               min_ess=float(ess.min()))
    del res
    # layout: chains 0-3 of a 4-chain run equal the 512-chain run's
    fixed = dict(num_warmup=0, num_samples=3, max_tree_depth=6, adapt_step_size=False,
                 adapt_mass_matrix=False, step_size=0.02)
    small = sample_tempered(fused_glm_value_log_prob, init, num_chains=4,
                            num_replicas=TEMPER_RUNGS, kernel="nuts", seed=1, data=data,
                            value_and_grad_fn=vag, **fixed)
    full = sample_tempered(fused_glm_value_log_prob, init, num_chains=TEMPER_CHAINS,
                           num_replicas=TEMPER_RUNGS, kernel="nuts", seed=1, data=data,
                           value_and_grad_fn=vag, **fixed)
    if small.graph_replays == 0 or full.graph_replays == 0:
        fail("glm100_fused tempered layout: a run replayed no graph")
    if not torch.equal(small.samples["beta"], full.samples["beta"][:4]):
        fail("glm100_fused tempered layout: chains 0-3 of 4 and of 512 chains differ")
    for field, a, b in zip(type(small.info)._fields, small.info, full.info):
        if not torch.equal(a, b[:4]):
            fail(f"glm100_fused tempered layout: info {field} differs between 4 and 512 chains")
    log("glm100_fused tempered NUTS layout: chains 0-3 of 4 and of 512 chains (3 transitions "
        "through graphs, fixed tunables) bit for bit")
    del small, full
    # the device's busy share over a 20 + 20 tempered run
    busy = _device_busy(lambda: sample_tempered(
        fused_glm_value_log_prob, init, num_chains=TEMPER_CHAINS, num_replicas=TEMPER_RUNGS,
        kernel="nuts", seed=1, num_warmup=20, num_samples=20, max_tree_depth=6,
        target_accept=0.8, data=data, value_and_grad_fn=vag))
    log("glm100_fused tempered NUTS under the profiler (20 + 20): " + json.dumps(busy))
    paths["glm100_fused tempered nuts"]["busy_20_20"] = busy
    # HMC and MALA under tempering, cut
    for kernel, band in (("hmc", (0.75, 0.85)), ("mala", ACCEPT_BAND["mala"])):
        label = f"glm100_fused tempered {kernel.upper()} (100 + 100)"
        res, rec = tempered_run(label, kernel, cfg, init, data, vag, num_warmup=100,
                                num_samples=100)
        steps = 10 if kernel == "hmc" else 1
        want = 1 + 200 * steps
        if rec["K1"] != want or rec["host_syncs"] != 0 or rec["graph_replays"] != 199:
            fail(f"{label}: K1 {rec['K1']} (want 1 + 200 x {steps} = {want}), host syncs "
                 f"{rec['host_syncs']} (want 0), replays {rec['graph_replays']} (want 199)")
        accept = tempered_checks(label, res, rec, 200, band, data)
        paths[f"glm100_fused tempered {kernel}"] = dict(rec, mean_accept=accept)
        # the same call again runs on the cached runner: its graphs, its bits
        again, rec2 = tempered_run(label + ", again", kernel, cfg, init, data, vag,
                                   num_warmup=100, num_samples=100)
        if rec2["graphs_captured"] != 0 or rec2["K1"] != want \
                or not torch.equal(again.samples["beta"], res.samples["beta"]):
            fail(f"{label}: a second call captured {rec2['graphs_captured']} graphs, launched "
                 f"K1 {rec2['K1']} times (want 0 and {want}) or gave other draws")
        del res, again
    return paths


def _bimodal(params):
    # tests/test_tempered.py:14-22: an equal mixture of N(-4, 1) and N(4, 1)
    x = params["x"]
    from mlx_mcmc_tpu_torch import Normal

    la = Normal(-4.0, 1.0).log_prob(x)
    lb = Normal(4.0, 1.0).log_prob(x)
    return torch.sum(torch.logsumexp(torch.stack([la, lb]), dim=0) - math.log(2.0))


_bimodal.graph_safe = True  # no host read, no host data: graphs may capture it


def _gauss_model(loc, scale):
    from mlx_mcmc_tpu_torch import Normal

    def log_prob(params):
        return torch.sum(Normal(loc, scale).log_prob(params["x"]))

    return log_prob


def other_samplers(cfg, init, data, pred_beta) -> dict:
    """Phase 9b: the other samplers of the inference layer on the card (see
    the module docstring). ``pred_beta``: phase 4's draws cut to 64 chains
    x 100 draws, float32. Returns each path's Philox launches and figures."""
    from mlx_mcmc_tpu_torch import MCMC, sample_ensemble, sample_posterior_predictive
    from mlx_mcmc_tpu_torch import sample_smc, sample_tempered
    from mlx_mcmc_tpu_torch.bench import fused_glm_value_log_prob
    from mlx_mcmc_tpu_torch.diagnostics import pointwise_log_likelihood, psis_loo, waic
    from mlx_mcmc_tpu_torch.diagnostics.device import device_ess

    paths = {}
    # tempering on the bimodal target: the cold chain holds both modes
    res, wall, n, _ = counted(lambda: sample_tempered(
        _bimodal, {"x": -4.0 * torch.ones(1)}, num_samples=1200, num_warmup=800,
        num_chains=BIMODAL_CHAINS, num_replicas=8, beta_min=0.02, kernel="nuts", seed=2,
        max_tree_depth=6))
    xs = res.samples["x"].reshape(-1)
    right = float((xs > 0).float().mean())
    log(f"tempered NUTS, bimodal ({BIMODAL_CHAINS} chains x 8 rungs, 800 + 1200): wall "
        f"{wall:.2f} s, host syncs {res.host_syncs}, graph replays {res.graph_replays}, launches {n}; right-mode "
        f"share {right:.4f}, swap acceptance {[round(float(a), 4) for a in res.swap_acceptance]}")
    if not 0.2 < right < 0.8 or res.graph_replays == 0:
        fail(f"tempered bimodal: right-mode share {right} outside (0.2, 0.8), or no graph replay")
    paths["bimodal tempered nuts"] = dict(n, wall_seconds=wall, host_syncs=res.host_syncs,
                                          right_share=right)
    del res, xs
    # ensemble: tests/test_ensemble.py's Gaussian and correlated targets
    res, wall, n, _ = counted(lambda: sample_ensemble(
        _gauss_model(2.0, 1.5), {"x": torch.zeros(3)}, num_walkers=64, num_samples=800,
        num_warmup=500, seed=0))
    d = res.samples["x"].reshape(-1, 3)
    m, s = d.mean(0), d.std(0)
    log(f"ensemble, Gaussian (64 walkers, 500 + 800): wall {wall:.2f} s, launches {n}; means "
        f"{m.tolist()}, sds {s.tolist()}")
    if float((m - 2.0).abs().max()) > 0.15 or float(((s - 1.5).abs() / 1.5).max()) > 0.12:
        fail("ensemble Gaussian: moments off")
    paths["ensemble gaussian"] = dict(n, wall_seconds=wall)
    cov = np.array([[1.0, 0.97], [0.97, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device=data["Xp"].device)

    def corr_lp(params):
        x = params["x"]
        return -0.5 * x @ prec @ x

    res, wall, n, _ = counted(lambda: sample_ensemble(
        corr_lp, {"x": torch.zeros(2)}, num_walkers=64, num_samples=1500, num_warmup=800, seed=1))
    d = res.samples["x"].reshape(-1, 2).cpu().numpy()
    corr = float(np.corrcoef(d.T)[0, 1])
    log(f"ensemble, correlated (64 walkers, 800 + 1500): wall {wall:.2f} s; accept "
        f"{res.acceptance_rate:.4f}, sds {d.std(0).tolist()}, correlation {corr:.4f}")
    if not (0.2 < res.acceptance_rate < 0.8 and np.all(np.abs(d.std(0) - 1.0) < 0.15)
            and corr > 0.9):
        fail("ensemble correlated: acceptance, sds or correlation off")
    paths["ensemble correlated"] = dict(n, wall_seconds=wall)
    mcmc = MCMC(_gauss_model(1.0, 2.0))
    draws, wall, n, _ = counted(lambda: mcmc.run({"x": 0.0}, num_samples=400, num_warmup=300,
                                              method="ensemble", num_chains=32, verbose=False))
    log(f"ensemble through the facade (32 walkers, 300 + 400): wall {wall:.2f} s; mean "
        f"{draws['x'].mean():.4f}, sd {draws['x'].std():.4f}")
    if draws["x"].shape != (32 * 400,) or abs(draws["x"].mean() - 1.0) > 0.25 \
            or abs(draws["x"].std() - 2.0) > 0.35:
        fail("ensemble facade: shape or moments off")
    paths["ensemble facade"] = dict(n, wall_seconds=wall)
    # ensemble at glm100_fused's data, the bench's value path
    res, wall, n, _ = counted(lambda: sample_ensemble(
        fused_glm_value_log_prob, init, num_walkers=ENSEMBLE_WALKERS, num_warmup=300,
        num_samples=2000, seed=1, data=data))
    beta = res.samples["beta"]
    accept = float(res.info.accept_prob.mean())
    ess = float(device_ess(beta).min())
    lo, hi = ENSEMBLE_ACCEPT_BAND
    log(f"ensemble at glm100_fused ({ENSEMBLE_WALKERS} walkers, 300 + 2000, plain bf16 value "
        f"path): wall {wall:.2f} s, launches {n}; mean accept {accept:.4f} (band [{lo}, {hi}]), "
        f"accepted share {res.acceptance_rate:.4f}, min-ESS {ess:.1f} "
        f"({ess / wall:.1f}/s)")
    if not lo <= accept <= hi or not bool(torch.isfinite(beta).all()):
        fail(f"ensemble glm100_fused: mean accept {accept} outside [{lo}, {hi}] or non-finite "
             "draws")
    if n["philox_words"] != 2300 or n["philox"] != 1:
        fail(f"ensemble glm100_fused: launches {n}, want 1 Philox step draw (the starts) and "
             "2300 raw-word launches (one a step)")
    paths["ensemble glm100_fused"] = dict(n, wall_seconds=wall, mean_accept=accept, min_ess=ess)
    del res, beta
    # SMC: tests/test_smc.py's three targets
    res, wall, n, _ = counted(lambda: sample_smc(_gauss_model(2.0, 1.5), {"x": torch.zeros(2)},
                                            num_particles=SMC_PARTICLES, seed=0, q0_scale=3.0))
    pts = res.particles["x"]
    m, s = pts.mean(0), pts.std(0)
    log(f"SMC, Gaussian ({SMC_PARTICLES} particles): wall {wall:.2f} s, stages "
        f"{res.num_stages}, host reads {res.host_syncs}, launches {n}; means {m.tolist()}, sds "
        f"{s.tolist()}, log Z {res.log_evidence:.4f}, accept {res.final_accept_rate:.4f}")
    if float((m - 2.0).abs().max()) > 0.15 or float(((s - 1.5).abs() / 1.5).max()) > 0.15 \
            or abs(res.log_evidence) > 0.25 or not 1 <= res.num_stages < 100 \
            or res.final_accept_rate <= 0.05:
        fail("SMC Gaussian: moments, evidence, stages or acceptance off")
    paths["smc gaussian"] = dict(n, wall_seconds=wall, stages=res.num_stages,
                                 host_syncs=res.host_syncs)

    def unnorm(params):
        return -0.5 * torch.sum(params["x"] ** 2) / 4.0

    res, wall, n, _ = counted(lambda: sample_smc(unnorm, {"x": 0.0}, num_particles=SMC_PARTICLES,
                                            seed=1, q0_scale=4.0))
    true_log_z = 0.5 * (math.log(2 * math.pi) + 2 * math.log(2.0))
    log(f"SMC, unnormalized ({SMC_PARTICLES} particles): wall {wall:.2f} s, stages "
        f"{res.num_stages}, host reads {res.host_syncs}; log Z {res.log_evidence:.4f} (true "
        f"{true_log_z:.4f})")
    if abs(res.log_evidence - true_log_z) > 0.2:
        fail("SMC unnormalized: evidence off")
    paths["smc unnormalized"] = dict(n, wall_seconds=wall, stages=res.num_stages,
                                     host_syncs=res.host_syncs)
    from mlx_mcmc_tpu_torch import Normal

    def mixture(params):
        x = params["x"]
        la = math.log(0.3) + Normal(-4.0, 0.5).log_prob(x)
        lb = math.log(0.7) + Normal(4.0, 0.5).log_prob(x)
        return torch.logaddexp(la, lb)

    res, wall, n, _ = counted(lambda: sample_smc(mixture, {"x": 0.0}, num_particles=SMC_PARTICLES,
                                            seed=0, q0_scale=6.0))
    right = float((res.particles["x"] > 0).float().mean())
    log(f"SMC, bimodal ({SMC_PARTICLES} particles): wall {wall:.2f} s, stages "
        f"{res.num_stages}, host reads {res.host_syncs}; right-mode mass {right:.4f}, log Z "
        f"{res.log_evidence:.4f}")
    if abs(right - 0.7) > 0.1 or abs(res.log_evidence) > 0.3:
        fail("SMC bimodal: mode mass or evidence off")
    paths["smc bimodal"] = dict(n, wall_seconds=wall, stages=res.num_stages,
                                host_syncs=res.host_syncs)
    # the posterior predictive of phase 4's draws over the 10K rows
    d = data["dim"]
    X = data["Xp"][:, :d].float()
    y_mean = float(data["yp"].float().mean())

    def predictive(g, p):
        return torch.bernoulli(torch.sigmoid(X @ p["beta"]), generator=g)

    samples = {"beta": pred_beta}
    pp, wall, _, _ = counted(lambda: sample_posterior_predictive(predictive, samples, seed=3))
    two = sample_posterior_predictive(predictive, {"beta": pred_beta[:2]}, seed=3)
    rate = float(pp.mean())
    log(f"posterior predictive ({tuple(pp.shape)}, one torch.Generator a chain on "
        f"{pp.device}): wall {wall:.2f} s; mean predicted rate {rate:.5f}, y's mean "
        f"{y_mean:.5f}")
    if tuple(pp.shape) != (64, 100, 10000) or abs(rate - y_mean) > 0.01:
        fail("posterior predictive: shape or mean rate off")
    if not torch.equal(two, pp[:2]):
        fail("posterior predictive: chains 0-1 differ between 2 and 64 chains")
    paths["predictive"] = {"wall_seconds": wall}
    # model comparison on the same draws

    def log_lik(p):
        s = X @ p["beta"]
        return data["yp"] * s - torch.logaddexp(s, torch.zeros_like(s))

    t0 = time.perf_counter()
    ll = pointwise_log_likelihood(log_lik, samples)
    w, lo_ = waic(ll), psis_loo(ll)
    wall = time.perf_counter() - t0
    k_share = float((lo_["pareto_k"] > 0.7).mean())
    log(f"model comparison ({ll.shape}): wall {wall:.2f} s; elpd_waic {w['elpd_waic']:.3f} "
        f"(se {w['se']:.3f}, p_waic {w['p_waic']:.3f}), elpd_loo {lo_['elpd_loo']:.3f} (se "
        f"{lo_['se']:.3f}, p_loo {lo_['p_loo']:.3f}), share of k > 0.7 {k_share:.5f}")
    if not (np.isfinite([w["elpd_waic"], lo_["elpd_loo"], w["se"], lo_["se"]]).all()
            and abs(w["elpd_waic"] - lo_["elpd_loo"]) < 2 * max(w["se"], lo_["se"])):
        fail("model comparison: WAIC or PSIS-LOO not finite, or they disagree")
    paths["model comparison"] = {"wall_seconds": wall, "p_waic": w["p_waic"],
                                 "p_loo": lo_["p_loo"], "k_share_above_0.7": k_share}
    return paths


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # --- build -----------------------------------------------------------
    from mlx_mcmc_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build(["glm_fused", "poisson_fused", "philox", "glm_variants"], verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'up to date'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Performance", "warning", "Compiling")):
                log(f"  ptxas {name}: {line.strip()}")

    from mlx_mcmc_tpu_torch.bench import CONFIGS, FUNNEL_DETAIL, build_problem
    from mlx_mcmc_tpu_torch.models import make_poisson_event_rates
    from mlx_mcmc_tpu_torch.ops.glm import (
        fused_hoisted_vag_cuda,
        fused_linear_vag_cuda,
        fused_logistic_vag_cuda,
        prepare_fused_linear_data,
        prepare_fused_logistic_data,
    )
    from mlx_mcmc_tpu_torch.ops.poisson import fused_poisson_vag_cuda, prepare_fused_poisson_data

    # --- kernels against their plain versions -----------------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg = CONFIGS["glm100_fused"]
    lin_cfg = dict(cfg, family="linear", label="linear regression")
    pcfg = CONFIGS["poisson1000_cov"]
    t0 = time.perf_counter()
    problem = build_problem(cfg)
    log(f"glm100_fused data (the reference's threefry streams): {time.perf_counter() - t0:.2f} s")
    data = problem[2]
    d = data["dim"]
    # unit-scale positions, as the main path's posterior gives (|s| ~ 1)
    z_main = torch.randn(cfg["num_chains"], d, generator=gen, device="cuda")
    rows = {"K1": check_glm("logistic", "main", data["Xp"], data["yp"], z_main, timed=True)}
    rows["K1"]["device_breakdown_ms"] = device_breakdown_ms(
        lambda: fused_logistic_vag_cuda(data["Xp"], data["yp"], z_main),
        ("round_z", "glm_onepass", "sum_splits"))
    rows["K1"]["products_library_ms"] = products_yardstick_ms(data["Xp"], z_main, chain_tile=128)
    glm_bits_check("K1 one-pass", data["Xp"], data["yp"], z_main)
    n_r, d_r, c_r = 777, 37, 1000
    x_r = (torch.randn(n_r, d_r, generator=gen, device="cuda") / math.sqrt(d_r)).bfloat16()
    y_r = (torch.rand(n_r, generator=gen, device="cuda") < 0.5).float()
    z_r = torch.randn(c_r, d_r, generator=gen, device="cuda")
    ragged = prepare_fused_logistic_data(x_r, y_r)
    check_glm("logistic", "ragged", ragged["Xp"], y_r, z_r, timed=False)

    lin_problem = build_problem(lin_cfg)
    lin_data = lin_problem[2]
    rows["K2"] = check_glm("linear", "main", lin_data["Xp"], lin_data["yp"], z_main, timed=True)
    rows["K2"]["products_library_ms"] = products_yardstick_ms(lin_data["Xp"], z_main,
                                                              chain_tile=128)
    bits_check("K2 one-pass", lambda z: fused_linear_vag_cuda(lin_data["Xp"], lin_data["yp"], z),
               z_main)
    y_lin = (x_r.float() @ torch.randn(d_r, generator=gen, device="cuda")
             + torch.randn(n_r, generator=gen, device="cuda"))
    check_glm("linear", "ragged", ragged["Xp"], y_lin, z_r, timed=False)

    # K1 on int8 X (the reference's quantize="int8", the scales folded into
    # Z) through the one-pass kernel and its widening stage, at glm100's
    # shape and at the ragged one (N = 777: the last stage's tail rows).
    q100 = prepare_fused_logistic_data(data["Xp"][:, :d], data["yp"], quantize="int8")
    z_q = z_main * q100["col_scale"]
    rows["K1_int8"] = check_glm("logistic", "int8 main", q100["Xp"], q100["yp"], z_q, timed=True)
    rows["K1_int8"]["device_breakdown_ms"] = device_breakdown_ms(
        lambda: fused_logistic_vag_cuda(q100["Xp"], q100["yp"], z_q),
        ("round_z", "glm_onepass", "sum_splits"))
    rows["K1_int8"]["products_library_ms"] = products_yardstick_ms(
        q100["Xp"].to(torch.bfloat16), z_q, chain_tile=128)
    glm_bits_check("K1 int8 one-pass", q100["Xp"], q100["yp"], z_q)
    del q100, z_q
    rq_narrow = prepare_fused_logistic_data(x_r, y_r, quantize="int8")
    check_glm("logistic", "int8 ragged", rq_narrow["Xp"], y_r, z_r * rq_narrow["col_scale"],
              timed=False)

    # K1 on the wide path (Dp = 1008) at glm1000_fused's shape, bf16 and
    # int8 (the scales folded into Z); K1, K2 and K4 at a ragged wide shape.
    wcfg = CONFIGS["glm1000_fused"]
    t0 = time.perf_counter()
    w_problem = build_problem(wcfg)
    w_data_seconds = time.perf_counter() - t0
    log(f"glm1000_fused data (the reference's threefry streams, 1e8 normals): "
        f"{w_data_seconds:.2f} s")
    w_data = w_problem[2]
    z_w = torch.randn(wcfg["num_chains"], w_data["dim"], generator=gen, device="cuda")
    variants = {key: {} for key in ("K1", "K1_wide", "K1_int8_wide", "K1_f32", "K2", "K2_f32", "K4",
                                    "K4_f32")}
    wide = check_glm("logistic", "wide glm1000", w_data["Xp"], w_data["yp"], z_w, timed=True,
                     ll_rel=LL_TOL_REL, g_rel=WIDE_G_TOL_REL)
    wide["device_breakdown_ms"] = device_breakdown_ms(
        lambda: fused_logistic_vag_cuda(w_data["Xp"], w_data["yp"], z_w),
        ("round_z", "glm_hopper_value", "glm_hopper_grad", "sum_splits"))
    wide["products_library_ms"] = products_yardstick_ms(w_data["Xp"], z_w)
    log(f"  design floor {wide_design_floor_ms(*w_data['Xp'].shape, z_w.shape[0]):.4f} ms "
        "(bytes of the two-kernel design)")
    glm_bits_check("K1 wide", w_data["Xp"], w_data["yp"], z_w)
    wide["data_seconds"] = w_data_seconds
    rows["K1_wide"] = wide
    # int8 X through the same pair and its widening stage; its yardstick is
    # the two products on the widened bf16 X. Its launches are this phase's.
    fused_logistic_vag_cuda.launches = 0
    q_data = prepare_fused_logistic_data(w_data["Xp"][:, :w_data["dim"]], w_data["yp"], quantize="int8")
    z_wq = z_w * q_data["col_scale"]
    rows["K1_int8_wide"] = check_glm("logistic", "int8 glm1000", q_data["Xp"], q_data["yp"], z_wq,
                                     timed=True, ll_rel=LL_TOL_REL, g_rel=WIDE_G_TOL_REL)
    rows["K1_int8_wide"]["device_breakdown_ms"] = device_breakdown_ms(
        lambda: fused_logistic_vag_cuda(q_data["Xp"], q_data["yp"], z_wq),
        ("round_z", "glm_hopper_value", "glm_hopper_grad", "sum_splits"))
    rows["K1_int8_wide"]["products_library_ms"] = products_yardstick_ms(
        q_data["Xp"].to(torch.bfloat16), z_wq)
    glm_bits_check("K1 int8 wide", q_data["Xp"], q_data["yp"], z_wq)
    int8_wide_launches = fused_logistic_vag_cuda.launches
    del q_data, z_wq
    x_wf = w_data["Xp"][:, :w_data["dim"]].float()
    y_wl = x_wf @ torch.randn(w_data["dim"], generator=gen, device="cuda") + torch.randn(
        x_wf.shape[0], generator=gen, device="cuda")
    del x_wf
    variants["K2"]["wide_glm1000"] = check_glm("linear", "wide glm1000", w_data["Xp"], y_wl, z_w,
                                               timed=True, g_rel=WIDE_G_TOL_REL)
    variants["K2"]["wide_glm1000"]["products_library_ms"] = products_yardstick_ms(w_data["Xp"], z_w)
    del y_wl
    n_w, d_w, c_w = 777, 300, 70
    x_w = (torch.randn(n_w, d_w, generator=gen, device="cuda") / math.sqrt(d_w)).bfloat16()
    y_w = (torch.rand(n_w, generator=gen, device="cuda") < 0.5).float()
    z_rw = torch.randn(c_w, d_w, generator=gen, device="cuda")
    rw = prepare_fused_logistic_data(x_w, y_w)
    variants["K1_wide"]["wide_ragged"] = check_glm("logistic", "wide ragged", rw["Xp"], y_w, z_rw, timed=False)
    rq = prepare_fused_logistic_data(x_w, y_w, quantize="int8")
    before = fused_logistic_vag_cuda.launches
    variants["K1_int8_wide"]["int8_wide_ragged"] = check_glm(
        "logistic", "int8 wide ragged", rq["Xp"], y_w, z_rw * rq["col_scale"], timed=False)
    int8_wide_launches += fused_logistic_vag_cuda.launches - before
    y_wl = (x_w.float() @ torch.randn(d_w, generator=gen, device="cuda")
            + torch.randn(n_w, generator=gen, device="cuda"))
    variants["K2"]["wide_ragged"] = check_glm(
        "linear", "wide ragged", prepare_fused_linear_data(x_w, y_wl)["Xp"], y_wl, z_rw, timed=False)

    # K4, the hoisted variant (no sampling path): its launches are this
    # phase's.
    fused_hoisted_vag_cuda.launches = 0
    rows["K4"] = check_glm("hoisted", "main", data["Xp"], None, z_main, timed=True)
    rows["K4"].update(hoisted_gap(data, z_main))
    rows["K4"]["products_library_ms"] = rows["K1"]["products_library_ms"]  # K1's two products
    bits_check("K4 one-pass", lambda z: fused_hoisted_vag_cuda(data["Xp"], z), z_main)
    variants["K4"]["wide_ragged"] = check_glm("hoisted", "wide ragged", rw["Xp"], None, z_rw, timed=False)
    variants["K4"]["int8_wide_ragged"] = check_glm(
        "hoisted", "int8 wide ragged", rq["Xp"], None, z_rw * rq["col_scale"], timed=False)
    k4_launches = fused_hoisted_vag_cuda.launches

    # f32 X through the 3xTF32 pair, on the reference's X in float32 (the
    # recipe's draws before their bf16 cast): K1, K2 and K4 at glm100's
    # shape, timed, against float64 too, two calls and C = 4 to the same
    # bits; then at the ragged wide shape; then K1 at glm1000's shape, the
    # same way. Their launches are this block's (K1 at glm100 takes the f32
    # cut run's below).
    counters = (fused_logistic_vag_cuda, fused_linear_vag_cuda, fused_hoisted_vag_cuda)
    before = [k.launches for k in counters]
    t0 = time.perf_counter()
    f32_problem = build_problem(dict(cfg, x_dtype="float32"))
    log_f32 = f32_problem[2]
    lin_f32 = build_problem(dict(lin_cfg, x_dtype="float32"))[2]
    log(f"glm100_fused and linear data with f32 X: {time.perf_counter() - t0:.2f} s")
    f32_calls = {
        "K1_f32": ("logistic", lambda z: fused_logistic_vag_cuda(log_f32["Xp"], log_f32["yp"], z,
                                                                 log_f32["XpT"])),
        "K2_f32": ("linear", lambda z: fused_linear_vag_cuda(lin_f32["Xp"], lin_f32["yp"], z,
                                                             lin_f32["XpT"])),
        "K4_f32": ("hoisted", lambda z: fused_hoisted_vag_cuda(log_f32["Xp"], z, log_f32["XpT"])),
    }
    f32_parts = ("pad_z", "glm_tf32_value", "glm_tf32_grad", "sum_splits")
    for key, (family, call) in f32_calls.items():
        dat = lin_f32 if family == "linear" else log_f32
        rows[key] = check_glm(family, "f32 main", dat["Xp"], None if family == "hoisted" else dat["yp"],
                              z_main, timed=True, float64=True, XpT=dat["XpT"])
        rows[key]["products_library_ms"] = products_yardstick_ms(dat["Xp"], z_main, chain_tile=128)
        rows[key]["device_breakdown_ms"] = device_breakdown_ms(lambda: call(z_main), f32_parts)
        bits_check(f"{key[:2]} f32", call, z_main)
    rwf = prepare_fused_logistic_data(x_w.float(), y_w)
    lwf = prepare_fused_linear_data(x_w.float(), y_wl)
    variants["K1_f32"]["f32_wide_ragged"] = check_glm(
        "logistic", "f32 wide ragged", rwf["Xp"], y_w, z_rw, timed=False, XpT=rwf["XpT"])
    variants["K2_f32"]["f32_wide_ragged"] = check_glm(
        "linear", "f32 wide ragged", lwf["Xp"], y_wl, z_rw, timed=False, XpT=lwf["XpT"])
    variants["K4_f32"]["f32_wide_ragged"] = check_glm(
        "hoisted", "f32 wide ragged", rwf["Xp"], None, z_rw, timed=False, XpT=rwf["XpT"])
    f32_launches = {key: k.launches - b
                    for key, k, b in zip(("K1_f32", "K2_f32", "K4_f32"), counters, before)}
    t0 = time.perf_counter()
    wf_data = build_problem(dict(wcfg, x_dtype="float32"))[2]
    log(f"glm1000_fused data with f32 X: {time.perf_counter() - t0:.2f} s")
    before = fused_logistic_vag_cuda.launches
    rows["K1_f32_wide"] = check_glm("logistic", "f32 glm1000", wf_data["Xp"], wf_data["yp"], z_w,
                                    timed=True, ll_rel=LL_TOL_REL, float64=True,
                                    XpT=wf_data["XpT"])
    rows["K1_f32_wide"]["products_library_ms"] = products_yardstick_ms(wf_data["Xp"], z_w,
                                                                       chain_tile=128)
    rows["K1_f32_wide"]["device_breakdown_ms"] = device_breakdown_ms(
        lambda: fused_logistic_vag_cuda(wf_data["Xp"], wf_data["yp"], z_w, wf_data["XpT"]),
        f32_parts)
    glm_bits_check("K1 f32 glm1000", wf_data["Xp"], wf_data["yp"], z_w, wf_data["XpT"])
    f32_launches["K1_f32_wide"] = fused_logistic_vag_cuda.launches - before
    del wf_data

    p_problem = build_problem(pcfg)
    p_data = p_problem[2]
    spec_truth = make_poisson_event_rates(
        pcfg["num_groups"], pcfg["obs_per_group"], pcfg["covariate_dim"], seed=0
    ).truth
    c_p, g_p = pcfg["num_chains"], pcfg["num_groups"]
    # positions near the generator's truth, as the path's posterior gives
    theta_p = 1.0 + 0.5 * torch.randn(c_p, g_p, generator=gen, device="cuda")
    beta_p = spec_truth["beta"] + 0.05 * torch.randn(c_p, 4, generator=gen, device="cuda")
    rows["K3"] = check_poisson("main", p_data, theta_p, beta_p, timed=True)
    p_args = (p_data["X"], p_data["y"], p_data["shat"], p_data["lamhat"])
    rows["K3"]["device_breakdown_ms"] = device_breakdown_ms(
        lambda: fused_poisson_vag_cuda(*p_args, theta_p, beta_p),
        ("poisson_fused", "sum_splits"))
    bits_check("K3", lambda th, b: fused_poisson_vag_cuda(*p_args, th, b), theta_p, beta_p)
    pr_spec = make_poisson_event_rates(37, 61, 3, seed=5)
    pr_data = prepare_fused_poisson_data(pr_spec.y, pr_spec.X)
    check_poisson("ragged", pr_data, 1.0 + 0.5 * torch.randn(300, 37, generator=gen, device="cuda"),
                  pr_spec.truth["beta"] + 0.05 * torch.randn(300, 3, generator=gen, device="cuda"),
                  timed=False)

    rows["philox"] = check_philox(
        "main", torch.arange(cfg["num_chains"], device="cuda"), d,
        1 << (cfg["max_tree_depth"] - 1), timed=True,
    )
    check_philox("ragged", torch.arange(1000, 1037, device="cuda"), 7, 128, timed=False)
    hcfg = CONFIGS["hier1000"]
    check_philox("hier1000", torch.arange(hcfg["num_chains"], device="cuda"),
                 hcfg["num_groups"] + 2, 1 << (hcfg["max_tree_depth"] - 1), timed=False)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- the variants of K1's body, through the benchmark entry points -----
    variant_kernels = variants_phase()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- CUDA graphs of the transition against the eager loop --------------
    from mlx_mcmc_tpu_torch.inference import graphs
    from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
    from mlx_mcmc_tpu_torch.models import eight_schools
    from mlx_mcmc_tpu_torch.ops.glm import make_fused_linear_vag, make_fused_logistic_vag
    from mlx_mcmc_tpu_torch.ops.poisson import make_fused_poisson_vag
    from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

    log(f"CUDA graphs: {graphs.PAIRS_PER_REPLAY} pair iterations per replay")
    k1_vag, k2_vag, k3_vag = make_fused_logistic_vag(1.0), make_fused_linear_vag(1.0), make_fused_poisson_vag()
    q_glm100 = prepare_fused_logistic_data(data["Xp"][:, :d], data["yp"], quantize="int8")
    depth_main, depth_wide = cfg["max_tree_depth"], wcfg["max_tree_depth"]
    graph_checks = {
        "K1 bf16 glm100": graphs_vs_eager("K1 bf16 glm100", bind(k1_vag, data), d, cfg["num_chains"],
                                          0.02, depth_main, 0.1, static=True),
        "K1 int8 glm100": graphs_vs_eager("K1 int8 glm100", bind(k1_vag, q_glm100), d,
                                          cfg["num_chains"], 0.02, depth_main, 0.1),
        "K1 f32 glm100": graphs_vs_eager("K1 f32 glm100", bind(k1_vag, log_f32), d,
                                         cfg["num_chains"], 0.02, depth_main, 0.1),
        "K1 wide glm1000": graphs_vs_eager("K1 wide glm1000", bind(k1_vag, w_data), w_data["dim"],
                                           wcfg["num_chains"], 0.005, depth_wide, 0.02),
        "K2 glm100": graphs_vs_eager("K2 glm100", bind(k2_vag, lin_data), d, cfg["num_chains"],
                                     0.01, depth_main, 0.1),
        "K3 poisson1000_cov": graphs_vs_eager(
            "K3 poisson1000_cov", bind(k3_vag, p_data), pcfg["covariate_dim"] + 2 + g_p, c_p, 0.002,
            pcfg["max_tree_depth"], 0.1),
    }
    f_spec = eight_schools(centered=True)
    f_flp, _, _ = make_flat_logprob(f_spec.log_prob, f_spec.initial_params, device="cuda")
    graph_checks["generic (funnel)"] = graphs_vs_eager(
        "generic (funnel)", make_batched_value_and_grad(f_flp), 10, 512, 0.05, 10, 0.3)
    # phase 7b's value+grads: the sufficient-statistic vags and the plain
    # GLM's autograd one over f32 X
    h_problem = build_problem(hcfg)
    po_cfg = CONFIGS["poisson1000"]
    po_problem = build_problem(po_cfg)
    g_cfg = CONFIGS["glm100"]
    g_problem = build_problem(g_cfg)
    h_vag = bind(h_problem[3]["value_and_grad_fn"], h_problem[2])
    graph_checks["suffstat hier1000"] = graphs_vs_eager(
        "suffstat hier1000", h_vag, hcfg["num_groups"] + 2, hcfg["num_chains"], 0.005,
        hcfg["max_tree_depth"], 0.1)
    graph_checks["suffstat poisson1000"] = graphs_vs_eager(
        "suffstat poisson1000", bind(po_problem[3]["value_and_grad_fn"], po_problem[2]),
        po_cfg["num_groups"] + 2, po_cfg["num_chains"], 0.002, po_cfg["max_tree_depth"], 0.1)
    g_flp, _, _ = make_flat_logprob(g_problem[0], g_problem[1], data_aware=True, device="cuda")
    graph_checks["generic (glm100 plain)"] = graphs_vs_eager(
        "generic (glm100 plain)", make_batched_value_and_grad(g_flp, g_problem[2]),
        g_cfg["num_features"], g_cfg["num_chains"], 0.02, g_cfg["max_tree_depth"], 0.1)
    for label in ("suffstat hier1000", "suffstat poisson1000", "generic (glm100 plain)"):
        if not graph_checks[label]["captured"]:
            fail(f"graphs vs eager ({label}): the value+grad is not graph_safe")
    del q_glm100
    # --- HMC and Metropolis: one graph per transition against eager --------
    fixed_trip_graphs_vs_eager("HMC, K1 bf16 glm100", "hmc", bind(k1_vag, data), d,
                               cfg["num_chains"], 0.02, 0.1)
    fixed_trip_graphs_vs_eager("Metropolis, K1 bf16 glm100", "metropolis", bind(k1_vag, data), d,
                               cfg["num_chains"], 0.02, 0.1)
    fixed_trip_graphs_vs_eager("MALA, K1 bf16 glm100", "mala", bind(k1_vag, data), d,
                               cfg["num_chains"], 0.02, 0.1)
    chees_graphs_vs_eager("ChEES, K1 bf16 glm100", bind(k1_vag, data), d, cfg["num_chains"],
                          0.02, 0.1)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused: the main path --------------------------------------
    metrics, result = drive("glm100_fused", cfg, problem)
    launches = {"K1": metrics["launches"]["glm_fused_logistic"],
                "philox": metrics["launches"]["philox_step_draws"]}
    beta = result.samples["beta"]
    want = (cfg["num_chains"], cfg["num_samples"], cfg["num_features"])
    if tuple(beta.shape) != want or beta.dtype != torch.bfloat16:
        fail(f"draws have shape {tuple(beta.shape)} {beta.dtype}, want {want} bfloat16")
    if not bool(torch.isfinite(beta).all()):
        fail("non-finite draws")
    check_sampler("glm100_fused", metrics, 0.8, 5, ["glm_fused_logistic", "philox_step_draws"])
    log(f"glm100_fused on the reference's dataset: accept {metrics['mean_accept']:.4f}, depth "
        f"{metrics['mean_tree_depth']:.3f}, divergences {metrics['divergences']}, min-ESS "
        f"{metrics['min_ess']:.0f}; the reference (BENCH_r05.json, TPU v5e): 0.794, 3.0, 0, "
        "14119787")
    z_gap, sd_lo, sd_hi = laplace_check(data, beta)
    log(f"glm100_fused vs Laplace: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail("posterior moments disagree with the Laplace approximation")
    nuts_mean, nuts_se, _ = param_mean_mcse(beta)
    init = problem[1]
    stats_draws = beta[:512, :, :16].double().cpu().numpy()  # phase 4g's native R-hat/ESS
    main_probe = result.probe_evals
    # phase 4h's: the draws' max R-hat, the adapted step size and metric
    from mlx_mcmc_tpu_torch.diagnostics.device import device_rhat

    main_rhat = float(device_rhat(beta.float()).max())
    main_tunables = (float(result.tunables.step_size), result.tunables.inv_mass_diag.clone())
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused: checkpoint and resume, against phase 4's run -------
    ckpt_paths = checkpoint_phase(cfg, init, data, problem[3]["value_and_grad_fn"], result,
                                  launches["K1"], launches["philox"])
    log("glm100_fused checkpoint paths: " + json.dumps(ckpt_paths))
    pred_beta = beta[:64, :100].float().clone()  # phase 9b's posterior predictive
    del result, beta, problem
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused: parallel tempering through K1 -----------------------
    temper_paths = tempered_full_width(cfg, init, data, k1_vag, nuts_mean, nuts_se)
    log("glm100_fused tempered paths: " + json.dumps(temper_paths))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused: the roofline block, collect_warmup, stats, trace_to -
    measure_paths = measurement_phase(cfg, init, data, k1_vag, metrics, launches["K1"],
                                      main_probe, stats_draws)
    del stats_draws
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused: chains over ranks on a world of one ------------------
    shard_paths = sharded_phase(cfg, init, data, k1_vag, metrics, main_rhat, main_tunables,
                                nuts_mean, nuts_se)
    log("glm100_fused sharded paths: " + json.dumps(shard_paths))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused: observations over a data mesh, sharded checkpoints ---
    data_paths = data_axis_phase(cfg, init, data, k1_vag, nuts_mean, nuts_se)
    log("glm100_fused data-axis paths: " + json.dumps(data_paths))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused through HMC and the MCMC facade ----------------------
    hmc_path = hmc_full_width(cfg, init, data, k1_vag, nuts_mean, nuts_se)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused through ChEES (facade), MALA and MALA in chunks ------
    cm_paths = chees_mala_full_width(cfg, init, data, k1_vag, nuts_mean, nuts_se)
    log("glm100_fused ChEES and MALA paths: " + json.dumps(cm_paths))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused on int8 X, cut: the int8 one-pass kernel -------------
    icfg = dict(cfg, quantize="int8", num_warmup=100, num_samples=100)
    i_problem = build_problem(icfg)
    imetrics, iresult = drive("glm100_fused int8 (100 + 100)", icfg, i_problem)
    launches["K1_int8"] = imetrics["launches"]["glm_fused_logistic"]
    beta = iresult.samples["beta"]
    want = (icfg["num_chains"], icfg["num_samples"], icfg["num_features"])
    if tuple(beta.shape) != want or not bool(torch.isfinite(beta).all()):
        fail(f"glm100_fused int8: draws of shape {tuple(beta.shape)} or non-finite, want {want}")
    check_sampler("glm100_fused int8", imetrics, 0.8, 5, ["glm_fused_logistic", "philox_step_draws"])
    z_gap, sd_lo, sd_hi = laplace_check(i_problem[2], beta)
    log(f"glm100_fused int8 vs Laplace on the dequantized X: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail("glm100_fused int8: posterior moments disagree with the Laplace approximation")
    del iresult, beta
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm100_fused on f32 X, cut: the 3xTF32 pair -----------------------
    f32_cfg = dict(cfg, x_dtype="float32", num_warmup=100, num_samples=100)
    f32_metrics, f32_result = drive("glm100_fused f32 (100 + 100)", f32_cfg, f32_problem)
    launches["K1_f32"] = f32_metrics["launches"]["glm_fused_logistic"]
    beta = f32_result.samples["beta"]
    want = (f32_cfg["num_chains"], f32_cfg["num_samples"], f32_cfg["num_features"])
    if tuple(beta.shape) != want or not bool(torch.isfinite(beta).all()):
        fail(f"glm100_fused f32: draws of shape {tuple(beta.shape)} or non-finite, want {want}")
    check_sampler("glm100_fused f32", f32_metrics, 0.8, 5, ["glm_fused_logistic", "philox_step_draws"])
    z_gap, sd_lo, sd_hi = laplace_check(f32_problem[2], beta)
    log(f"glm100_fused f32 vs Laplace on the same f32 X: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail("glm100_fused f32: posterior moments disagree with the Laplace approximation")
    del f32_result, beta
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- glm1000_fused: the wide path --------------------------------------
    wmetrics, wresult = drive("glm1000_fused", wcfg, w_problem)
    launches["K1_wide"] = wmetrics["launches"]["glm_fused_logistic"]
    beta = wresult.samples["beta"]
    want = (wcfg["num_chains"], wcfg["num_samples"], wcfg["num_features"])
    if tuple(beta.shape) != want or beta.dtype != torch.float32:
        fail(f"glm1000_fused draws have shape {tuple(beta.shape)} {beta.dtype}, want {want} float32")
    if not bool(torch.isfinite(beta).all()):
        fail("glm1000_fused: non-finite draws")
    check_sampler("glm1000_fused", wmetrics, 0.8, 7, ["glm_fused_logistic", "philox_step_draws"])
    z_gap, sd_lo, sd_hi = laplace_check(w_data, beta)
    log(f"glm1000_fused vs Laplace: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail("glm1000_fused: posterior moments disagree with the Laplace approximation")
    del wresult, beta, w_problem, w_data
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- funnel detail ----------------------------------------------------
    fcfg = FUNNEL_DETAIL
    fmetrics, fresult = drive("funnel8 detail row", fcfg)
    if fmetrics["launches"]["philox_step_draws"] == 0:
        fail("the funnel launched the Philox kernel no time")
    for k, v in fresult.samples.items():
        if v.shape[:2] != (fcfg["num_chains"], fcfg["num_samples"]):
            fail(f"funnel draws {k} have shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            fail(f"funnel draws {k} are not finite")
    del fresult
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- linear path through K2 ------------------------------------------
    lmetrics, lresult = drive("linear regression", lin_cfg, lin_problem)
    launches["K2"] = lmetrics["launches"]["glm_fused_linear"]
    beta = lresult.samples["beta"]
    if not bool(torch.isfinite(beta).all()):
        fail("linear path: non-finite draws")
    check_sampler("linear path", lmetrics, 0.8, 5, ["glm_fused_linear", "philox_step_draws"])
    z_gap, sd_lo, sd_hi = exact_gaussian_check(lin_data, beta)
    log(f"linear path vs exact posterior: max |mean - exact| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail("linear path: posterior moments disagree with the exact posterior")
    del lresult, beta, lin_problem
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- poisson1000_cov through K3 ---------------------------------------
    pmetrics, presult = drive("poisson1000_cov", pcfg, p_problem)
    launches["K3"] = pmetrics["launches"]["poisson_fused"]
    for k, v in presult.samples.items():
        if v.shape[:2] != (c_p, pcfg["num_samples"]) or not bool(torch.isfinite(v).all()):
            fail(f"poisson1000_cov draws {k}: shape {tuple(v.shape)} or non-finite")
    check_sampler("poisson1000_cov", pmetrics, 0.9, 7, ["poisson_fused", "philox_step_draws"])
    poisson_truth_checks("poisson1000_cov", presult.samples, spec_truth)
    del presult
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- the reference's other bench configs -------------------------------
    philox_by_path = other_configs(CONFIGS, h_problem, po_problem, g_problem, t_start)

    # --- ADVI: glm100's fits, init_strategy='advi' through K3 --------------
    advi_paths = advi_phase(g_problem, p_problem, pcfg, spec_truth)
    log("ADVI paths: " + json.dumps(advi_paths))
    del h_problem, po_problem, g_problem
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- layout invariance -------------------------------------------------
    layout_invariance("elementwise", elementwise_vag(), 3, (4, 8), 0.4, 6)
    layout_invariance("glm100_fused through K1", bind(k1_vag, data), d,
                      (4, cfg["num_chains"]), 0.02, cfg["max_tree_depth"], init_scale=0.1)
    layout_invariance("glm100_fused int8 through K1", bind(k1_vag, i_problem[2]), d,
                      (4, cfg["num_chains"]), 0.02, cfg["max_tree_depth"], init_scale=0.1)
    layout_invariance("glm100_fused f32 through K1", bind(k1_vag, f32_problem[2]), d,
                      (4, cfg["num_chains"]), 0.02, cfg["max_tree_depth"], init_scale=0.1)
    layout_invariance("poisson1000_cov through K3", bind(k3_vag, p_data),
                      pcfg["covariate_dim"] + 2 + pcfg["num_groups"], (4, c_p), 0.002,
                      pcfg["max_tree_depth"], init_scale=0.1)
    layout_invariance("hier1000 through its sufficient statistics", h_vag,
                      hcfg["num_groups"] + 2, (4, hcfg["num_chains"]), 0.005,
                      hcfg["max_tree_depth"], init_scale=0.1)
    for kernel in ("hmc", "metropolis"):
        fixed_trip_layout(f"{kernel}, elementwise", kernel, elementwise_vag(), 3, (4, 8), 0.4, 1.0)
    fixed_trip_layout("hmc, glm100_fused through K1", "hmc", bind(k1_vag, data), d,
                      (4, cfg["num_chains"]), 0.02, 0.1)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- the README quick start ---------------------------------------------
    readme_philox = readme_phase()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- the other samplers: tempering, ensemble, SMC, predictive, WAIC/LOO -
    sampler_paths = other_samplers(cfg, init, data, pred_beta)
    log("other samplers: " + json.dumps(sampler_paths))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    glm_src = "mlx_mcmc_tpu_torch/csrc/glm_fused.cu"
    k1, k2, k4 = ("mlx_mcmc_tpu/ops/pallas/glm.py:49", "mlx_mcmc_tpu/ops/pallas/glm.py:281",
                  "mlx_mcmc_tpu/ops/pallas/glm.py:113")
    # (name, source, replaces, device kernels); a path of the GLM entries
    # that runs other device kernels has its own row.
    sums = ["sum_splits_kernel", "sum_splits_ll_kernel"]
    onepass = ["round_z_kernel", "glm_onepass_kernel"] + sums
    f32_kernels = ["pad_z_kernel", "glm_tf32_value_kernel", "glm_tf32_grad_kernel"] + sums
    sources = {
        "K1": ("glm_fused_logistic", glm_src, k1, onepass),
        "K1_wide": ("glm_fused_logistic:wide_bf16", glm_src, k1,
                    ["glm_hopper_value_kernel", "glm_hopper_grad_kernel"]),
        "K1_int8": ("glm_fused_logistic:int8", glm_src, k1, onepass),
        "K1_int8_wide": ("glm_fused_logistic:wide_int8", glm_src, k1,
                         ["glm_hopper_value_kernel", "glm_hopper_grad_kernel"]),
        "K1_f32": ("glm_fused_logistic:f32", glm_src, k1, f32_kernels),
        "K1_f32_wide": ("glm_fused_logistic:f32_glm1000", glm_src, k1, f32_kernels),
        "K2": ("glm_fused_linear", glm_src, k2, onepass),
        "K2_f32": ("glm_fused_linear:f32", glm_src, k2, f32_kernels),
        "K3": ("poisson_fused", "mlx_mcmc_tpu_torch/csrc/poisson_fused.cu",
               "mlx_mcmc_tpu/ops/pallas/poisson.py:62",
               ["poisson_fused_kernel", "sum_splits_warp_kernel"]),
        "K4": ("glm_fused_hoisted", glm_src, k4, onepass),
        "K4_f32": ("glm_fused_hoisted:f32", glm_src, k4, f32_kernels),
        "philox": ("philox_step_draws", "mlx_mcmc_tpu_torch/csrc/philox.cu",
                   "mlx_mcmc_tpu/inference/engine.py:390",
                   ["philox_step_kernel", "philox_words_kernel"]),
    }
    launches["K4"] = k4_launches
    launches["K1_int8_wide"] = int8_wide_launches
    launches.update({k: v for k, v in f32_launches.items() if k != "K1_f32"})
    kernels = []
    for key, (name, source, replaces, device_kernels) in sources.items():
        row = rows[key]
        extra = {k: v for k, v in row.items() if k not in ("ms", "plain_ms", "bound_ms", "bound_by")}
        extra["device_kernels"] = device_kernels
        if variants.get(key):
            extra["variants"] = variants[key]
        if key in ("K4", "K1_int8_wide", "K2_f32", "K4_f32", "K1_f32_wide"):
            extra["sampling_path"] = False
        if key == "K1_f32":
            extra["phase3_launches"] = f32_launches["K1_f32"]
        cm_names = {"glm100_fused chees (facade)": "glm100_fused ChEES (facade)",
                    "glm100_fused mala": "glm100_fused MALA",
                    "glm100_fused mala draw_chunk": "glm100_fused MALA draw_chunk"}
        if key == "K1":
            extra["launches_by_path"] = {"glm100_fused": launches[key],
                                         "glm100_fused hmc (facade)": hmc_path["K1"],
                                         **{k: cm_paths[v]["K1"] for k, v in cm_names.items()},
                                         **{k: v["K1"] for k, v in ckpt_paths.items()},
                                         **{k: v["K1"] for k, v in temper_paths.items()},
                                         **{k: v["K1"] for k, v in measure_paths.items()},
                                         **{k: v["K1"] for k, v in shard_paths.items()},
                                         **{k: v["K1"] for k, v in data_paths.items()}}
        if key == "K3":
            extra["launches_by_path"] = {"poisson1000_cov": launches[key],
                                         "poisson1000_cov advi": advi_paths["poisson1000_cov advi"]
                                         ["K3"]}
        if key == "philox":
            extra["launches_by_path"] = dict(
                philox_by_path, glm100_fused=launches[key],
                **{"glm100_fused hmc (facade)": hmc_path["philox"]},
                **{k: cm_paths[v]["philox"] for k, v in cm_names.items()}, **readme_philox,
                **{k: v["philox"] for k, v in ckpt_paths.items()},
                **{k: v["philox"] for k, v in advi_paths.items()},
                **{k: v["philox"] for k, v in temper_paths.items()},
                **{k: v["philox"] for k, v in measure_paths.items()},
                **{k: v["philox"] for k, v in shard_paths.items()},
                **{k: v["philox"] for k, v in data_paths.items()},
                **{k: v["philox"] for k, v in sampler_paths.items() if "philox" in v})
            # the raw-word kernel: the tempered swap, ensemble walker and SMC
            # resampling uniforms
            extra["words_launches_by_path"] = dict(
                **{k: v["philox_words"] for k, v in temper_paths.items()},
                **{k: v["philox_words"] for k, v in sampler_paths.items()
                   if "philox_words" in v})
        kernels.append(dict(
            {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[key], "max_abs_err": row["max_abs_err"],
             "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": None},
            **extra,
        ))
    kernels.extend(variant_kernels)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
