"""The reference's benchmark scripts, on the card.

``glm_kernel_variants`` and ``flagship_decomposition`` are the
counterparts of the repository's ``benchmarks/glm_kernel_variants.py`` and
``benchmarks/flagship_decomposition.py``: they time the variants of the
fused GLM kernel's body (``ops/glm_variants.py``, ``csrc/glm_variants.cu``)
beside the production kernel; both need a GPU. ``nuts_overhead``,
``flagship_breakdown``, ``poisson_roofline`` and ``run_all`` are the
counterparts of the single-device scripts of the same names: where a NUTS
leapfrog's time goes, the flagship's warmup and sampling leaves and its
lockstep tax, K3 against autograd on the roofline, and ESS/s across kernels
and models. Run each with ``python -m``; each runs on the card, or where
``--device`` says (``--device cpu`` for a rehearsal), and fails without a
GPU unless asked for the CPU. Each prints its JSON with the card's name and
power limit as nvidia-smi gives them.

``scaling``, ``collective_overhead`` and ``make_scaling_artifact`` are the
counterparts of the mesh scripts: weak scaling over the chain axis, the
marginal cost of the collectives (the chain axis's pooled adaptation and
the data axis's sums), and the artifact that puts the card's chain-count
table beside them. Their worlds of several ranks start one process a rank
(:func:`run_world`): gloo worlds on the CPU as a rehearsal, and on the card
as many ranks as it has GPUs.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from mlx_mcmc_tpu_torch._device import resolve_device


def device_from_argv(argv=None) -> torch.device:
    """``--device DEV`` from ``argv`` (default ``sys.argv``), else CUDA;
    raises without a GPU unless the CPU was asked for."""
    argv = sys.argv if argv is None else argv
    return resolve_device(argv[argv.index("--device") + 1] if "--device" in argv else None)


def card(device: torch.device) -> str:
    """``name, power.limit`` of the card as nvidia-smi gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def elapsed_ms(fn, device: torch.device):
    """``(fn(), ms)``: on the card from CUDA events around the call (the
    device's timeline from its first to its last work, host waits
    included), ended by a synchronize; on the CPU from the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(module: str, world: int, device: str, args: dict, timeout: float = 3600.0) -> dict:
    """Run ``python -m module --worker RANK WORLD PORT DEVICE ARGS OUT`` in
    ``world`` processes, one a rank (``LOCAL_RANK`` = its rank, so that each
    takes its own GPU), which join one process group over localhost TCP
    (:func:`worker_group`); return the JSON that rank 0 writes to ``OUT``.
    The repository root goes on ``PYTHONPATH``. A rank that fails or
    outlives ``timeout`` raises, and every process is stopped before this
    returns."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join([root] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                                     else []))
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, "--worker", str(rank), str(world), str(port), device,
             json.dumps(args), out],
            env=dict(os.environ, PYTHONPATH=path, LOCAL_RANK=str(rank)), cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(world)]
        outputs = []
        try:
            for p in procs:
                outputs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, text) in enumerate(zip(procs, outputs)):
            if p.returncode != 0:
                raise RuntimeError(f"{module}: rank {rank} of {world} failed (exit "
                                   f"{p.returncode}):\n{text[-4000:]}")
        with open(out) as f:
            return json.load(f)


def worker_group(argv) -> tuple:
    """A :func:`run_world` rank's ``(rank, world, device, args, out)`` from
    ``argv`` (after ``--worker``), its process group started: gloo on the
    CPU, nccl on the card. On the CPU each rank takes its share of the
    host's cores for its threads (more would oversubscribe them)."""
    from mlx_mcmc_tpu_torch.parallel import initialize_distributed

    rank, world, port, device, args, out = argv
    rank, world = int(rank), int(world)
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           device="cpu" if device == "cpu" else None)
    return rank, world, resolve_device(device), json.loads(args), out


def end_world() -> None:
    """A :func:`run_world` rank's end: every rank waits for the others,
    then the cached runners (which hold the groups) go and the process
    group ends."""
    import torch.distributed as dist

    from mlx_mcmc_tpu_torch import clear_runner_cache

    dist.barrier()
    clear_runner_cache()
    dist.destroy_process_group()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
