"""The port's process groups and meshes (``mlx_mcmc_tpu_torch.parallel``'s
``initialize_distributed``, ``chain_mesh``, ``data_chain_mesh``) against
``tests/test_distributed.py`` and the reference's ``parallel/mesh.py``.

Two processes of a gloo world on the CPU initialize through
``initialize_distributed`` (an explicit coordinator, then torchrun's
variables) and a sum and a gather across them verify; they get the repo
root on ``PYTHONPATH`` (``tests/_torch_parallel_worker.py``). A world of
one runs in this process on a ``HashStore`` and ends at module teardown.
Without a GPU nothing starts unless the CPU is asked for.
"""

import json

import pytest
import torch
import torch.distributed as dist

import _torch_parallel_worker as W
from mlx_mcmc_tpu_torch.parallel import (chain_mesh, data_chain_mesh, initialize_distributed,
                                         sample_sharded)
from mlx_mcmc_tpu_torch.utils import MeshConfig


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_two_process_initialize_and_collective(tmp_path):
    W.Ranks(tmp_path, "init").wait()
    for rank in (0, 1):
        with open(tmp_path / f"init.rank{rank}.json") as f:
            got = json.load(f)
        for how in ("explicit", "env"):
            assert got[how] == {"backend": "gloo", "world": 2, "rank": rank, "sum": 3.0,
                                "gathered": [0.0, 0.0, 1.0, 10.0]}, how


def test_nothing_starts_without_a_gpu_unless_asked(no_group):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_mesh()  # no group: it starts a world of one on the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_sharded(W.normal_model, {"x": torch.zeros(2)}, num_samples=2, num_warmup=2)
    assert not dist.is_initialized()


def test_world_of_one_and_its_meshes(no_group):
    initialize_distributed(device="cpu")
    group = dist.group.WORLD
    initialize_distributed(device="cpu")  # idempotent
    assert dist.group.WORLD is group
    assert (dist.get_backend(), dist.get_world_size(), dist.get_rank()) == ("gloo", 1, 0)
    mesh = chain_mesh()
    assert mesh.mesh_dim_names == ("chains",) and tuple(mesh.shape) == (1,)
    assert chain_mesh(devices=[0]).mesh_dim_names == ("chains",)
    two = data_chain_mesh(1, 1)
    assert two.mesh_dim_names == ("chains", "data") and tuple(two.shape) == (1, 1)
    assert MeshConfig(data=1).build().mesh_dim_names == ("chains",)
    assert MeshConfig(chains=1, data=1).build().mesh_dim_names == ("chains",)
    # no rank may be left idle, and none may be missing
    for call in (lambda: chain_mesh(num_devices=2), lambda: data_chain_mesh(2, 1),
                 lambda: data_chain_mesh(1, 2), lambda: chain_mesh(devices=[1])):
        with pytest.raises(ValueError, match="1"):
            call()
    with pytest.raises(ValueError, match="axis 'rows'"):
        sample_sharded(W.normal_model, {"x": torch.zeros(2)}, num_samples=2, num_warmup=2,
                       mesh=mesh, axis="rows", device="cpu")


def test_explicit_arguments_go_together(no_group):
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("127.0.0.1:1", device="cpu")
    assert not dist.is_initialized()
