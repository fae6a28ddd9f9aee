"""The port's sharded checkpoint paths (``io.resume``, ``run_warmup`` and
``resume_warmup`` with ``mesh=``) against the reference's oracles
(``tests/test_sharded_resume.py``) and its r5 review's faults.

Four ranks of a gloo world on the CPU run every scenario in one session
(``tests/_torch_sharding_worker.py``, suite ``resume``), started once for
the module, on ``chain_mesh()`` (four chain ranks) and
``data_chain_mesh(2, 2)``.

- A sharded run cut in two, saved, loaded and resumed on the same layout
  gives the uninterrupted run's draws bit for bit (NUTS, HMC, ChEES on the
  chain mesh; HMC on the data mesh with ``log_prior_fn``), as do a live
  result resumed twice, a resume after a chunked run and
  ``run_warmup(mesh=...)`` then ``resume_warmup(mesh=...)`` (through the
  disk on the chain mesh, in three segments on the data mesh).
- Another layout, a sharded checkpoint without ``mesh=`` and a ``sample()``
  checkpoint with it are refused, naming both layouts.
- The guards the reference holds one way (``log_prior_fn``,
  ``data_specs``) hold both ways; a position-only checkpoint refuses
  ``mesh=``; an unknown kwarg raises a ``ValueError`` naming it and the
  caller; ``resume``'s messages name ``resume``.

The reference's Orbax round trip has no counterpart: the port writes npz
only. Split sizes are cut to 30 + 10 + 10 (the reference's 60 + 20 + 20):
the bits are the check.
"""

import numpy as np
import pytest

import _torch_parallel_worker as W
import _torch_sharding_worker as S


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    four = W.Ranks(tmp_path_factory.mktemp("resume_ranks"), "resume", world=S.WORLD)
    try:
        four.wait()
        yield four
    finally:
        four.stop()


@pytest.mark.parametrize("kernel", ["nuts", "hmc", "chees"])
def test_split_equals_uninterrupted(ranks, kernel):
    # tests/test_sharded_resume.py:146-171, through the disk
    got, _ = ranks.load("split", 0)
    assert int(got[f"{kernel}_axis_size"]) == S.WORLD
    np.testing.assert_array_equal(got[f"{kernel}_full"], got[f"{kernel}_glued"])
    np.testing.assert_array_equal(got[f"{kernel}_full_accept"], got[f"{kernel}_rest_accept"])


def test_live_result_resume_and_chaining(ranks):
    # test_sharded_resume.py:173-183
    got, _ = ranks.load("live", 0)
    np.testing.assert_array_equal(got["full"], got["glued"])


@pytest.mark.parametrize("case", ["other_layout", "no_mesh", "unsharded_to_sharded"])
def test_mesh_layout_mismatch_rejected(ranks, case):
    # test_sharded_resume.py:185-210: another layout, a sharded checkpoint
    # without its mesh, a sample() checkpoint with one
    message = ranks.load("mismatch", 0)[1][case]
    assert message.startswith("ValueError: resume: the mesh layout differs"), message
    assert "checkpoint:" in message


def test_data_sharded_resume(ranks):
    # test_sharded_resume.py:212-245, the prior's guard both ways
    got, meta = ranks.load("data_resume", 0)
    np.testing.assert_array_equal(got["full"], got["glued"])
    assert meta["no_prior"].startswith("ValueError") and "log_prior_fn" in meta["no_prior"]
    assert "did not pass data_specs" in meta["extra_specs"]


def test_resume_after_chunked_sharded_run(ranks):
    # test_sharded_resume.py:247-260
    got, _ = ranks.load("after_chunk", 0)
    np.testing.assert_array_equal(got["full"], got["glued"])


def test_run_warmup_resume_warmup_mesh(ranks):
    got, meta = ranks.load("warmup", 0)
    np.testing.assert_array_equal(got["chain_full"], got["chain_rest"])
    assert int(got["chain_tiled"][0]) == S.WORLD  # the adaptation state tiled over the ranks
    np.testing.assert_array_equal(got["data_full"], got["data_rest"])
    assert meta["mesh_axes"] == {"axis": "chains", "axis_size": 2, "data_axis": "data",
                                 "data_axis_size": 2}
    assert meta["warmup_other_layout"].startswith("ValueError: resume_warmup: the mesh layout")
    assert "log_prior_fn" in meta["warmup_no_prior"]


@pytest.mark.parametrize("case,text", [
    ("legacy_mesh", "resume: ['mesh'] apply to sharded runs only"),
    ("unknown_kwarg", "resume: unsupported sampler kwarg(s) ['bogus']"),
    ("resume_mesh_prefix", "ValueError: resume: the mesh layout differs"),
    ("extra_prior", "did not pass log_prior_fn"),
    ("warmup_unknown_kwarg", "run_warmup: unsupported sampler kwarg(s) ['bogus']"),
])
def test_review_guards(ranks, case, text):
    """The r5 review's faults, not inherited: a position-only checkpoint
    refuses the mesh keywords, unknown kwargs raise a ValueError naming
    them and the caller, messages name their caller, and the prior's guard
    holds both ways."""
    message = ranks.load("guards", 0)[1][case]
    assert text in message, message
    assert "phase" not in ranks.load("guards", 0)[1]["legacy_loaded"]  # position-only


def test_every_rank_holds_the_global_result(ranks):
    for name in S.SUITES["resume"]:
        a, meta_a = ranks.load(name, 0)
        for rank in range(1, S.WORLD):
            b, meta_b = ranks.load(name, rank)
            assert a.keys() == b.keys() and meta_a == meta_b, name
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} rank {rank} {k}")
