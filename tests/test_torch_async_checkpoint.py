"""Asynchronous checkpoint saves (core/checkpoint.save_pytree_async and
wait_for_saves, the port's counterparts of the JAX package's) on the CPU:
a save is a snapshot taken when it is called; a writer's error is raised
at wait_for_saves and at the next save; TrainingStrategy's interval saves
are asynchronous, and a resume from one is bit-equal to a resume from a
blocking save of the same state and to the run that was not interrupted,
in one process and on 4 gloo ranks (one group, mesh (1, 4, 1): each rank
writes its own file). The 4-rank run reads 14 samples, which shard 4, 4,
3, 3 over the ranks: every rank must take the same 3 steps, or the ranks
with a fourth would wait in its collectives until the group timed out.
The same group exports a tree sharded on a (1, 2, 2) mesh (head-aligned
over 'tensor'): every file equals the single-process export bit for
bit."""

import os

import pytest
import torch
import torch_mesh_ranks as ranks
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu_torch.core import checkpoint as ckpt
from grounded_video_llm_tpu_torch.parallel.launch import spawn


def test_async_save_is_a_snapshot(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    tree = {"a": {"w": w}, "opt": {"count": 3}, "step": 3}
    path = str(tmp_path / "s.pt")
    ckpt.save_pytree_async(path, tree)
    w.add_(100.0)               # the next step's in-place update
    tree["step"] = 4
    ckpt.wait_for_saves()
    tmpl = {"a": {"w": torch.zeros(2, 3)}, "opt": {"count": 0}, "step": 0}
    out = ckpt.load_pytree(path, template=tmpl)
    assert torch.equal(tmpl["a"]["w"], torch.arange(6.0).reshape(2, 3))
    assert out["step"] == 3 and out["opt"]["count"] == 3
    assert not os.path.exists(path + ".tmp")


def test_writer_error_surfaces(tmp_path, monkeypatch):
    def fail(obj, f):
        raise OSError("disk full")

    tree = {"w": torch.ones(2)}
    monkeypatch.setattr(ckpt.torch, "save", fail)
    ckpt.save_pytree_async(str(tmp_path / "a.pt"), tree)
    with pytest.raises(RuntimeError, match="asynchronous") as err:
        ckpt.wait_for_saves()
    assert isinstance(err.value.__cause__, OSError)
    ckpt.save_pytree_async(str(tmp_path / "b.pt"), tree)
    with pytest.raises(RuntimeError, match="asynchronous"):
        ckpt.save_pytree_async(str(tmp_path / "c.pt"), tree)   # the next
    ckpt.wait_for_saves()       # nothing left in flight
    assert not os.path.exists(tmp_path / "a.pt")


def _check_resume(result):
    assert result["equal"] == [True, True]
    losses = result["losses"]
    assert losses[1] == losses[2] == losses[0]
    assert result["steps"] == [3, 3, 3]
    assert len(result["blocked_s"]) == 1


def test_resume_from_async_save_equals_blocking(tmp_path):
    _check_resume(ranks.resume_check(str(tmp_path)))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("four_ranks")
    return run_dir, spawn(ranks.checkpoint_rank, 4, str(run_dir),
                          timeout=180.0)


def test_resume_from_async_save_on_four_ranks(four_ranks):
    run_dir, results = four_ranks
    for r in results:
        _check_resume(r)
    files = sorted(os.listdir(run_dir / "a" / "state_latest.pt"))
    assert files == [f"rank{r}-of-4.pt" for r in range(4)]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_export_from_tensor_mesh_equals_single_process(four_ranks,
                                                       tmp_path):
    _, results = four_ranks
    got, want = results[0]["export"], ranks.export_dumps(str(tmp_path))
    assert [r["export"] for r in results[1:]] == [None] * 3
    assert sorted(got) == sorted(want) and len(want) == 6
    for f in want:
        assert _same(got[f], want[f]), f


def test_uneven_shards_take_the_same_steps_on_four_ranks(four_ranks):
    """14 samples over 4 ranks at one row a rank and step: the group
    finished (no rank waited alone in a collective), 3 steps each."""
    _, results = four_ranks
    assert [r["n_samples"] for r in results] == [14] * 4
    assert [r["steps"] for r in results] == [[3, 3, 3]] * 4
