"""Training across several processes (magnet_tpu_torch/core/distributed.py,
core/mesh.py, the sharded loaders, dryrun.py, utils/profiling.py) on the
CPU, against the JAX package and against the port's own one-process step.

Processes: ``core/distributed.spawn`` starts W gloo processes joined at a
``file://`` rendezvous under the test's tmp_path (test runners that run
several workers at once would race for TCP ports), each with its share of
this process's CPU threads.

Tolerances, each with its reason:
* the F-Net step over W = 2 processes against JAX's F-Net step on a
  2-device mesh (``mesh_lib.make_mesh(2)``): those of
  ``tests/test_torch_train.py::test_fnet_train_step_matches_jax`` (loss
  1e-5 relative, every clipped gradient 1e-4 * max|g| of its tensor, the
  BatchNorm running statistics 1e-5), at the same well-conditioned point;
* the same W = 2 step against the port's one-process step: the loss to
  1e-5 relative and every parameter and buffer after the update to
  1e-5 * max|p| of its tensor (the batch statistics and the gradients are
  sums in another order; AdamW's first step moves a parameter by about the
  learning rate, 1e-4, whatever the gradient's size);
* the ranks' parameters after the step: equal, bit for bit;
* the sharded loaders: equal to the one-process loader bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from magnet_tpu.core import mesh as mesh_lib
from magnet_tpu.train import steps as jsteps
from magnet_tpu_torch import data as tdata
from magnet_tpu_torch import dryrun
from magnet_tpu_torch.core import distributed, mesh
from magnet_tpu_torch.data import scannet
from magnet_tpu_torch.models.magnet import MagnetF
from magnet_tpu_torch.train import optim, steps
from magnet_tpu_torch.utils import profiling

from test_torch_data import (SCENE, _args as _data_args, _depth16, _pose,
                             _rgb, splits)  # noqa: F401
from test_torch_kernels import torch_threads  # noqa: F401
from test_torch_train import (FEAT, MAX_DEPTH, MIN_DEPTH,  # noqa: F401
                              _port_state_dict, jax_inputs)

WORLD = 2


def _init(tmp_path, name="rendezvous"):
    return "file://" + str(tmp_path / name)


# ---- (d) the environment's process group --------------------------------

def test_initialize_disabled_by_default():
    calls = []
    assert distributed.maybe_initialize_distributed(
        env={}, _init_fn=lambda **kw: calls.append(kw)) is False
    assert calls == []


def test_initialize_parses_env(monkeypatch):
    monkeypatch.setattr(distributed, "_initialized", False)
    calls = []
    env = {"MAGNET_TPU_DIST": "1",
           "MAGNET_TPU_COORDINATOR": "10.0.0.1:1234",
           "MAGNET_TPU_NUM_PROCESSES": "2",
           "MAGNET_TPU_PROCESS_ID": "1"}
    assert distributed.maybe_initialize_distributed(
        env=env, _init_fn=lambda **kw: calls.append(kw),
        device="cpu") is True
    assert calls == [{"backend": "gloo",
                      "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 2, "rank": 1}]
    # idempotent: a second call must not re-initialize
    assert distributed.maybe_initialize_distributed(
        env=env, _init_fn=lambda **kw: calls.append(kw)) is True
    assert len(calls) == 1
    monkeypatch.setattr(distributed, "_initialized", False)


def test_torchrun_env_and_backends(monkeypatch):
    """torchrun's RANK/WORLD_SIZE turn it on (rendezvous ``env://``, torch's
    default); NCCL on the card, gloo on the CPU; a URL passes as given."""
    monkeypatch.setattr(distributed, "_initialized", False)
    calls = []
    distributed.maybe_initialize_distributed(
        env={"RANK": "3", "WORLD_SIZE": "4"},
        _init_fn=lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed, "_initialized", False)
    distributed.maybe_initialize_distributed(
        env={"MAGNET_TPU_DIST": "1",
             "MAGNET_TPU_COORDINATOR": "file:///tmp/x"},
        _init_fn=lambda **kw: calls.append(kw), device="cpu")
    monkeypatch.setattr(distributed, "_initialized", False)
    assert calls == [{"backend": "nccl", "world_size": 4, "rank": 3},
                     {"backend": "gloo", "init_method": "file:///tmp/x"}]
    assert distributed.local_device_index({"LOCAL_RANK": "5"}) == 5


def test_auto_detect_passes_only_the_backend(monkeypatch):
    monkeypatch.setattr(distributed, "_initialized", False)
    calls = []
    distributed.maybe_initialize_distributed(
        env={"MAGNET_TPU_DIST": "1"},
        _init_fn=lambda **kw: calls.append(kw), device="cpu")
    assert calls == [{"backend": "gloo"}]
    monkeypatch.setattr(distributed, "_initialized", False)


@pytest.mark.parametrize("flags, world, match", [
    (dict(mesh_shape="4", batch_size=4), 1, "does not match the world size"),
    (dict(mesh_shape="2", batch_size=3), 2, "launch 1"),
    (dict(mesh_shape="auto", batch_size=6), 4, "launch 3"),
    (dict(distributed=False, batch_size=4), 2, "--no_distributed"),
])
def test_world_from_args_raises(monkeypatch, flags, world, match):
    """--mesh_shape must be the world size; the global batch must divide
    over it (the error names the largest world it divides over: the one
    deviation from the JAX package's ``auto``); --no_distributed is one
    process."""
    monkeypatch.setattr(mesh, "rank_world", lambda: (0, world))
    args = type("A", (), dict(dict(distributed=True, mesh_shape="auto"),
                              **flags))
    with pytest.raises(ValueError, match=match):
        mesh.world_from_args(args)


def test_world_from_args_one_process():
    args = type("A", (), dict(distributed=True, mesh_shape="auto",
                              batch_size=3))
    assert mesh.world_from_args(args) == (0, 1)


# ---- (c) the sharded loaders ---------------------------------------------

def _sharded(monkeypatch, make, args, mode, world, epochs=2):
    """Each rank's batches of ``world`` ranks (the dispatch reading the
    rank from ``rank_world``), and one process's."""
    out = []
    for rank in range(world):
        monkeypatch.setattr(scannet, "rank_world", lambda r=rank: (r, world))
        loader = make(args, mode)
        assert loader.shard_index == rank and loader.shard_count == world
        out.append([b for _ in range(epochs) for b in loader])
    monkeypatch.setattr(scannet, "rank_world", lambda: (0, 1))
    loader = make(args, mode)
    return out, [b for _ in range(epochs) for b in loader]


def _assert_concat_equal(ranks, whole):
    assert len(whole) > 0 and all(len(r) == len(whole) for r in ranks)
    for i, b in enumerate(whole):
        for k, v in b.items():
            parts = [r[i][k] for r in ranks]
            if isinstance(v, np.ndarray):
                got = np.concatenate(parts)
                assert got.dtype == v.dtype, k
                np.testing.assert_array_equal(got, v, err_msg=k)
            else:
                assert sum(parts, []) == v, k


@pytest.mark.parametrize("kind, world", [("multiview", 2),
                                         ("singleview", 4)])
def test_synthetic_loader_shards_concatenate_to_one_process(
        monkeypatch, kind, world):
    args = _data_args(None, "scannet", dataset_name="synthetic",
                      batch_size=4, workers=2, synthetic_length=9,
                      input_height=24, input_width=32, dpv_height=6,
                      dpv_width=8)
    make = getattr(tdata, f"make_{kind}_loader")
    ranks, whole = _sharded(monkeypatch, make, args, "train", world)
    _assert_concat_equal(ranks, whole)
    assert ranks[0][0]["ref_img" if kind == "multiview" else
                       "img"].shape[0] == 4 // world
    # evaluation loaders are not sharded
    monkeypatch.setattr(scannet, "rank_world", lambda: (1, world))
    assert make(args, "test").shard_count == 1


def test_scannet_loader_shards_concatenate_to_one_process(
        monkeypatch, tmp_path, splits):  # noqa: F811
    """A ScanNet tree (training split replaced): the two ranks' batches,
    augmentations included, put together are the one-process batches."""
    scene = tmp_path / "scannet" / "scans" / SCENE
    for sub in ("color", "depth", "pose", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 1170.2, 1170.2, 647.8, 483.8
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", K)
    for i in range(6):
        _rgb(scene / "color" / f"{i}.jpg", 80, 60, seed=i)
        _depth16(scene / "depth" / f"{i}.png", 64, 48, seed=i)
        _pose(scene / "pose" / f"{i}.txt", 0.01 * i)
    args = _data_args(tmp_path, "scannet", batch_size=2, workers=1)
    ranks, whole = _sharded(monkeypatch, tdata.make_multiview_loader, args,
                            "train", WORLD)
    _assert_concat_equal(ranks, whole)


# ---- (a, b) the F-Net step over two processes ----------------------------

@pytest.fixture(scope="module")
def two_rank_step(jax_inputs, tmp_path_factory):
    """The port's F-Net step over two gloo processes from ``jax_inputs``'
    weights and batch: each rank's loss, clipped gradients and state after
    the step."""
    tmp = tmp_path_factory.mktemp("fnet_w2")
    c = jax_inputs
    case = tmp / "case.pt"
    torch.save(dict(state=_port_state_dict(c["variables"]), feat=FEAT,
                    batch=c["batch"], d_center=c["dc"], device="cpu",
                    dtype=torch.float32, lr=1e-4), case)
    out = str(tmp / "rank{rank}.pt")
    distributed.spawn(dryrun.fnet_step_worker, WORLD, (str(case), out),
                      _init(tmp))
    return [torch.load(out.format(rank=r)) for r in range(WORLD)]


def _jax_mesh_step(inputs):
    """JAX's F-Net step on a 2-device data mesh (the batch sharded, the
    state replicated): the loss, the gradients and the new batch_stats,
    the sweep backward by autodiff."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MAGNET_TPU_SWEEP_BWD", "xla")
    try:
        keep = optax.GradientTransformation(
            lambda p: optax.EmptyState(),
            lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
        step = jsteps.make_fnet_train_step(inputs["model"], keep,
                                           inputs["dc"], MAX_DEPTH,
                                           MIN_DEPTH, jnp.float32)
        m2 = mesh_lib.make_mesh(WORLD)
        state = mesh_lib.replicate(m2, jsteps.TrainState.create(
            jax.tree.map(jnp.asarray, inputs["variables"]), keep))
        state, m = step(state, mesh_lib.shard_batch(m2, inputs["batch"]))
    finally:
        mp.undo()
    return (float(m["loss"]), jax.tree.map(np.asarray, state.opt_state),
            jax.tree.map(np.asarray, state.batch_stats))


def test_two_process_fnet_step_matches_jax_mesh(jax_inputs, two_rank_step):
    loss, grads, new_stats = _jax_mesh_step(jax_inputs)
    flat = [np.asarray(g) for g in jax.tree.leaves(grads)]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in flat))
    want = _port_state_dict({"params": jax.tree.map(
        lambda g: g * min(1.0, 1.0 / norm), grads)})
    stats = _port_state_dict({"batch_stats": new_stats})
    for r in two_rank_step:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert set(r["grads"]) == {k for k in want if "running" not in k
                                   and "num_batches" not in k}
        for k, g in r["grads"].items():
            ref = want[k].numpy()
            err = np.abs(g.numpy() - ref).max()
            assert err <= 1e-4 * np.abs(ref).max(), (k, err)
        for k, v in stats.items():
            if "running" in k:
                np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


def test_two_process_fnet_step_matches_one_process(jax_inputs, two_rank_step):
    c = jax_inputs
    model = MagnetF(FEAT)
    model.load_state_dict(_port_state_dict(c["variables"]))
    opt = optim.make_fnet_optimizer(model.parameters(), 1e-4, 10)
    step = steps.make_fnet_train_step(torch.from_numpy(c["dc"]), MAX_DEPTH,
                                      MIN_DEPTH, torch.float32)
    _, m = step(steps.TrainState(model, opt),
                {k: torch.from_numpy(v) for k, v in c["batch"].items()})
    one = model.state_dict()
    r0, r1 = two_rank_step
    np.testing.assert_allclose(r0["loss"], float(m["loss"]), rtol=1e-5)
    assert r0["loss"] == r1["loss"]
    moved = 0
    for k, v in one.items():
        assert torch.equal(r0["state"][k], r1["state"][k]), k
        if v.is_floating_point():
            err = (r0["state"][k] - v).abs().max().item()
            assert err <= 1e-5 * v.abs().max().item(), (k, err)
            moved += int(not torch.equal(v, _port_state_dict(
                c["variables"])[k]))
    assert moved > 0


# ---- (e) dryrun_multichip -------------------------------------------------

def test_dryrun_multichip_green(tmp_path, capsys):
    res = dryrun.dryrun_multichip(WORLD, init_method=_init(tmp_path))
    out = capsys.readouterr().out
    assert "ok" in out and "rel_delta" in out
    assert 0.0 < res["loss"] < 1e4 and res["rel"] <= dryrun.LOSS_TOL
    assert res["param_update_l1"] > 0


def test_dryrun_catches_same_data_everywhere(tmp_path):
    """Every rank fed rank 0's share: the ranks' mean loss is no longer the
    whole batch's, and the check fails."""
    with pytest.raises(Exception, match="mismatch"):
        dryrun.dryrun_multichip(WORLD, init_method=_init(tmp_path),
                                _shard_fn=dryrun.shard_same_everywhere)


# ---- (f) ProfileWindow ----------------------------------------------------

def test_profile_window_writes_a_trace_between_its_ticks(tmp_path):
    window = profiling.ProfileWindow(str(tmp_path), start=1, num=2)
    x = torch.randn(64, 64)
    for _ in range(5):
        window.tick()
        with profiling.stage("matmul step"):
            x = x @ x / 64
    window.close()
    assert window.path and os.path.exists(window.path)
    assert os.path.basename(window.path) == "trace_rank0_steps1-3.json"
    events = json.loads(open(window.path).read(), strict=False)["traceEvents"]
    name = profiling.RANGE_PREFIX + "matmul step"
    assert sum(e.get("name") == name for e in events) == 2
    assert os.listdir(tmp_path) == [os.path.basename(window.path)]


def test_profile_window_without_logdir_does_nothing():
    window = profiling.ProfileWindow("", start=0, num=2)
    for _ in range(3):
        window.tick()
    window.close()
    assert window.prof is None and window.path == ""
