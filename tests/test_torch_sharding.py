"""The port's view-sharded single-stream inference
(magnet_tpu_torch/core/sharding_inference.py) against the JAX package, on
the CPU.

Row 4 with a global view count: the cost volume of a split of V = 4 views
into two halves, each divided by ``v_total`` = 4 and summed, against the
unsplit plain version and ``magnet_tpu/ops/costvolume.py::
_cost_volume_cw_xla`` in f32, through ``cost_volume_cw.compare`` at 1e-4 *
max|ref| (f32 sums in another order; elements within 1e-4 of the
consistency threshold left out, at most 1 %).

The forward: the inputs of tests/test_sharding.py's view-sharded test
(32x32, V = 4, seed 0, one iteration), with seeded random weights in a
trained network's regime (as tests/test_torch_magnet.py makes them) carried
across by ``compat/from_jax.py``. W = 2 and W = 4 gloo processes
(``core/distributed.spawn``, each world once for the module; the W = 4
world also runs a mesh of its first 2 ranks) against the JAX package's
single-device ``Magnet.apply(..., n_iters=1)[-1]`` at
tests/test_torch_magnet.py's forward tolerance, 1e-4 * max|ref| on all but
1 % of the pixels (a cost-volume sample on the consistency threshold may
flip and move its pixel by a G-Net update), and against the port's own
unsharded forward at the same tolerance; the ranks of a mesh equal bit for
bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magnet_tpu.models.magnet import Magnet as JMagnet
from magnet_tpu.ops.costvolume import _cost_volume_cw_xla
from magnet_tpu_torch import dryrun
from magnet_tpu_torch.compat.from_jax import magnet_state_dict
from magnet_tpu_torch.core import config, distributed
from magnet_tpu_torch.core.sharding_inference import (ViewMesh,
                                                      shard_magnet_inference,
                                                      view_mesh)
from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.models.build import build_magnet

from test_torch_dnet import _random_variables
from test_torch_kernels import cv_inputs, torch_threads  # noqa: F401

TOL, FLIPS = 1e-4, 0.01
B, V, H, W = 1, 4, 32, 32
ORDER = ("ref_img", "src_imgs", "R", "t", "is_valid", "intM", "rays2d")
ARGV = ["@" + str(Path(__file__).resolve().parents[1] / "test_scripts"
                  / "magnet" / "scannet.txt"),
        "--input_height", str(H), "--input_width", str(W),
        "--dpv_height", str(H // 4), "--dpv_width", str(W // 4),
        "--MAGNET_num_source_views", str(V), "--dataset_name", "synthetic",
        "--DNET_ckpt", "", "--FNET_ckpt", "", "--MAGNET_ckpt", "",
        "--device", "cpu", "--compute_dtype", "float32"]
# mesh sizes each world runs
WORLDS = {2: [2], 4: [4, 2]}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def test_split_cost_volume_matches_xla():
    a = [_t(x) for x in cv_inputs(B=2, V=4, H=24, W=32, C=16)]
    per_view = (2, 3, 4, 5, 6, 7)     # src, mu, sigma, R, t, is_valid
    halves = [[x[:, s] if i in per_view else x for i, x in enumerate(a)]
              for s in (slice(0, 2), slice(2, 4))]
    split = sum(cvk.cost_volume_cw_ref(*h, 5.0, v_total=4) for h in halves)
    whole, margin = cvk.cost_volume_cw_ref(*a, 5.0, return_margin=True)
    xla = _t(jax.jit(_cost_volume_cw_xla, static_argnums=10)(
        *map(jnp.asarray, a), 5.0))
    assert xla.abs().max() > 0.1
    cvk.compare(split, whole, margin, TOL)
    cvk.compare(split, xla, margin, TOL)
    # a half alone is its share of the global mean, not its own mean
    own = cvk.cost_volume_cw_ref(*halves[0], 5.0)
    assert torch.equal(cvk.cost_volume_cw_ref(*halves[0], 5.0, v_total=4),
                       own / 2)


def test_v_total_defaults_to_v_and_is_checked():
    a = [_t(x) for x in cv_inputs(V=3)]
    assert torch.equal(cvk.cost_volume_cw(*a, 5.0),
                       cvk.cost_volume_cw(*a, 5.0, v_total=3))
    with pytest.raises(ValueError, match="v_total=0"):
        cvk.cost_volume_cw_ref(*a, 5.0, v_total=0)


def test_view_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        view_mesh()


def test_views_must_divide_over_the_mesh():
    run = shard_magnet_inference(torch.nn.Identity(), ViewMesh(None, 0, 3),
                                 1)
    x = torch.zeros(1, 4, 8, 8, 3)
    with pytest.raises(ValueError, match="V = 4 .* W = 3"):
        run(x[:, 0], x, *([None] * 5))
    with pytest.raises(ValueError, match="not in the view mesh"):
        shard_magnet_inference(torch.nn.Identity(), ViewMesh(None, -1, 2), 1)


def _inputs():
    """tests/test_sharding.py's inputs (32x32, V = 4, seed 0)."""
    rng = np.random.RandomState(0)
    h, w = H // 4, W // 4
    fx = 0.9 * w
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    grid = np.ones((h, w, 3), np.float32)
    grid[:, :, 0] = (np.arange(w)[None] + 0.5 - K[0, 2]) / K[0, 0]
    grid[:, :, 1] = (np.arange(h)[:, None] + 0.5 - K[1, 2]) / K[1, 1]
    rays = grid.transpose(2, 0, 1).reshape(3, -1)
    vals = (rng.rand(B, H, W, 3), rng.rand(B, V, H, W, 3),
            np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1)),
            rng.randn(B, V, 3).astype(np.float32) * 0.02,
            np.ones((B, V), np.float32), np.tile(K, (B, 1, 1)),
            np.tile(rays, (B, 1, 1)))
    return {k: np.asarray(v, np.float32) for k, v in zip(ORDER, vals)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX model's variables (eval_shape, then seeded numpy
    in a trained network's regime, as ``test_torch_magnet.magnet_case``
    makes them) and the JAX single-device forward's last map."""
    inputs = _inputs()
    jm = JMagnet(n_iters=1)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        *[jax.ShapeDtypeStruct(inputs[k].shape, jnp.float32)
          for k in ORDER])
    variables = jax.tree.map(np.asarray, _random_variables(shapes, seed=1))
    p = variables["params"]
    head = p["d_net"]["d_net"]["depth_head"]["conv2"]["conv"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.array([2.0, -3.0], np.float32)
    proj = p["f_net"]["f_net"]["lastconv1"]
    proj["kernel"] = proj["kernel"] / 500.0
    last = p["g_net"]["conv3"]["conv"]
    last["kernel"] = last["kernel"] * 0.05
    ref = np.asarray(jax.jit(
        lambda v, *a: jm.apply(v, *a, train=False, n_iters=1)[-1])(
            variables, *[inputs[k] for k in ORDER]))
    return inputs, magnet_state_dict(variables), ref


@pytest.fixture(scope="module")
def unsharded(case):
    """The port's own one-process forward of the case."""
    inputs, state, _ = case
    model = build_magnet(config.parse_args(
        config.build_test_magnet_parser(), ARGV), "cpu")
    model.load_state_dict(state, strict=False)
    with torch.no_grad():
        return model(*[_t(inputs[k]) for k in ORDER], n_iters=1)[-1].numpy()


@pytest.fixture(scope="module")
def sharded(case, tmp_path_factory):
    """world -> rank -> mesh size -> the rank's map, one spawn a world."""
    inputs, state, _ = case
    tmp = tmp_path_factory.mktemp("sharded")
    out = {}
    for world, meshes in WORLDS.items():
        path = tmp / f"case{world}.pt"
        torch.save(dict(argv=ARGV, state=state, dtypes=[torch.float32],
                        device="cpu", inputs=inputs, n_iters=1,
                        meshes=meshes, frames=0), path)
        res = str(tmp / f"w{world}_rank{{rank}}.pt")
        distributed.spawn(dryrun.view_sharded_worker, world,
                          (str(path), res),
                          init_method="file://" + str(tmp / f"rdv{world}"))
        out[world] = [torch.load(res.format(rank=r), weights_only=False)
                      for r in range(world)]
    return out


CASES = [(2, 2), (4, 4), (4, 2)]
IDS = ["w2", "w4", "w4_mesh2"]


def _maps(sharded, world, n):
    ranks = [r["float32", n]["pred"].numpy() for r in sharded[world]
             if ("float32", n) in r]
    assert len(ranks) == n
    for m in ranks[1:]:
        np.testing.assert_array_equal(m, ranks[0])
    return ranks[0]


def _close(out, ref):
    assert out.shape == ref.shape == (B, H, W, 2)
    err = np.abs(out - ref)
    lim = TOL * float(np.abs(ref).max())
    assert (err > lim).mean() < FLIPS, (err.max(), lim)


@pytest.mark.parametrize("world,n", CASES, ids=IDS)
def test_view_sharded_forward_matches_jax(case, sharded, world, n):
    ref = case[2]
    assert ref[..., 1].min() > 1e-3, "sigma collapsed"
    _close(_maps(sharded, world, n), ref)


@pytest.mark.parametrize("world,n", CASES, ids=IDS)
def test_view_sharded_forward_matches_unsharded(sharded, unsharded, world,
                                                n):
    _close(_maps(sharded, world, n), unsharded)
    # the ranks outside a smaller mesh ran nothing in it
    assert all(("float32", n) not in r for r in sharded[world][n:])
