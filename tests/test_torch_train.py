"""The port's F-Net training (magnet_tpu_torch/train, models.MagnetF, the
train_fnet entry point) against the JAX package, on the CPU, in f32.

Tolerances, each with its reason:
* losses: rtol 1e-6 (the same f32 arithmetic, summed in another order);
* schedules: the port evaluates them in double precision, optax in f32, so
  atol 1e-6 of the peak learning rate (and of beta1);
* optimizer over 5 steps: atol 1e-6 on the parameters (f32 AdamW; torch and
  optax round the moments and the bias correction differently);
* one F-Net train step, from the same weights and batch, sweep backward
  by autodiff on the JAX side (``MAGNET_TPU_SWEEP_BWD=xla``): the loss to
  1e-5 relative, every gradient to 1e-4 * max|g| of its tensor, the
  BatchNorm running statistics after the step to 1e-5. Both sides sum f32
  products in another order; the step is taken where that rounding is not
  amplified. At plain random weights a few ReLU inputs lie within f32 noise
  of 0 and a flip moves a layer's gradient by 1e-3 to 3e-2 of its largest
  element, and a conv after a ReLU turns the ReLU's offset into channel
  means far above their spread, so that the variance E[x^2] - E[x]^2
  cancels: either f32 program was then up to 2e-3 * max|g| from an f64
  evaluation of the same step. With every ReLU input 6 standard deviations
  above its kink (at least 1e-5 from it, asserted in the port's
  forward), zero-mean kernels and a colour offset per frame (the SPP
  BatchNorms see 6 pooled values), both are within 2e-5 * max|g| of it.
Each JAX program is compiled once, in module-scoped fixtures.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from magnet_tpu.data import base as jbase
from magnet_tpu.models.magnet import MagnetF as JMagnetF
from magnet_tpu.train import losses as jlosses
from magnet_tpu.train import optim as joptim
from magnet_tpu.train import steps as jsteps
from magnet_tpu_torch import test_magnet, train_fnet
from magnet_tpu_torch.compat.from_jax import fnet_state_dict
from magnet_tpu_torch.core import config
from magnet_tpu_torch.data import base
from magnet_tpu_torch.data.synthetic import SyntheticMultiView
from magnet_tpu_torch.models import build
from magnet_tpu_torch.models.magnet import MagnetF, sid_depth_centers
from magnet_tpu_torch.train import checkpoint, losses, optim, steps

from test_torch_dnet import _random_variables
from test_torch_kernels import torch_threads  # noqa: F401

B, V, H, W, D, FEAT = 2, 2, 64, 64, 8, 16
MAX_DEPTH, MIN_DEPTH = 10.0, 1e-3
# the train step's ReLU inputs are at least this far from their kinks
KINK_MARGIN = 1e-5
# the flags of tests/test_entry_points.py::test_train_fnet_end_to_end
ENTRY_FLAGS = [
    "--exp_name", "f", "--visible_gpus", "0", "--FNET_feature_dim", "16",
    "--FNET_num_depth_bins", "8", "--MAGNET_window_radius", "4",
    "--MAGNET_num_source_views", "2", "--n_epochs", "1", "--batch_size",
    "2", "--validate_every", "1000000", "--visualize_every", "1000000",
    "--lr", "1e-4", "--dpv_height", "16", "--dpv_width", "16",
    "--dataset_name", "synthetic", "--dataset_path", "/tmp/none",
    "--input_height", "64", "--input_width", "64", "--min_depth", "1e-3",
    "--max_depth", "10.0", "--synthetic_length", "4", "--workers", "1",
    "--log_every", "1"]


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    cv = rng.rand(2, 5, 6, D).astype(np.float32)
    cv /= cv.sum(-1, keepdims=True)
    dc = sid_depth_centers(MIN_DEPTH, MAX_DEPTH, D)
    gt = rng.uniform(0.0, 12.0, (2, 5, 6)).astype(np.float32)
    mask = gt > 1.0
    want_depth = np.asarray(jlosses.soft_argmax_depth(cv, dc))
    depth = losses.soft_argmax_depth(torch.from_numpy(cv),
                                     torch.from_numpy(dc)).numpy()
    np.testing.assert_allclose(depth, want_depth, rtol=1e-6)
    want = float(jlosses.fnet_l1_loss(want_depth, gt, mask))
    got = float(losses.fnet_l1_loss(torch.from_numpy(depth),
                                    torch.from_numpy(gt),
                                    torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("T", [1, 3, 10, 1000])
def test_schedules_match_optax(T):
    peak = 3.57e-4
    n = range(T + 3)
    jlr, jb1 = joptim.onecycle(peak, T), joptim.onecycle_beta1(T)
    want_lr, want_b1 = ([float(f(i)) for i in n] for f in (jlr, jb1))
    lr, b1 = optim.onecycle(peak, T), optim.onecycle_beta1(T)
    assert np.isfinite(want_lr).all()
    np.testing.assert_allclose([lr(i) for i in n], want_lr, rtol=0,
                               atol=1e-6 * peak)
    np.testing.assert_allclose([b1(i) for i in n], want_b1, rtol=0,
                               atol=1e-6)


def test_optimizer_matches_optax_chain():
    """Pre-clip, global clip, AdamW with both schedules, 5 steps on a
    random parameter tree; step 2's gradient has an element past the
    pre-clip and steps 1-2 pass the global clip."""
    rng = np.random.RandomState(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()}
             for scale in (0.01, 3.0, 10.0, 0.05, 0.2)]
    grads[2]["a"][0, 0] = 5e6
    tx = joptim.make_fnet_optimizer(params, lr=1e-2, total_steps=10)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = optim.make_fnet_optimizer(tp.values(), lr=1e-2, total_steps=10)
    for g in grads:
        upd, opt_state = update({k: jnp.asarray(v) for k, v in g.items()},
                                opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert opt.count == 5


class _Indices:
    """A dataset whose items are their own index."""

    def __len__(self):
        return 11

    def get(self, idx, rng=None):
        return {"idx": np.array(idx)}


def test_loader_train_indices_match_jax():
    mine = base.Loader(_Indices(), batch_size=3, train=True, seed=4)
    theirs = jbase.Loader(_Indices(), batch_size=3, train=True, seed=4,
                          num_workers=1)
    assert len(mine) == len(theirs) == 3
    for _ in range(2):
        got = [b["idx"].tolist() for b in mine]
        assert got == [b["idx"].tolist() for b in theirs]
        assert all(len(b) == 3 for b in got)
    # evaluation: batch 1, in order, as before
    assert [int(b["idx"][0]) for b in base.Loader(_Indices())] == list(
        range(11))


# ---- one F-Net train step against the JAX package ----------------------

def _args(extra=()):
    return config.parse_args(config.build_train_fnet_parser(), [
        "--exp_name", "t", "--exp_dir", "unused", "--dataset_name",
        "synthetic", "--dataset_path", "none", "--input_height", str(H),
        "--input_width", str(W), "--dpv_height", str(H // 4), "--dpv_width",
        str(W // 4), "--MAGNET_num_source_views", str(V), "--device", "cpu",
        "--batch_size", str(B)] + list(extra))


@pytest.fixture(scope="module")
def jax_inputs():
    """Weights and batch of the step comparisons, at a well-conditioned
    point (see the module note)."""
    ds = SyntheticMultiView(_args())
    raw = base.collate([ds.get(i) for i in range(B)])
    batch = {k: v.numpy() for k, v in train_fnet.batch_to_device(
        raw, (H // 4, W // 4), torch.device("cpu")).items()}
    # A colour offset per frame: at this size every SPP branch pools
    # the whole map, and frames alike in the mean make its BatchNorm
    # variance a cancellation that neither side computes to f32.
    rng = np.random.RandomState(5)
    for k, n in (("ref_img", (B,)), ("src_imgs", (B, V))):
        batch[k] = batch[k] + (1.5 * rng.randn(*n, 1, 1, 3)).astype(
            np.float32)
    dc = sid_depth_centers(MIN_DEPTH, MAX_DEPTH, D)
    jm = JMagnetF(fnet_feature_dim=FEAT)
    order = ("ref_img", "src_imgs", "R", "t", "is_valid", "intM",
             "rays2d")
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        *[jax.ShapeDtypeStruct(batch[k].shape, jnp.float32)
          for k in order], jax.ShapeDtypeStruct(dc.shape, jnp.float32))
    variables = jax.tree.map(np.asarray, _random_variables(shapes, 3))
    psm = variables["params"]["f_net"]["f_net"]
    # matching costs of O(1), so that the softmax passes a gradient
    psm["lastconv1"]["kernel"] = psm["lastconv1"]["kernel"] * 0.25
    # Every ReLU input clear of the kink (see the module note): the
    # BatchNorms before ReLUs put it at 6 standard deviations.
    for name, mod in psm.items():
        bns = [mod["bn"]] if "bn" in mod else (
            [mod["convbn1"]["bn"]] if "convbn1" in mod else [])
        for bn in bns:
            bn["bn"]["bias"] = np.full_like(bn["bn"]["bias"], 3.0)
            bn["bn"]["scale"] = np.full_like(bn["bn"]["scale"], 0.5)
    # Zero-mean kernels: a conv after a ReLU then does not turn the
    # ReLU's offset into a channel mean far above the channel's spread,
    # which would make the variance E[x^2] - E[x]^2 a cancellation.
    for path, leaf in jax.tree_util.tree_leaves_with_path(psm):
        if path[-1].key == "kernel":
            leaf -= leaf.mean(axis=(0, 1, 2), keepdims=True)
    return dict(variables=variables, batch=batch, dc=dc, model=jm)


def _jax_step(inputs, compute_dtype):
    """JAX's loss, gradients and post-step batch_stats from one compiled
    ``make_fnet_train_step`` in ``compute_dtype``, the sweep backward by
    autodiff."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MAGNET_TPU_SWEEP_BWD", "xla")
    try:
        # JAX's own step with a transformation that keeps the gradients
        # in its state and leaves the parameters as they are
        keep = optax.GradientTransformation(
            lambda p: optax.EmptyState(),
            lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
        step = jsteps.make_fnet_train_step(inputs["model"], keep,
                                           inputs["dc"], MAX_DEPTH,
                                           MIN_DEPTH, compute_dtype)
        state = jsteps.TrainState.create(
            jax.tree.map(jnp.asarray, inputs["variables"]), keep)
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in inputs["batch"].items()})
    finally:
        mp.undo()
    return dict(inputs, loss=float(m["loss"]),
                grads=jax.tree.map(np.asarray, state.opt_state),
                new_stats=jax.tree.map(np.asarray, state.batch_stats))


@pytest.fixture(scope="module")
def step_case(jax_inputs):
    return _jax_step(jax_inputs, jnp.float32)


def _port_state_dict(variables):
    """JAX MagnetF variables -> the port's MagnetF state_dict."""
    sub = {c: variables[c]["f_net"] for c in variables}
    return {"f_net." + k: v for k, v in fnet_state_dict(sub).items()}


def _port_step(c, compute_dtype):
    """The port's step from JAX's weights and batch: the model (its .grad
    the clipped gradients, its buffers the post-step statistics) and the
    step's outputs."""
    model = MagnetF(FEAT)
    model.load_state_dict(_port_state_dict(c["variables"]))
    opt = optim.make_fnet_optimizer(model.parameters(), 1e-4, 10)
    step = steps.make_fnet_train_step(torch.from_numpy(c["dc"]), MAX_DEPTH,
                                      MIN_DEPTH, compute_dtype)
    state, m = step(steps.TrainState(model, opt),
                    {k: torch.from_numpy(v) for k, v in c["batch"].items()})
    assert state.step == 1 and opt.count == 1
    return model, m


def _clipped_grads(c, model):
    """JAX's gradients after the global clip, under the port's names."""
    flat = [np.asarray(g) for g in jax.tree.leaves(c["grads"])]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in flat))
    want = _port_state_dict({"params": jax.tree.map(
        lambda g: g * min(1.0, 1.0 / norm), c["grads"])})
    named = dict(model.named_parameters())
    assert set(named) == {k for k in want if "running" not in k
                          and "num_batches" not in k}
    return {k: (p.grad.numpy(), want[k].numpy()) for k, p in named.items()}


def _running_stats(c, model):
    """(port, JAX) running buffers after the step, under the port's names."""
    stats = _port_state_dict({"batch_stats": c["new_stats"]})
    buffers = dict(model.named_buffers())
    assert sum("running" in k for k in stats) == 2 * sum(
        isinstance(mod, torch.nn.BatchNorm2d) for mod in model.modules())
    return {k: (buffers[k].numpy(), v.numpy()) for k, v in stats.items()
            if "running" in k}


def test_fnet_train_step_matches_jax(step_case, monkeypatch):
    relu, margin = torch.nn.functional.relu, []

    def recorded(x, *a, **k):
        margin.append(x.detach().abs().min().item())
        return relu(x, *a, **k)
    monkeypatch.setattr(torch.nn.functional, "relu", recorded)
    model, m = _port_step(step_case, torch.float32)
    assert len(margin) == 3 + 25 + 4 + 1 and min(margin) > KINK_MARGIN
    np.testing.assert_allclose(float(m["loss"]), step_case["loss"],
                               rtol=1e-5)
    for k, (got, want) in _clipped_grads(step_case, model).items():
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)
    for k, (got, want) in _running_stats(step_case, model).items():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_fnet_bf16_train_step_near_f32(jax_inputs):
    """The protocol's bf16 step (bf16 images, weights, features and
    BatchNorm scale and bias; f32 statistics, geometry and master weights)
    against the f32 step from the same weights and batch. bf16 rounds every
    activation to 8 bits through 33 layers, so the limits are bf16's: loss
    2e-3 relative, every gradient 0.3 * max|g| of its tensor and the median
    tensor 0.035, running statistics 8e-3 of |v| + 1 (measured 4.5e-6,
    0.10, 0.019, 3.7e-3). The casts that round too little to move these limits
    (one BatchNorm's scale and bias) are held exactly in
    ``test_train_batch_norm_bf16_matches_jax``."""
    ref, ref_m = _port_step(jax_inputs, torch.float32)
    model, m = _port_step(jax_inputs, torch.bfloat16)
    loss_ref = float(ref_m["loss"])
    np.testing.assert_allclose(float(m["loss"]), loss_ref, rtol=2e-3)
    ref_grads = dict(ref.named_parameters())
    errs = {k: float((p.grad - ref_grads[k].grad).abs().max()
                     / ref_grads[k].grad.abs().max())
            for k, p in model.named_parameters()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.3, (worst, errs[worst])
    assert np.median(list(errs.values())) <= 0.035
    ref_stats = dict(ref.named_buffers())
    for k, v in model.named_buffers():
        if "running" in k:
            err = float(((v - ref_stats[k]).abs()
                         / (ref_stats[k].abs() + 1.0)).max())
            assert err <= 8e-3, (k, err)


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of ``want``."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got - want) / ulp


def test_train_batch_norm_bf16_matches_jax():
    """One train-mode BatchNorm on bf16 activations against the JAX
    package's (``nn/layers.py::BatchNorm``, its parameters cast to bf16 by
    ``cast_floating`` as the train step casts them): the output, the
    gradients of the input and of the f32 scale and bias, and the running
    statistics. Both compute in f32 from the same bf16 values and round
    once, so the bf16 tensors are equal on all but 1 % of their elements
    (an f32 sum in another order may round the other way) and within one
    ulp on all; the statistics to rtol 1e-5. Control: the same BatchNorm
    with its scale and bias left in f32 differs on more than 1 %."""
    from magnet_tpu.core.dtypes import cast_floating
    from magnet_tpu.nn.layers import BatchNorm as JBatchNorm
    from magnet_tpu_torch.nn.layers import batch_norm_train

    rng = np.random.RandomState(11)
    n, h, w, ch = 4, 6, 7, 32
    x = (rng.randn(n, h, w, ch) * 2.0 + 0.7).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    cot = np.array(jnp.asarray(rng.randn(n, h, w, ch), jnp.bfloat16)
                   .astype(jnp.float32))
    params = {"bn": {"scale": (rng.rand(ch) + 0.5).astype(np.float32),
                     "bias": rng.randn(ch).astype(np.float32)}}
    stats = {"bn": {"mean": rng.randn(ch).astype(np.float32),
                    "var": (rng.rand(ch) + 0.5).astype(np.float32)}}
    jbn = JBatchNorm()

    def jloss(p, xx):
        y, upd = jbn.apply({"params": cast_floating(p, jnp.bfloat16),
                            "batch_stats": stats}, xx, train=True,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd)

    (_, (jy, jupd)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params,
                                             jnp.asarray(x, jnp.bfloat16))

    def port(rounded):
        bn = torch.nn.BatchNorm2d(ch)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(params["bn"]["scale"]))
            bn.bias.copy_(torch.from_numpy(params["bn"]["bias"]))
            bn.running_mean.copy_(torch.from_numpy(stats["bn"]["mean"]))
            bn.running_var.copy_(torch.from_numpy(stats["bn"]["var"]))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(
            torch.bfloat16).requires_grad_()
        if rounded:
            y = batch_norm_train(xt, bn)
        else:
            xf = xt.float()
            mean = xf.mean((0, 2, 3))
            var = (xf * xf).mean((0, 2, 3)) - mean * mean
            y = ((xf - mean[:, None, None])
                 * (torch.rsqrt(var + bn.eps) * bn.weight)[:, None, None]
                 + bn.bias[:, None, None]).to(torch.bfloat16)
        (y.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum(
            ).backward()
        return [y.detach().float().permute(0, 2, 3, 1).numpy(),
                xt.grad.float().permute(0, 2, 3, 1).numpy(),
                bn.weight.grad.numpy(), bn.bias.grad.numpy()], bn

    want = [np.asarray(t, np.float32) for t in
            (jy, jgx, jgp["bn"]["scale"], jgp["bn"]["bias"])]
    got, bn = port(rounded=True)
    for name, g, wt in zip(("output", "input grad", "scale grad",
                            "bias grad"), got, want):
        ulps = _bf16_ulps(g, wt)
        assert ulps.max() <= 1.0 and (ulps > 0).mean() <= 0.01, name
    for mine, theirs in ((bn.running_mean, jupd["batch_stats"]["bn"]["mean"]),
                         (bn.running_var, jupd["batch_stats"]["bn"]["var"])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-6)
    control, _ = port(rounded=False)
    assert max((_bf16_ulps(g, wt) > 0).mean()
               for g, wt in zip(control, want)) > 0.01


def test_checkpoint_resumes_the_schedule_exactly(tmp_path):
    """Save after 3 steps; 2 more steps from the restored state equal 2
    more steps of the run that was never interrupted."""
    def make():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3),
                                    torch.nn.BatchNorm2d(3))
        return steps.TrainState(model, optim.make_fnet_optimizer(
            model.parameters(), 1e-2, 6), seed=7)

    def advance(state, n):
        for i in range(n):
            torch.manual_seed(100 + state.step)
            state.model.train()
            loss = state.model(torch.randn(2, 2, 5, 5)).square().mean()
            state.optimizer.zero_grad()
            loss.backward()
            state.optimizer.step()
            state.step += 1

    run = make()
    advance(run, 3)
    path = checkpoint.save(str(tmp_path), run, 12)
    assert path.endswith("0000000012") and checkpoint.latest_step(
        str(tmp_path)) == 12
    advance(run, 2)
    resumed = checkpoint.restore(str(tmp_path), make())
    assert resumed.step == 3 and resumed.optimizer.count == 3
    advance(resumed, 2)
    for a, b in zip(run.model.state_dict().values(),
                    resumed.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(run.generator.get_state(),
                       resumed.generator.get_state())
    assert checkpoint.restore(path)["step"] == 3


@pytest.fixture(scope="module")
def fnet_run(tmp_path_factory):
    """One ``train_fnet`` run of the entry point at a tiny shape (two steps,
    a validation pass, the checkpoint ``<exp>/models/<step>/state.pt``), its
    standard output kept; the training and checkpoint tests share it."""
    exp = tmp_path_factory.mktemp("fnet")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = train_fnet.main(ENTRY_FLAGS + ["--exp_dir", str(exp),
                                             "--device", "cpu"])
    return dict(out, exp=exp, stdout=printed.getvalue())


def test_entry_point_trains_on_the_cpu(fnet_run):
    out, tmp_path = fnet_run, fnet_run["exp"]
    lines = re.findall(r"iter (\d+) loss (\S+)", fnet_run["stdout"])
    assert [int(i) for i, _ in lines] == [2, 4]
    assert all(np.isfinite(float(v)) for _, v in lines)
    acc = (tmp_path / "f" / "log" / "eval_acc.txt").read_text()
    assert "abs_rel" in acc and "total_iter: 4" in acc
    assert os.listdir(tmp_path / "f" / "models") == ["0000000004"]
    assert out["state"].step == 2 and len(out["losses"]) == 2


@pytest.mark.parametrize("form", ["parent", "step", "state.pt"])
def test_fnet_training_checkpoint_loads(fnet_run, form):
    """``--FNET_ckpt`` takes the checkpoint of the port's own ``train_fnet``
    (``MagnetF``'s keys, ``f_net.f_net.*``) in each of its three forms;
    every F-Net tensor is the trained one, bit for bit."""
    from test_torch_magnet import _args as magnet_args, _ckpt_path
    args = magnet_args(["--FNET_feature_dim", "16", "--FNET_ckpt",
                        _ckpt_path(fnet_run["ckpt"], form)])
    model = build.load_magnet_checkpoints(build.build_magnet(args), args)
    trained = fnet_run["state"].model.f_net.state_dict()
    loaded = model.f_net.state_dict()
    assert loaded.keys() == trained.keys()
    for k, v in trained.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_entry_point_loads_a_training_checkpoint(tmp_path, fnet_run):
    """``test_magnet`` evaluates with the F-Net of a ``train_fnet`` run."""
    from test_torch_magnet import SMALL
    m = test_magnet.main(
        ["--exp_name", "t", "--exp_dir", str(tmp_path), "--dataset_path",
         "none", "--synthetic_length", "1"] + SMALL +
        ["--FNET_feature_dim", "16", "--FNET_ckpt",
         os.path.dirname(fnet_run["ckpt"])])
    assert len(m) == 12 and all(np.isfinite(v) for v in m.values())


def test_unported_training_flags_raise(tmp_path):
    for extra in (["--loss_fn", "gaussian"], ["--mesh_shape", "4"],
                  ["--dataset_name", "scannet"]):
        with pytest.raises(ValueError, match="not ported"):
            train_fnet.main(ENTRY_FLAGS + ["--exp_dir", str(tmp_path),
                                           "--device", "cpu"] + extra)


def test_flags_the_port_does_not_read_are_rejected(tmp_path, capsys):
    """The JAX package's training flags that the port has no use for are
    not accepted and ignored: argparse rejects them."""
    for extra in (["--use_pallas", "False"], ["--param_dtype", "bfloat16"],
                  ["--cache_features"], ["--profile_dir", "p"],
                  ["--no_distributed"]):
        with pytest.raises(SystemExit):
            train_fnet.main(ENTRY_FLAGS + ["--exp_dir", str(tmp_path),
                                           "--device", "cpu"] + extra)
        assert "unrecognized arguments" in capsys.readouterr().err


def test_entry_point_runs_on_the_card_by_default(tmp_path):
    """Without ``--device`` the step runs on the card; where there is none
    it fails before training, never on the CPU."""
    args = config.parse_args(config.build_train_fnet_parser(),
                             ENTRY_FLAGS + ["--exp_dir", str(tmp_path)])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_fnet.main(ENTRY_FLAGS + ["--exp_dir", str(tmp_path)])


def test_reference_flag_file_parses():
    path = os.path.join(os.path.dirname(__file__), "..", "train_scripts",
                        "fnet", "scannet.txt")
    args = config.parse_args(config.build_train_fnet_parser(), [path])
    assert (args.input_height, args.input_width, args.batch_size) == (
        480, 640, 2)
    assert (args.dpv_height, args.dpv_width) == (120, 160)
    assert args.FNET_num_depth_bins == 80 and args.device == "cuda"
    assert args.compute_dtype == "bfloat16"


def test_remat_grads_match_baseline():
    """``--remat`` (each residual block under ``layers.remat``) changes no
    gradient and no BatchNorm buffer (the recomputation updates none): a
    tiny F-Net's train forward with and without it, bit for bit (the JAX
    package's tests/test_train.py:183)."""
    from magnet_tpu_torch.models.fnet import FNet

    img = torch.from_numpy(np.random.RandomState(3).rand(1, 32, 32, 3)
                           .astype(np.float32))
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = build.init_train_weights_(FNet(feature_dim=16, remat=remat))
        model.train()(img).square().mean().backward()
        runs.append(model)
    base, rem = ({k: p.grad for k, p in m.named_parameters()} for m in runs)
    assert base.keys() == rem.keys() and len(base) > 100
    for k, g in base.items():
        assert torch.equal(g, rem[k]), k
    for (k, a), b in zip(runs[0].state_dict().items(),
                         runs[1].state_dict().values()):
        assert torch.equal(a, b), k


def test_magnet_training_and_streaming_entry_points_on_the_cpu(
        tmp_path, fnet_run, capsys):
    """Stage 3 through ``train_magnet`` at a tiny shape, its F-Net from
    ``fnet_run``'s checkpoint, then ``test_magnet --cache_features`` with
    it: a finite loss and metrics, a checkpoint of the step that holds
    G-Net, and the cache's line (every frame of a synthetic sample is its
    own, so all misses). ``train_dnet`` runs on the card (``chip_smoke.py``
    phase 12); its checkpoints load as ``test_dnet_training_checkpoint_
    loads`` holds them."""
    from magnet_tpu_torch import train_magnet

    small = ["--dataset_name", "synthetic", "--dataset_path", "none",
             "--device", "cpu", "--exp_dir", str(tmp_path),
             "--input_height", "32", "--input_width", "32", "--dpv_height",
             "8", "--dpv_width", "8", "--MAGNET_num_source_views", "2",
             "--FNET_feature_dim", "16", "--DNET_ckpt", "", "--FNET_ckpt",
             fnet_run["ckpt"], "--synthetic_length", "1"]
    m = train_magnet.main(small + [
        "--exp_name", "m", "--batch_size", "1", "--n_epochs", "1",
        "--validate_every", "1000000", "--MAGNET_num_train_iter", "1",
        "--MAGNET_num_test_iter", "1", "--loss_fn", "gaussian",
        "--compute_dtype", "float32"])
    assert len(m["losses"]) == 1 and np.isfinite(m["losses"]).all()
    assert all(np.isfinite(v) for v in m["metrics"].values())
    saved = checkpoint.restore(m["ckpt"])
    assert saved["step"] == 1 and any(k.startswith("g_net.")
                                      for k in saved["model"])
    capsys.readouterr()
    r = test_magnet.main(small + ["--exp_name", "s", "--MAGNET_ckpt", "",
                                  "--cache_features", "--cache_max_frames",
                                  "2"])
    assert len(r) == 12 and all(np.isfinite(v) for v in r.values())
    assert "feature cache: 0 hits / 3 misses" in capsys.readouterr().out
