"""The port's D-Net (magnet_tpu_torch) against the JAX package, on the CPU.

One set of seeded random variables, shaped by the JAX DNet and filled with
numpy, goes through both packages: the JAX model as it stands (decoder
stages on their XLA paths), the port after ``compat.from_jax``. The outputs
are held to atol 2e-4, the tolerance tests/test_compat.py holds the JAX
D-Net to against the torch oracle (f32 sums in another order through the
B5 trunk). The variables are made once per file; JAX shapes them with
``eval_shape`` instead of running its slow eager init.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magnet_tpu.compat import torch_loader
from magnet_tpu.models.dnet import DNet as JDNet
from magnet_tpu.models.dnet import DNetCoarse as JDNetCoarse
from magnet_tpu_torch import test_dnet
from magnet_tpu_torch.compat.from_jax import dnet_state_dict
from magnet_tpu_torch.core import config
from magnet_tpu_torch.models import build
from magnet_tpu_torch.models.dnet import DNet, DNetCoarse

import torch_ref
from test_torch_kernels import torch_threads  # noqa: F401

SHAPE = (1, 96, 128, 3)
ATOL = 2e-4
SCANNET_FLAGS = str(Path(__file__).resolve().parents[1] / "test_scripts"
                    / "dnet" / "scannet.txt")


def _random_variables(shapes, seed=0):
    """numpy variables: fan-in scaled conv kernels (activations stay O(1)
    through the deep trunk), small biases, random positive BN statistics."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf, shape = names[-1], s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:3]))
            v = rng.randn(*shape) * fan_in ** -0.5
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "mean":
            v = rng.randn(*shape) * 0.5
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:                                   # conv and BN biases
            v = rng.randn(*shape) * (0.1 if names[-2] == "bn" else 0.02)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def case():
    x = np.random.RandomState(0).rand(*SHAPE).astype(np.float32)
    shapes = jax.eval_shape(JDNet().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(SHAPE, jnp.float32))
    variables = jax.tree.map(np.asarray, _random_variables(shapes))
    return x, variables, dnet_state_dict(variables)


@pytest.fixture
def xla_decoder(monkeypatch):
    """The JAX decoder stages on their XLA paths, as its parity tests run
    them on the CPU (the default would run the Pallas kernels in interpret
    mode, which the kernel tests cover)."""
    monkeypatch.setenv("MAGNET_TPU_PALLAS_UP", "0")
    monkeypatch.setenv("MAGNET_TPU_PALLAS_UP2", "0")


def test_dnet_matches_jax(case, xla_decoder):
    x, variables, sd = case
    ref = np.asarray(JDNet().apply(variables, x))
    model = DNet().eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == SHAPE[:3] + (2,)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_dnet_coarse_matches_jax(case, xla_decoder):
    """(mu, sigma) at 1/4 resolution and the 256-channel decoder feature."""
    x, variables, sd = case
    ref_g, ref_f = JDNetCoarse().apply(variables, x)
    model = DNetCoarse().eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        gauss, feat = model(torch.from_numpy(x))
    assert feat.shape == (1, 24, 32, 256)
    np.testing.assert_allclose(gauss.numpy(), np.asarray(ref_g), atol=ATOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_f), atol=ATOL)


def test_weights_round_trip_is_exact(case):
    """port state_dict -> the JAX package's own converter -> the original
    variables, bit for bit (keys, shapes and values)."""
    _, variables, sd = case
    model = DNet()
    model.load_state_dict(sd)
    back = torch_loader.convert_dnet(
        {k: v.numpy() for k, v in model.state_dict().items()}, variables)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)


def test_reference_checkpoint_loads_natively(tmp_path):
    """A checkpoint in the reference layout (the torch oracle's keys, wrapped
    in 'model' with DDP 'module.' prefixes) loads into the port with no
    conversion, and the port then computes what the oracle computes."""
    oracle = torch_ref.randomize_(torch_ref.DNET_T(dnet=True), seed=3)
    path = tmp_path / "dnet.pt"
    torch.save({"model": {"module." + k: v
                          for k, v in oracle.state_dict().items()}}, path)
    args = config.parse_args(config.build_test_dnet_parser(), [
        "@" + SCANNET_FLAGS, "--device", "cpu"])
    model = build.load_dnet_checkpoint(build.build_dnet(args), str(path))
    x = np.random.RandomState(0).rand(*SHAPE).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(x).permute(0, 3, 1, 2))
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               atol=ATOL)


def test_reference_flag_file_parses():
    args = config.parse_args(config.build_test_dnet_parser(),
                             [SCANNET_FLAGS])
    assert (args.input_height, args.input_width) == (480, 640)
    assert args.downsample_ratio == 4 and args.device == "cuda"
    assert args.compute_dtype == "bfloat16"


def test_entry_point_synthetic_cpu(tmp_path):
    m = test_dnet.main([
        "--exp_name", "t", "--exp_dir", str(tmp_path), "--output_dim", "2",
        "--output_type", "G", "--DNET_architecture", "DenseDepth_BN",
        "--dataset_name", "synthetic", "--dataset_path", "none",
        "--input_height", "64", "--input_width", "64", "--ckpt_path", "",
        "--synthetic_length", "2", "--device", "cpu"])
    assert len(m) == 12 and all(np.isfinite(v) for v in m.values())
    lines = (tmp_path / "t" / "log" / "test_acc.txt").read_text().split("\n")
    assert len(lines[2].split()) == 12


# ---- D-Net training (stage 1), each part against its JAX function ---------

def _module_of(named: dict) -> torch.nn.Module:
    """A module whose parameters are ``named`` (dotted names), copies."""
    root = torch.nn.Module()
    for name, value in named.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        mod.register_parameter(leaf, torch.nn.Parameter(value.clone()))
    return root


# leaves of the D-Net's variables that the optimizer test updates: encoder
# (the stem's BatchNorm, an MBConv block's squeeze-excitation) and the rest
# (a decoder BatchNorm, the depth head's last conv)
OPT_LEAVES = (("encoder", "bn1"), ("encoder", "blocks_1_0", "se"),
              ("up3", "bn_b"), ("depth_head", "conv2"))


def test_dnet_optimizer_matches_optax(case):
    """``make_dnet_optimizer`` against the JAX package's optax chain
    (``make_dnet_optimizer``), on leaves of the D-Net's variables under
    their own names (``OPT_LEAVES``), two steps, the second past the global
    clip, with the encoder trainable at lr / 10 and frozen (AdaBins_fix: no
    update, its gradients still in the clip's norm). Parameters to atol
    1e-6, as the F-Net's optimizer test holds them."""
    import optax
    from magnet_tpu.train import optim as joptim
    from magnet_tpu_torch.train import optim

    _, variables, _ = case
    d = variables["params"]["d_net"]
    params = {"d_net": {}}
    for path in OPT_LEAVES:
        src, dst = d, params["d_net"]
        for name in path[:-1]:
            src, dst = src[name], dst.setdefault(name, {})
        dst[path[-1]] = src[path[-1]]
    grads = [jax.tree.map(lambda p, a=a, b=b: (a * p + b).astype(np.float32),
                          params) for a, b in ((1e-3, 1e-4), (2.0, -0.1))]
    for freeze in (False, True):
        tx = joptim.make_dnet_optimizer(params, lr=1e-3, total_steps=10,
                                        freeze_encoder=freeze)
        jp, opt_state, update = params, tx.init(params), jax.jit(tx.update)
        start = {k: v for k, v in dnet_state_dict({"params": params}).items()
                 if v.is_floating_point()}
        model = _module_of(start)
        opt = optim.make_dnet_optimizer(model, lr=1e-3, total_steps=10,
                                        freeze_encoder=freeze)
        named = dict(model.named_parameters())
        for g in grads:
            upd, opt_state = update(g, opt_state, jp)
            jp = optax.apply_updates(jp, upd)
            tg = dnet_state_dict({"params": g})
            for k, p in named.items():
                p.grad = tg[k].clone()
            opt.step()
        want = dnet_state_dict({"params": jax.tree.map(np.asarray, jp)})
        assert sum(".encoder." in k for k in named) == 6 and len(named) == 10
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
            moved = not torch.equal(p.detach(), start[k])
            assert moved != (freeze and ".encoder." in k), k


def test_upsample_bn_train_matches_jax():
    """A decoder stage in train mode (a kernel width, 256 features, yet plain
    convs and batch statistics, as the JAX package gates its kernel ``not
    train``) against JAX ``UpSampleBN(train=True)``: the output and the new
    running statistics to 1e-5 of their largest element, the parameters'
    gradients to 1e-5 of the stage's largest gradient (f32 sums in another
    order; the conv biases before a train BatchNorm have a gradient of 0 up
    to that rounding on both sides)."""
    from magnet_tpu.nn.densedepth import UpSampleBN as JUpSampleBN
    from magnet_tpu_torch.nn.densedepth import UpSampleBN

    rng = np.random.RandomState(9)
    x = rng.randn(2, 4, 5, 16).astype(np.float32)
    skip = rng.randn(2, 8, 10, 8).astype(np.float32)
    cot = rng.randn(2, 8, 10, 256).astype(np.float32)
    jm = JUpSampleBN(features=256)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, skip)
    variables = jax.tree.map(np.asarray, _random_variables(shapes, seed=4))

    def loss(p):
        y, upd = jm.apply({"params": p,
                           "batch_stats": variables["batch_stats"]}, x, skip,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (jy, jstats)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    def port_keys(tree):
        return {k[len("d_net.decoder.up1."):]: v for k, v in dnet_state_dict(
            {c: {"d_net": {"up1": t}} for c, t in tree.items()}).items()}

    stage = UpSampleBN(16 + 8, 256).train()
    stage.load_state_dict(port_keys(variables))
    y = stage(torch.from_numpy(x), torch.from_numpy(skip))
    (y * torch.from_numpy(cot)).sum().backward()
    want = [("output", y.detach(), jy)] + [
        (k, stage.state_dict()[k], v) for k, v in port_keys(
            {"batch_stats": jax.tree.map(np.asarray, jstats)}).items()
        if "running" in k] + [
        (k + " grad", p.grad, port_keys({"params": jax.tree.map(
            np.asarray, jg)})[k]) for k, p in stage.named_parameters()]
    assert len(want) == 1 + 4 + 8
    grad_max = max(np.abs(np.asarray(r)).max() for n, _, r in want
                   if n.endswith("grad"))
    for name, got, ref in want:
        ref = np.asarray(ref)
        scale = grad_max if name.endswith("grad") else np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_drop_path_given_a_mask_matches_jax(dtype):
    """Stochastic depth with the JAX package's mask: the same values in the
    same dtype, bit for bit; the port's masks are 0 or 1, one a sample, and
    the same generator state draws the same mask."""
    from magnet_tpu.nn.layers import drop_path as jdrop_path
    from magnet_tpu_torch.nn.layers import drop_path, drop_path_mask

    rate, key = 0.3, jax.random.PRNGKey(5)
    x = np.random.RandomState(1).randn(8, 3, 4, 5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jdrop_path(jnp.asarray(x, jdt), rate, False, key)
    mask = jax.random.bernoulli(key, 1 - rate, (8, 1, 1, 1))
    got = drop_path(torch.from_numpy(x).to(dtype),
                    torch.from_numpy(np.asarray(mask, np.float32)), rate)
    assert got.dtype == dtype
    assert torch.equal(got.float(), torch.from_numpy(
        np.asarray(want.astype(jnp.float32))))
    g = torch.Generator().manual_seed(3)
    m = drop_path_mask(64, rate, g)
    assert m.shape == (64, 1, 1, 1) and set(m.unique().tolist()) <= {0., 1.}
    assert torch.equal(m, drop_path_mask(64, rate,
                                         torch.Generator().manual_seed(3)))


@pytest.fixture(scope="module")
def flax_dnet():
    """A D-Net with flax's initialisation (``build.init_flax_weights_``);
    the test that trains it goes last."""
    return build.init_flax_weights_(DNet(), seed=0)


def test_encoder_start_loads_exactly(tmp_path, flax_dnet):
    """``--encoder_ckpt`` (a torch.hub tf_efficientnet_b5_ap state dict,
    with its classifier) and AdaBins_fix's file (``original_model.*``) load
    into ``d_net.encoder.*`` exactly and leave the decoder; a misnamed key
    raises."""
    from magnet_tpu_torch.compat import encoder

    enc = {k: v.clone() for k, v in
           flax_dnet.d_net.encoder.original_model.state_dict().items()}
    hub = dict(enc, **{"classifier.weight": torch.zeros(1000, 2048)})
    torch.save(hub, tmp_path / "hub.pt")
    torch.save({"model": {"module.original_model." + k: v
                          for k, v in enc.items()}}, tmp_path / "ada.pt")
    model = DNet()
    decoder = {k: v.clone() for k, v in
               model.d_net.decoder.state_dict().items()}
    target = model.d_net.encoder.original_model
    for load, name in ((encoder.load_hub_encoder, "hub.pt"),
                       (encoder.load_adabins_encoder, "ada.pt")):
        with torch.no_grad():
            for v in target.state_dict().values():
                v.zero_()
        load(model, str(tmp_path / name))
        for k, v in target.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, enc[k]), k
        for k, v in model.d_net.decoder.state_dict().items():
            assert torch.equal(v, decoder[k]), k
    bad = dict(hub)
    bad["blocks.1.0.conv_pw.weigth"] = bad.pop("blocks.1.0.conv_pw.weight")
    with pytest.raises(KeyError, match="conv_pw.weight"):
        encoder.load_encoder(model, bad)


def test_dnet_train_loss_falls(flax_dnet):
    """Three port steps on one batch at 32x32 (the JAX package's
    tests/test_train.py recipe: flax's initialisation, lr 5e-3, the encoder
    at the same rate; a one-cycle of 4 steps, so that steps 2 and 3 run
    near the peak rate: at a longer cycle the rate stays near lr / 25 and
    the drop-path masks move the loss more than three steps do) lower the
    loss; train BatchNorm moves the buffers."""
    from magnet_tpu_torch.train import optim, steps

    model = flax_dnet.train()
    rng = np.random.RandomState(0)
    batch = {"img": torch.from_numpy(rng.rand(2, 32, 32, 3).astype(
        np.float32)), "depth": torch.from_numpy(rng.uniform(
            1, 5, (2, 32, 32)).astype(np.float32))}
    opt = optim.make_dnet_optimizer(model, lr=5e-3, total_steps=4,
                                    same_lr=True)
    state = steps.TrainState(model, opt, seed=0)
    step = steps.make_dnet_train_step(max_depth=10.0, min_depth=1e-3)
    stem_mean = model.d_net.encoder.original_model.bn1.running_mean.clone()
    hist = [float(step(state, batch)[1]["loss"]) for _ in range(3)]
    assert np.isfinite(hist).all() and hist[2] < hist[0], hist
    assert state.step == 3 and opt.count == 3
    assert not torch.equal(
        model.d_net.encoder.original_model.bn1.running_mean, stem_mean)
