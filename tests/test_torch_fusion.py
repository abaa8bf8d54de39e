"""The port's fusion kernels' plain versions and modules (magnet_tpu_torch)
against the JAX package, on the CPU: the cost volume, the G-Net update,
convex upsampling, and ``Magnet.fuse`` on random encodings.

Inputs are made with numpy from a seed and go through both packages in f32.
The JAX side runs as its own tests run it on the CPU: the XLA paths (the
reference semantics), and each Pallas kernel in interpret mode.

Tolerances: ``1e-4 * max|ref|`` (f32 sums in another order), as
tests/test_torch_kernels.py. The cost volume's consistency test is a hard
threshold, so its comparisons go through ``kernels.cost_volume_cw.compare``:
elements within 1e-4 (depth units) of the threshold are left out, at most
1 % of them, and the rest are held to the tolerance.
"""

import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magnet_tpu.kernels.costvolume_pallas import cost_volume_cw_pallas
from magnet_tpu.kernels.gnet_pallas import gnet_update_pallas
from magnet_tpu.kernels.upsample_pallas import upsample_via_mask_pallas
from magnet_tpu.models.magnet import Magnet as JMagnet
from magnet_tpu.nn.gnet import GNet as JGNet
from magnet_tpu.ops import upsample as jup
from magnet_tpu.ops.costvolume import _cost_volume_cw_xla
from magnet_tpu_torch.compat.from_jax import (_chain_state_dict,
                                              gnet_state_dict)
from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels import gnet_update as gk
from magnet_tpu_torch.kernels import upsample_mask as uk
from magnet_tpu_torch.models.magnet import (Magnet, gaussian_sampling_offsets,
                                            parse_weighting)
from magnet_tpu_torch.nn.gnet import GNet
from magnet_tpu_torch.ops import resample
from magnet_tpu_torch.ops.upsample import upsample_via_mask

from test_torch_kernels import (  # noqa: F401 (torch_threads)
    cv_inputs, gnet_inputs, upsample_inputs, torch_threads)

TOL = 1e-4
# the exact XLA cost volume as one compiled program (run op by op it takes
# seconds a call)
_cv_xla = jax.jit(_cost_volume_cw_xla, static_argnums=10)


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=TOL,
                               atol=TOL * float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _cv_check(args, jax_ref):
    out, margin = cvk.cost_volume_cw_ref(*[_t(a) for a in args], 5.0,
                                         return_margin=True)
    ref = _t(jax_ref)
    assert out.shape == ref.shape and ref.abs().max() > 0.1
    return cvk.compare(out, ref, margin, TOL)


@pytest.mark.parametrize("case", [
    dict(B=2, V=3),                                   # an invalid view
    dict(roll=0.3, H=40, W=64, invalid_last=False),
    dict(roll=0.6, W=64, invalid_last=False),
    dict(roll=0.9, H=40, W=64, invalid_last=False),
    dict(shift=0.6),                                  # samples leave the image
], ids=["small_pose", "roll03", "roll06", "roll09", "leaving"])
def test_cost_volume_matches_jax_xla(case):
    args = cv_inputs(**case)
    _cv_check(args, _cv_xla(*map(jnp.asarray, args), 5.0))


def test_cost_volume_matches_jax_xla_at_the_eval_shape():
    """The ScanNet eval shape: 120x160, 4 source views, 64 features (the
    one full-shape parity that is quick enough here, about 6 s)."""
    args = cv_inputs(B=1, V=4, H=120, W=160, C=64, invalid_last=False)
    _cv_check(args, _cv_xla(*map(jnp.asarray, args), 5.0))


def test_cost_volume_matches_jax_pallas_in_band():
    args = cv_inputs(B=1, V=2, seed=1)
    _cv_check(args, cost_volume_cw_pallas(*map(jnp.asarray, args), 5.0,
                                          interpret=True))


def test_cost_volume_all_outside_is_zero():
    args = cv_inputs(shift=100.0)
    out = cvk.cost_volume_cw_ref(*[_t(a) for a in args], 5.0)
    ref = np.asarray(_cv_xla(*map(jnp.asarray, args), 5.0))
    assert np.abs(ref).max() < 1e-5 and out.abs().max() < 1e-5


def test_cost_volume_bf16_rounds_mu_and_sigma():
    """bf16 matching sees bf16 mu and sigma, as the reference packs them."""
    a = [_t(x) for x in cv_inputs()]
    a16 = [a[0], a[1].bfloat16(), a[2].bfloat16()] + a[3:]
    rounded = a16[:3] + [a[3].bfloat16().float(), a[4].bfloat16().float()] \
        + a[5:]
    torch.testing.assert_close(cvk.cost_volume_cw_ref(*a16, 5.0),
                               cvk.cost_volume_cw_ref(*rounded, 5.0),
                               rtol=0, atol=0)


def test_bilinear_gather_matches_torch_grid_sample():
    """Pixel coordinates x = ((gx + 1) W - 1) / 2 of the normalised gx
    (align_corners=False)."""
    rng = np.random.RandomState(0)
    feat = _t(rng.randn(9, 11, 3).astype(np.float32))
    g = _t(rng.uniform(-1.3, 1.3, (2, 40, 2)).astype(np.float32))
    ref = torch.nn.functional.grid_sample(
        feat.permute(2, 0, 1)[None], g[None], mode="bilinear",
        padding_mode="zeros", align_corners=False)[0].permute(1, 2, 0)
    _close(resample.bilinear_gather(feat, ((g[..., 0] + 1) * 11 - 1) / 2,
                                    ((g[..., 1] + 1) * 9 - 1) / 2), ref)


def _jax_gnet(cv, feat, prev):
    jm = JGNet()
    x = np.zeros(cv.shape[:3] + (256,), np.float32)
    v = jm.init(jax.random.PRNGKey(0), cv, x, prev,
                method=lambda m, c, f, p: m(c, m.precompute_feature(f), p))
    rng = np.random.RandomState(5)
    p = jax.tree.map(lambda a: (rng.randn(*a.shape) * (
        0.1 if a.ndim == 1 else np.prod(a.shape[:3]) ** -0.5)
    ).astype(np.float32), jax.device_get(v["params"]))
    return jm, p


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["xla", "pallas"])
def test_gnet_update_matches_jax(monkeypatch, jax_kernel):
    """gnet_update_ref and the port's GNet (unsplit 261-channel first conv)
    against the JAX GNet module and its Pallas kernel."""
    cv, feat, prev, _ = gnet_inputs(H=16, W=12)
    jm, p = _jax_gnet(cv, feat, prev)
    if jax_kernel:
        ref = gnet_update_pallas(jnp.asarray(cv), jnp.asarray(feat),
                                 jnp.asarray(prev), p, interpret=True)
    else:
        monkeypatch.setenv("MAGNET_TPU_PALLAS_GNET", "0")
        ref = jm.apply({"params": p}, cv, feat, prev)
    convs = [(_t(p["conv0_cv"]["conv"]["kernel"]), None)] + [
        (_t(p[n]["conv"]["kernel"]), _t(p[n]["conv"]["bias"]))
        for n in ("conv1", "conv2", "conv3")]
    _close(gk.gnet_update_ref(_t(cv), _t(feat), _t(prev), convs), ref)
    gnet = GNet().eval()
    gnet.load_state_dict(gnet_state_dict(p))
    assert gnet.gnet[0].weight.shape == (128, 261, 3, 3)
    with torch.no_grad():
        _close(gnet(_t(cv), _t(feat), _t(prev)), ref)


def test_gnet_feature_term_matches_jax(monkeypatch):
    monkeypatch.setenv("MAGNET_TPU_PALLAS_HEADS", "0")
    cv, feat, prev, _ = gnet_inputs(H=8, W=8)
    jm, p = _jax_gnet(cv, feat, prev)
    x = np.random.RandomState(2).randn(1, 8, 8, 256).astype(np.float32)
    ref = jm.apply({"params": p}, x, method=JGNet.precompute_feature)
    gnet = GNet().eval()
    gnet.load_state_dict(gnet_state_dict(p))
    with torch.no_grad():
        _close(gnet.precompute_feature(_t(x)), ref)


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["xla", "pallas"])
def test_upsample_matches_jax(jax_kernel):
    d, m = upsample_inputs(B=2, H=8, W=6)
    if jax_kernel:
        ref = upsample_via_mask_pallas(jnp.asarray(d), jnp.asarray(m), 4,
                                       interpret=True)
    else:
        ref = jup.upsample_via_mask(jnp.asarray(d), jnp.asarray(m), 4)
    _close(uk.upsample_mask_ref(_t(d), _t(m), 4), ref)
    _close(upsample_via_mask(_t(d), _t(m), 4), ref)


def test_sampling_offsets_and_weighting():
    from magnet_tpu.models import magnet as jmag
    np.testing.assert_array_equal(gaussian_sampling_offsets(3.0, 5),
                                  jmag.gaussian_sampling_offsets(3.0, 5))
    assert parse_weighting("CW5") == jmag.parse_weighting("CW5") == 5.0
    with pytest.raises(ValueError):
        parse_weighting("W5")


def test_fuse_matches_jax(monkeypatch):
    """Magnet.fuse on random encodings: three iterations of sampling, cost
    volume and G-Net update, the mask head and three upsamplings."""
    for k in ("GNET", "HEADS", "CV"):
        monkeypatch.setenv(f"MAGNET_TPU_PALLAS_{k}", "0")
    B, V, H, W, F = 1, 2, 16, 24, 16
    dvol, ref_f, src_f, mu, sig, R, t, valid, K, rays = cv_inputs(
        B=B, V=V, H=H, W=W, C=F, seed=7, invalid_last=False)
    rng = np.random.RandomState(8)
    x_d3 = rng.randn(B, H, W, 256).astype(np.float32) * 0.5
    ref_g = np.stack([rng.uniform(2, 4, (B, H, W)),
                      rng.uniform(0.2, 0.5, (B, H, W))], -1).astype(np.float32)
    src_g = np.stack([mu, sig], -1)
    jm = JMagnet(fnet_feature_dim=F)
    enc = (ref_g, x_d3, ref_f, src_g, src_f, R, t, valid, K, rays)
    v = jax.eval_shape(functools.partial(jm.init, method=JMagnet.fuse),
                       jax.random.PRNGKey(0), *enc)
    p = jax.tree.map(lambda a: (rng.randn(*a.shape) * (
        0.1 if len(a.shape) == 1 else np.prod(a.shape[:3]) ** -0.5)
    ).astype(np.float32), v["params"])
    refs = jax.jit(functools.partial(jm.apply, method=JMagnet.fuse))(
        {"params": p}, *enc)
    model = Magnet(fnet_feature_dim=F).eval()
    sd = {"g_net." + k: w for k, w in gnet_state_dict(p["g_net"]).items()}
    sd.update(_chain_state_dict(p["mask_head"], "mask_head"))
    res = model.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith(("d_net.", "f_net.")) for k in res.missing_keys)
    with torch.no_grad():
        outs = model.fuse(*[_t(a) for a in enc])
    assert len(outs) == len(refs) == 3
    for out, ref in zip(outs, refs):
        assert out.shape == (B, 4 * H, 4 * W, 2)
        # a sample on the consistency threshold may flip and move its pixel
        # by a G-Net update: hold 99 % of the pixels to the tolerance
        err = np.abs(out.numpy() - np.asarray(ref))
        lim = TOL * float(np.abs(np.asarray(ref)).max())
        assert (err > lim).mean() < 0.01, (err.max(), lim)
