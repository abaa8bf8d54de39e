"""The port's one-launch PSM-Net BasicBlock (kernels/res_block.py), its
switch in the F-Net (``PSMNet(stream_blocks=True)``) and the KITTI
configuration of the MaGNet entry point, against the JAX package.

CPU: the plain version is held against the Pallas kernel it replaces
(``resblock_stream``, interpret mode) on the same seeded numpy inputs; the
port's PSM-Net with the switch on against the JAX PSM-Net on its XLA path
(``MAGNET_TPU_PALLAS_PSM=0``), weights through compat/from_jax.py. f32,
rtol 1e-4 and atol 1e-4 * max|ref| (f32 sums in another order). The KITTI
flag file parses, and the entry point runs it on the CPU at a tiny shape with
all three switches, equal to the same run without them to 1e-5 of the
output's largest value.

CUDA (marker ``cuda``, skipped without a card): the kernel against its plain
version on the card, f32 at 1e-4 * max|ref| and bf16 at 2e-2 * max|ref|, at
the KITTI layer shapes and at sizes that are not tile multiples; the launch
count; a CUDA tensor never reaches the plain version; what the wrapper
refuses. These import no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_resblock.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from magnet_tpu_torch import test_magnet
from magnet_tpu_torch.core import config
from magnet_tpu_torch.kernels import psm_blocks as pb
from magnet_tpu_torch.kernels import res_block as rb
from magnet_tpu_torch.nn import psmnet

RTOL = 1e-4
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
KITTI_FLAGS = str(Path(__file__).resolve().parents[1] / "test_scripts"
                  / "magnet" / "kitti_eigen.txt")
SWITCHES = ["--stream_blocks", "--mbconv_chain", "all", "--dw_kernel"]


def _close(out, ref, tol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=RTOL,
                               atol=tol * float(np.abs(ref).max()))


def block_inputs(C=32, N=2, H=8, W=16, seed=0):
    """numpy (x, w1, s1, t1, w2, s2, t2): HWIO weights, folded BN."""
    rng = np.random.RandomState(seed)
    out = [(rng.randn(N, H, W, C) * 0.5).astype(np.float32)]
    for _ in range(2):
        out += [(rng.randn(3, 3, C, C) * (9 * C) ** -0.5).astype(np.float32),
                (rng.rand(C) + 0.5).astype(np.float32),
                (rng.randn(C) * 0.1).astype(np.float32)]
    return out


@pytest.mark.parametrize("C,dil", [(32, 1), (128, 2)], ids=["d1", "d2"])
def test_res_block_ref_matches_jax_kernel(C, dil):
    from magnet_tpu.kernels.resstream_pallas import resblock_stream
    a = block_inputs(C)
    ref = resblock_stream(*a, dilation=dil, interpret=True)
    out = rb.res_block(*[torch.from_numpy(v) for v in a], dil)
    _close(out.numpy(), ref)


def test_res_block_ref_is_the_chain_of_two_convs():
    """The plain block equals one BasicBlock of the chain it replaces."""
    a = [torch.from_numpy(v) for v in block_inputs(64, H=6, W=9, seed=3)]
    stage = pb.fused_residual_stage_ref(
        a[0], torch.stack([a[1], a[4]]), torch.stack([a[2], a[5]]),
        torch.stack([a[3], a[6]]), 2)
    assert torch.equal(rb.res_block(*a, 2), stage)


def test_psmnet_stream_blocks_matches_jax(monkeypatch):
    """PSM-Net with every stride-1 BasicBlock of layer1-4 through the block
    (23 of them, the plain version on the CPU) against the JAX PSM-Net on
    its XLA path at 32x64."""
    import jax
    import jax.numpy as jnp
    from magnet_tpu.models.fnet import FNet as JFNet
    from magnet_tpu_torch.compat.from_jax import fnet_state_dict
    from magnet_tpu_torch.models.fnet import FNet
    from test_torch_dnet import _random_variables
    monkeypatch.setenv("MAGNET_TPU_PALLAS_PSM", "0")
    x = np.random.RandomState(0).rand(1, 32, 64, 3).astype(np.float32)
    jm = JFNet()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    variables = jax.tree.map(np.asarray, _random_variables(shapes, seed=4))
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    model = FNet(stream_blocks=True).eval()
    assert isinstance(model.f_net, psmnet.PSMNet) and model.f_net.stream_blocks
    model.load_state_dict(fnet_state_dict(variables))
    calls = []
    block = psmnet.res_block
    monkeypatch.setattr(psmnet, "res_block",
                        lambda *a: calls.append(a[0].shape) or block(*a))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert [s[-1] for s in calls] == [32] * 3 + [64] * 15 + [128] * 5
    _close(out, ref)


def test_kitti_flag_file_parses():
    args = config.parse_args(config.build_test_magnet_parser(), [KITTI_FLAGS])
    assert (args.input_height, args.input_width) == (352, 1216)
    assert (args.dpv_height, args.dpv_width) == (88, 304)
    assert args.MAGNET_num_source_views == 2 and args.MAGNET_num_samples == 5
    assert args.MAGNET_num_test_iter == 3 and args.max_depth == 80.0
    assert args.garg_crop and not args.stream_blocks and not args.dw_kernel
    assert args.mbconv_chain == "none" and args.device == "cuda"


def test_kitti_entry_point_cpu_with_the_switches(tmp_path, monkeypatch):
    """The KITTI flag file at a tiny KITTI-like shape (32x96, cost volume
    8x24, V = 2) on the CPU with the three switches: it writes its metrics,
    and its forward equals the same forward without them."""
    tiny = ["--input_height", "32", "--input_width", "96", "--dpv_height",
            "8", "--dpv_width", "24", "--dataset_name", "synthetic",
            "--dataset_path", "none", "--DNET_ckpt", "", "--FNET_ckpt", "",
            "--MAGNET_ckpt", "", "--device", "cpu", "--compute_dtype",
            "float32", "--synthetic_length", "1", "--exp_dir", str(tmp_path)]
    outs = []
    make_forward = test_magnet.make_forward

    def recorded(*a):
        forward = make_forward(*a)
        return lambda batch: outs.append(forward(batch)) or outs[-1]

    monkeypatch.setattr(test_magnet, "make_forward", recorded)
    for name, extra in (("on", SWITCHES), ("off", [])):
        m = test_magnet.main(["@" + KITTI_FLAGS] + tiny + extra
                             + ["--exp_name", name])
        assert len(m) == 12 and all(np.isfinite(v) for v in m.values())
    log = tmp_path / "on" / "log"
    assert len((log / "test_acc.txt").read_text().split("\n")[2].split()) == 12
    assert "stream_blocks: True" in (log / "params.txt").read_text()
    assert len(outs) == 2 and outs[0].shape == (1, 32, 96, 2)
    _close(outs[0], outs[1], 1e-5)


def test_cpu_tensors_take_the_plain_version():
    before = rb.res_block.launches
    a = [torch.from_numpy(v) for v in block_inputs(H=5, W=3)]
    _close(rb.res_block(*a, 2).numpy(), rb.res_block_ref(*a, 2).numpy())
    assert rb.res_block.launches == before


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(arrays, device, dtype):
    """x and the weights in ``dtype``, the folded BN f32."""
    return [torch.from_numpy(a).to(device, dtype if i in (0, 1, 4)
                                   else torch.float32)
            for i, a in enumerate(arrays)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,dil", [
    (dict(C=32, N=1, H=176, W=608), 1), (dict(C=64, N=2, H=88, W=304), 1),
    (dict(C=128, N=1, H=88, W=304), 1), (dict(C=128, N=1, H=88, W=304), 2),
    (dict(C=32, N=2, H=11, W=38), 1), (dict(C=64, N=1, H=5, W=7), 2),
    (dict(C=128, N=1, H=22, W=19), 2), (dict(C=24, N=1, H=9, W=17), 1)],
    ids=["layer1", "layer2", "layer3", "layer4", "ragged32", "ragged64_d2",
         "ragged128_d2", "c24"])
def test_res_block_kernel_matches_plain(cuda, dtype, case, dil):
    a = _on(block_inputs(**case), cuda, dtype)
    before = rb.res_block.launches
    out = rb.res_block(*a, dil)
    assert rb.res_block.launches == before + 1
    ref = rb.res_block_ref(*a, dil)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(rb, "res_block_ref", refuse)
    monkeypatch.setattr(rb, "_conv_ref", refuse)
    rb.res_block(*_on(block_inputs(), cuda, torch.bfloat16), 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    bf = torch.bfloat16
    a = _on(block_inputs(), cuda, bf)
    with pytest.raises(ValueError):                            # mixed dtype
        rb.res_block(a[0].float(), *a[1:], 1)
    with pytest.raises(ValueError):                            # strided
        rb.res_block(a[0].transpose(1, 2), *a[1:], 1)
    with pytest.raises(ValueError):                            # scale bf16
        rb.res_block(*a[:2], a[2].to(bf), *a[3:], 1)
    with pytest.raises(ValueError):                # wider than the mid tile
        rb.res_block(*_on(block_inputs(C=136), cuda, bf), 1)
    with pytest.raises(ValueError):                  # C not 16 bytes wide
        rb.res_block(*_on(block_inputs(C=12), cuda, bf), 1)
