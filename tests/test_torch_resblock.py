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

The bf16 kernel's operands and geometry on the CPU: both convs' packed
weights round trip to HWIO, and a plain emulation of the kernel (conv1 in
the input halo's flat row order, rows past the staged halo read as NaN, mid
written into its tile with zero outside the image, conv2 over the mid
tile's windows) equals ``res_block_ref``. ``PSMNet(stream_blocks=True)``
keeps each block's packed operands until a weight or BatchNorm buffer
changes.

CUDA (marker ``cuda``, skipped without a card): the kernel against its plain
version on the card, f32 at 1e-4 * max|ref| and bf16 at 2e-2 * max|ref|, at
the KITTI layer shapes and at sizes that are not tile multiples; one-hot
conv1 taps with conv2 the identity (conv1's windows); a positive BN1 shift
at the borders (mid outside the image is zero, not relu(shift)); the launch
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


# ---- the bf16 kernel's operands and geometry ---------------------------

@pytest.mark.parametrize("C", [24, 32, 64, 128])
def test_block_operands_round_trip_to_hwio(C):
    """Both convs packed as the bf16 kernel reads them: K blocks of 32 at C
    <= 32 (C = 24 zero padded), else of 64; outputs padded to 32, 64, 128."""
    a = [torch.from_numpy(v) for v in block_inputs(C, H=4, W=4)]
    packed = pb.pack_chain((a[1], a[4]))
    for p, w in zip(packed, (a[1], a[4])):
        assert tuple(p.shape) == pb.packed_shape(3, C, C)
        assert torch.equal(pb.unpack_weights(p, 3, C, C), w)
        assert int(torch.count_nonzero(p)) == w.numel()


def _block_shape(C, dil):
    """The kernel's instance (csrc/res_block.cu::RbShape) for (C, d): its
    output width BN, K block KB, patch 8 x PW, conv1's tiles a warpgroup MT1
    and rounds NR1."""
    bn, kb = pb.n_block(C), pb.k_block(C)
    mt2, nr1 = {(32, 1): (4, 1), (32, 2): (2, 1), (64, 1): (2, 1),
                (64, 2): (1, 1), (128, 1): (1, 1), (128, 2): (1, 2)}[bn, dil]
    pw = 16 * mt2
    hw, mh, mw = pw + 4 * dil, 8 + 2 * dil, pw + 2 * dil
    flat = (mh - 1) * hw + mw
    mt1 = (-(-flat // 64) + 1) // 2
    return bn, kb, pw, mt1, nr1


def _block_from_packed(x, packed, s1, t1, s2, t2, dil):
    """One block as the bf16 kernel computes it, in f32: per 8 x PW patch,
    the (8 + 4d) x (PW + 4d) halo of x (zero outside the image and past C)
    in flat row order, followed by NaN rows (what a tile's window reads past
    the staged halo); conv1 as 2 MT1 m64 tiles of 64 consecutive halo rows,
    tap (ky, kx) the window shifted by d (ky hw + kx) rows, over the packed
    slabs (in NR1 rounds of output channels); rows r hw + c with r < 8 + 2d,
    c < PW + 2d kept as mid pixel (r, c), relu(bn1) inside the image and
    zero outside; conv2 over the mid tile's windows (rows of 8 pixels, PW +
    2d apart); bn2 + x."""
    n, h, w, c = x.shape
    bn, kb, pw, mt1, nr1 = _block_shape(c, dil)
    d = dil
    hw, hp, mh, mw = pw + 4 * d, 8 + 4 * d, 8 + 2 * d, pw + 2 * d
    w1, w2 = (pb.swizzle_rows(p).float() for p in packed)   # (nkb, 9, bn, kb)
    k = w1.shape[0] * kb
    xp = torch.nn.functional.pad(x.float(), (0, k - c))
    rows = 128 * mt1 + d * (2 * hw + 2)
    out = torch.zeros(n, h, w, c)
    ly, lx = torch.arange(hp * hw) // hw, torch.arange(hp * hw) % hw
    f = torch.arange(128 * mt1)
    rr, cc = f // hw, f % hw
    keep = (rr < mh) & (cc < mw)
    for img in range(n):
        for y0 in range(0, h, 8):
            for x0 in range(0, w, pw):
                halo = torch.full((rows, k), float("nan"))
                iy, ix = y0 - 2 * d + ly, x0 - 2 * d + lx
                ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                halo[:hp * hw] = 0
                halo[:hp * hw][ok] = xp[img, iy[ok], ix[ok]]
                acc = torch.zeros(128 * mt1, bn)
                for r in range(nr1):
                    cols = slice(r * bn // nr1, (r + 1) * bn // nr1)
                    for tap in range(9):
                        off = d * (tap // 3 * hw + tap % 3)
                        wt = w1[:, tap, cols].permute(0, 2, 1).reshape(k, -1)
                        acc[:, cols] += halo[f + off] @ wt
                gy, gx = y0 - d + rr, x0 - d + cc
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                y = torch.relu(acc[:, :c] * s1 + t1) * inside[:, None]
                mid = torch.zeros(mh * mw, k)
                mid[(rr * mw + cc)[keep], :c] = y[keep].to(x.dtype).float()
                assert not torch.isnan(mid).any()
                oy, ox = torch.meshgrid(torch.arange(8), torch.arange(pw),
                                        indexing="ij")
                acc2 = torch.zeros(8, pw, bn)
                for tap in range(9):
                    at = (oy + tap // 3 * d) * mw + ox + tap % 3 * d
                    wt = w2[:, tap].permute(0, 2, 1).reshape(k, bn)
                    acc2 += mid[at.reshape(-1)].reshape(8, pw, k) @ wt
                yy, xx = min(8, h - y0), min(pw, w - x0)
                res = x[img, y0:y0 + yy, x0:x0 + xx].float()
                out[img, y0:y0 + yy, x0:x0 + xx] = (
                    acc2[:yy, :xx, :c] * s2 + t2 + res)
    return out


@pytest.mark.parametrize("C,dil,hw", [
    (32, 1, (9, 70)), (24, 1, (10, 17)), (32, 2, (9, 35)), (64, 1, (9, 33)),
    (64, 2, (5, 7)), (128, 1, (9, 17)), (128, 2, (10, 18))],
    ids=["c32", "c24", "c32_d2", "c64", "c64_d2", "c128", "c128_d2"])
def test_block_over_packed_operands_matches_plain(C, dil, hw):
    """The kernel's flat conv1 windows, its mid tile and conv2's windows on
    the packed weights give ``res_block_ref``, with a positive BN1 shift so
    that mid outside the image being zero (not relu(shift)) shows; rows
    that only dropped conv1 rows read are NaN and must not reach mid."""
    a = [torch.from_numpy(v) for v in block_inputs(C, N=1, H=hw[0], W=hw[1],
                                                   seed=C + dil)]
    a[3] = a[3].abs() + 0.5
    out = _block_from_packed(a[0], pb.pack_chain((a[1], a[4])), *a[2:4],
                             *a[5:7], dil)
    _close(out.numpy(), rb.res_block_ref(*a, dil).numpy())


def test_stream_blocks_operands_are_kept_until_a_weight_changes(monkeypatch):
    """With the kernels' packed operands made (``psmnet.packs`` forced on
    for the CPU), ``PSMNet(stream_blocks=True)`` folds and packs each of the
    23 blocks' operands (``pack_chain`` of both convs) and the tail's once,
    reuses them on the next forward, and makes one block's anew when its
    BatchNorm buffer changes; the output is the plain one."""
    from magnet_tpu_torch.kernels import spp_tail as st
    from magnet_tpu_torch.models.build import init_weights_
    monkeypatch.setattr(psmnet, "packs", lambda x: True)
    m = init_weights_(psmnet.PSMNet(16, stream_blocks=True), seed=3).eval()
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(1))

    def kept():
        return {(id(mod), name): entry[1] for mod in m.modules()
                for name, entry in mod.__dict__.get("_folded", {}).items()}

    with torch.no_grad():
        out = m(x)
        first = kept()
        blocks = [b for li in range(1, 5) for b in getattr(m, f"layer{li}")
                  if b.downsample is None]
        assert len(blocks) == 23
        for b in blocks:
            w, _, _, packed = first[(id(b), "res_block")]
            assert len(packed) == 2
            for p, wi in zip(packed, w):
                assert torch.equal(p, pb.pack_weights(wi))
        tail = first[(id(m.lastconv), "tail")]
        for p, q in zip(tail[4], st.tail_operands(tail[0], tail[3],
                                                  (64, 128, 128))):
            assert torch.equal(p, q)
        assert torch.equal(m(x), out)
        assert all(kept()[k] is v for k, v in first.items())
        m.layer4[1].conv1[0][1].running_var.add_(0.5)
        m(x)
    changed = [k for k, v in kept().items() if v is not first[k]]
    assert changed == [(id(m.layer4[1]), "res_block")]
    monkeypatch.undo()
    with torch.no_grad():
        fresh = psmnet.PSMNet(16, stream_blocks=True).eval()
        fresh.load_state_dict(m.state_dict())
        assert torch.equal(m(x), fresh(x))


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


def _check_bf16(a, dil):
    bf = torch.bfloat16
    out = rb.res_block(*a, dil)
    ref = rb.res_block_ref(*a, dil)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == bf
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _TOL[bf] * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("C,dil", [(32, 1), (32, 2), (128, 1), (128, 2)],
                         ids=["c32_d1", "c32_d2", "c128_d1", "c128_d2"])
@pytest.mark.parametrize("tap", range(9))
def test_res_block_kernel_conv1_single_tap(cuda, C, dil, tap):
    """conv1 non-zero at one tap only and conv2 the centre-tap identity, so
    out = relu(bn1(conv1(x))) + x: a wrong conv1 window (its flat halo
    offset d (ky hw + kx)) cannot hide behind the other taps."""
    a = _on(block_inputs(C, N=2, H=19, W=37, seed=tap), cuda, torch.bfloat16)
    only = torch.zeros(3, 3, 1, 1, device=cuda)
    only[tap // 3, tap % 3] = 1
    a[1] = (a[1].float() * only).to(torch.bfloat16)
    eye = torch.zeros(3, 3, C, C, device=cuda)
    eye[1, 1] = torch.eye(C, device=cuda)
    a[4], a[5], a[6] = eye.to(torch.bfloat16), a[5] * 0 + 1, a[6] * 0
    _check_bf16(a, dil)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("dil", [1, 2])
def test_res_block_kernel_mid_is_zero_outside_the_image(cuda, C, dil):
    """A positive BN1 shift: relu(bn1(conv1)) of the zero-padded x would be
    relu(t1) > 0 outside the image, where conv2's padding needs zeros."""
    a = _on(block_inputs(C, N=1, H=9, W=17, seed=C), cuda, torch.bfloat16)
    a[3] = a[3].abs() + 1.0
    _check_bf16(a, dil)


@pytest.mark.cuda
def test_res_block_kernel_on_kept_operands(cuda):
    """Operands packed once, as PSMNet keeps them: one launch, the plain
    result."""
    a = _on(block_inputs(64, N=3, H=88, W=304), cuda, torch.bfloat16)
    packed = pb.pack_chain((a[1], a[4]))
    before = rb.res_block.launches
    out = rb.res_block(*a, 1, packed)
    assert rb.res_block.launches == before + 1
    ref = rb.res_block_ref(*a, 1)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _TOL[torch.bfloat16] * ref.float().abs().max().item(), err


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
    with pytest.raises(ValueError):                  # bf16 at dilation 3
        rb.res_block(*a, 3)
    packed = pb.pack_chain((a[1], a[4]))
    with pytest.raises(ValueError):                  # one conv packed
        rb.res_block(*a, 1, packed[:1])
    with pytest.raises(ValueError):                  # packed for C = 64
        rb.res_block(*a, 1, pb.pack_chain([torch.zeros(
            3, 3, 64, 64, device=cuda, dtype=bf)] * 2))
