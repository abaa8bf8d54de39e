"""Serving (magnet_tpu_torch/serve) and the kernels as PyTorch operators
(magnet_tpu_torch/kernels/ops.py), on the CPU.

* ``export_monolithic`` and ``export_encode``/``export_fuse``, traced with
  the f32 state dict as an argument and round-tripped through bytes, held
  to the eager forward bit for bit (on the CPU the programs hold the
  kernels' plain versions, the same calls in the same order) and to the
  JAX forward on the same weights at ``tests/test_torch_magnet.py``'s f32
  limits (1e-4 * max|ref| on all but 1 % of the pixels);
* each of the thirteen operators on ``meta`` tensors: its fake output has the
  shape and dtype of its plain version's output on the CPU, in f32 and
  bf16; no operator runs on CPU tensors;
* ``make_multistream_forward`` with two streams against the single-stream
  forward of each window, bit for bit, with torch.distributed's
  collectives made to raise.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from magnet_tpu_torch.kernels import conv3x3_bnact as cb
from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels import dw_conv as dwk
from magnet_tpu_torch.kernels import gnet_update as gk
from magnet_tpu_torch.kernels import head_chain as hc
from magnet_tpu_torch.kernels import mbconv_chain as mbk
from magnet_tpu_torch.kernels import ops
from magnet_tpu_torch.kernels import psm_blocks as pb
from magnet_tpu_torch.kernels import res_block as rbk
from magnet_tpu_torch.kernels import spp_tail as st
from magnet_tpu_torch.kernels import sweep_grad_ref as sgr
from magnet_tpu_torch.kernels import sweep_grad_src as sgk
from magnet_tpu_torch.kernels import upsample_mask as uk
from magnet_tpu_torch.serve import export as ex
from magnet_tpu_torch.serve import streams

from test_torch_kernels import torch_threads  # noqa: F401
from test_torch_magnet import (H, V, W, _load, batch,  # noqa: F401
                               magnet_case, xla_paths)

F32, BF16 = torch.float32, torch.bfloat16


# ---- the exported programs -------------------------------------------------

@pytest.fixture(scope="module")
def served(magnet_case):
    """The port's model of ``magnet_case``'s weights, its inputs, the eager
    iterations and the JAX forward's."""
    jm, variables, inputs = magnet_case
    model = _load(variables)
    args = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        eager = model(*args)
    refs = [np.asarray(r) for r in jax.jit(jm.apply)(variables, *inputs)]
    return model, args, eager, refs


def _hold_to_jax(out, ref):
    assert out.shape == ref.shape == (1, H, W, 2)
    err = np.abs(out.numpy() - ref)
    lim = 1e-4 * float(np.abs(ref).max())
    assert (err > lim).mean() < 0.01, (err.max(), lim)


def test_monolithic_export_round_trips(served):
    model, args, eager, refs = served
    blob = ex.export_monolithic(model, H, W, V, n_iters=len(eager),
                                compute_dtype=F32)
    assert isinstance(blob, bytes) and len(blob) < 64e6   # no weights
    program = ex.load_exported(blob)
    # an argument as a loader may give it, not contiguous: the program
    # was traced on contiguous ones
    rays = args[-1].transpose(1, 2).contiguous().transpose(1, 2)
    assert not rays.is_contiguous()
    out = program(ex.f32_state(model), *args[:-1], rays)
    assert torch.equal(out, eager[-1])
    _hold_to_jax(out, refs[-1])
    assert ex.op_counts(program) == {}    # the CPU program: plain versions
    _no_spans(program)


def _no_spans(program):
    """The program's spans (``utils.profiling.stage``) leave nothing in an
    exported graph: it is traced with no profiler running."""
    assert not [n for n in program.graph.nodes
                if "profiler" in str(n.target)]


def test_encode_fuse_export_round_trips(served):
    model, args, eager, refs = served
    ref_img, src_imgs, *geometry = args
    state = ex.f32_state(model)
    encode = ex.load_exported(ex.export_encode(model, H, W, batch=V + 1,
                                               compute_dtype=F32))
    fuse = ex.load_exported(ex.export_fuse(model, H, W, V,
                                           n_iters=len(eager),
                                           compute_dtype=F32))
    gauss, feat_d, feat_m = encode(state, torch.cat(
        [ref_img, src_imgs.reshape(V, H, W, 3)]))
    out = fuse(state, gauss[:1], feat_d[:1].contiguous(), feat_m[:1],
               gauss[1:][None], feat_m[1:][None], *geometry)
    assert torch.equal(out, eager[-1])
    _hold_to_jax(out, refs[-1])
    _no_spans(encode)
    _no_spans(fuse)


def test_exported_state_is_cast_as_for_inference(served):
    """The compute-dtype cast inside the program follows
    ``cast_for_inference``: convs in the compute dtype, the
    squeeze-excitation's and the norms' tensors in f32."""
    model = served[0]
    keys = ex.cast_keys(model)
    assert "d_net.d_net.encoder.original_model.conv_stem.weight" in keys
    assert not any(".se." in k or ".bn" in k or "running" in k
                   for k in keys)


# ---- the operators ---------------------------------------------------------

def _r(g, *shape, dtype=F32, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


def _conv_case(g, dt):
    x, skip = _r(g, 1, 4, 6, 16, dtype=dt), _r(g, 1, 8, 12, 16, dtype=dt)
    w, ws = _r(g, 3, 3, 16, 32, dtype=dt), _r(g, 3, 3, 16, 32, dtype=dt)
    sc, sh = _r(g, 32), _r(g, 32)
    want = cb.conv3x3_bnact_ref(x, w, sc, sh, skip, ws, True, True)
    wx, wsk = (cb.pack_weights(w, ws), None) if dt == BF16 else (w, ws)
    return want, (x, skip, wx, wsk, sc, sh, True, True)


def _head_case(g, dt):
    x = _r(g, 1, 6, 8, 16, dtype=dt)
    convs = [(_r(g, 3, 3, 16, 128, dtype=dt), _r(g, 128), True),
             (_r(g, 1, 1, 128, 128, dtype=dt), _r(g, 128), True),
             (_r(g, 1, 1, 128, 2, dtype=dt), _r(g, 2), False)]
    ws, bs = hc.head_operands(convs)
    return hc.head_chain_ref(x, convs), (x, ws, bs, 2, 3)


def _geometry(g, B=1, V_=2, HW=24):
    return [torch.eye(3).expand(B, V_, 3, 3).contiguous(),
            _r(g, B, V_, 3, scale=0.05), torch.ones(B, V_),
            torch.tensor([[[5.0, 0, 3], [0, 5.0, 2], [0, 0, 1]]]),
            torch.cat([_r(g, B, 2, HW, scale=0.3), torch.ones(B, 1, HW)], 1)]


def _cv_case(g, dt):
    d = 2.0 + torch.rand(1, 4, 6, 5, generator=g)
    ref, src = _r(g, 1, 4, 6, 16, dtype=dt), _r(g, 1, 2, 4, 6, 16, dtype=dt)
    mu, sigma = 2.0 + torch.rand(1, 2, 4, 6), 0.2 + torch.rand(1, 2, 4, 6)
    geo = _geometry(g)
    want = cvk.cost_volume_cw_ref(d, ref, src, mu, sigma, *geo, 5.0)
    return want, (d, ref, src, cvk.cv_operands(mu, sigma, dt), *geo, 5.0, 2)


def _gnet_case(g, dt):
    cv, feat = _r(g, 1, 4, 6, 5, dtype=dt), _r(g, 1, 4, 6, 128, dtype=dt)
    prev = torch.stack([2.0 + torch.rand(1, 4, 6), 0.2 + torch.rand(
        1, 4, 6)], -1).to(dt)
    convs = [(_r(g, 3, 3, 5, 128, dtype=dt), None),
             (_r(g, 1, 1, 128, 128, dtype=dt), _r(g, 128)),
             (_r(g, 1, 1, 128, 128, dtype=dt), _r(g, 128)),
             (_r(g, 1, 1, 128, 2, dtype=dt), _r(g, 2))]
    ws, bs = gk.gnet_operands(convs)
    return (gk.gnet_update_ref(cv, feat, prev, convs),
            (cv, feat, prev, ws, bs))


def _up_case(g, dt):
    maps = [_r(g, 1, 4, 6, 1, dtype=dt) for _ in range(3)]
    mask = _r(g, 1, 4, 6, 9 * 16, dtype=dt)
    return uk.upsample_mask_ref(maps, mask, 4), (maps, mask, 4)


def _up_bwd_case(g, dt):
    maps = [_r(g, 1, 4, 6, 1, dtype=dt) for _ in range(2)]
    mask = _r(g, 1, 4, 6, 9 * 16, dtype=dt)
    grads = [_r(g, 1, 16, 24, 1, dtype=dt) for _ in range(2)]
    return (uk.upsample_mask_bwd_ref(grads, maps, mask, 4),
            (grads, maps, mask, 4))


def _psm_case(g, dt):
    x, w = _r(g, 1, 8, 8, 32, dtype=dt), _r(g, 3, 3, 32, 64, dtype=dt)
    sc, sh, res = _r(g, 64), _r(g, 64), _r(g, 1, 4, 4, 64, dtype=dt)
    want = pb._conv_ref(x, w, sc, sh, 2, 1, True, res)
    wk = pb.pack_weights(w) if dt == BF16 else w
    return want, (x, wk, sc, sh, res, 3, 2, 1, True, "downsample_block")


def _spp_case(g, dt):
    raw, skip = _r(g, 1, 4, 6, 32, dtype=dt), _r(g, 1, 4, 6, 32, dtype=dt)
    br = _r(g, 1, 4, 6, 16, dtype=dt)
    w0, w1 = _r(g, 3, 3, 80, 128, dtype=dt), _r(g, 128, 32, dtype=dt)
    sc, sh = _r(g, 128), _r(g, 128)
    want = st.spp_tail_ref(raw, skip, br, w0, sc, sh, w1)
    if dt == BF16:
        w0, w1 = st.tail_operands(w0, w1, (32, 32, 16))
    return want, (raw, skip, br, w0, sc, sh, w1, 32)


def _sweep_case(g, dt):
    dc = torch.linspace(1.0, 5.0, 5)
    ref, gbar = _r(g, 1, 4, 6, 16, dtype=dt), _r(g, 1, 4, 6, 5)
    geo = _geometry(g)
    return (sgk.sweep_grad_src_ref(dc, ref, gbar, *geo),
            (dc, ref, gbar, *geo))


def _sweep_ref_case(g, dt):
    dc = torch.linspace(1.0, 5.0, 5)
    src, gbar = _r(g, 1, 2, 4, 6, 16, dtype=dt), _r(g, 1, 4, 6, 5)
    geo = _geometry(g)
    return (sgr.sweep_grad_ref_ref(dc, src, gbar, *geo),
            (dc, src, gbar, *geo))


def _dw_case(g, dt):
    x, w = _r(g, 1, 6, 8, 16, dtype=dt), _r(g, 3, 3, 16, dtype=dt)
    return dwk.dw_conv_ref(x, w), (x, w)


def _mb_case(g, dt):
    nb, C, M, R = 2, 16, 64, 4
    a = (_r(g, 1, 6, 8, C, dtype=dt), _r(g, nb, C, M, dtype=dt),
         _r(g, nb, M), _r(g, nb, 9, M, dtype=dt), _r(g, nb, M),
         _r(g, nb, M, R), _r(g, nb, R), _r(g, nb, R, M), _r(g, nb, M),
         _r(g, nb, M, C, dtype=dt), _r(g, nb, C), 3)
    return mbk.mbconv_chain_ref(*a), a


def _res_case(g, dt):
    x = _r(g, 1, 6, 8, 32, dtype=dt)
    w1, w2 = _r(g, 3, 3, 32, 32, dtype=dt), _r(g, 3, 3, 32, 32, dtype=dt)
    s1, t1, s2, t2 = (_r(g, 32) for _ in range(4))
    want = rbk.res_block_ref(x, w1, s1, t1, w2, s2, t2, 1)
    if dt == BF16:
        w1, w2 = pb.pack_chain((w1, w2))
    return want, (x, w1, s1, t1, w2, s2, t2, 1)


CASES = {"conv3x3_bnact": _conv_case, "head_chain": _head_case,
         "cost_volume_cw": _cv_case, "gnet_update": _gnet_case,
         "upsample_mask": _up_case, "upsample_mask_bwd": _up_bwd_case,
         "psm_conv": _psm_case, "spp_tail": _spp_case,
         "sweep_grad_src": _sweep_case, "sweep_grad_ref": _sweep_ref_case,
         "dw_conv": _dw_case,
         "mbconv_block": _mb_case, "res_block": _res_case}


def _meta(a):
    if isinstance(a, torch.Tensor):
        return a.to("meta")
    if isinstance(a, (list, tuple)):
        return type(a)(_meta(x) for x in a)
    return a


def _leaves(a):
    if isinstance(a, torch.Tensor):
        return [a]
    return [t for x in a for t in _leaves(x)]


def test_one_operator_per_entry_point():
    assert set(CASES) == set(ops.op_names())
    assert len(ops.op_names()) == 13


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_operator_fake_matches_plain_version(name, dtype):
    want, args = CASES[name](torch.Generator().manual_seed(0), dtype)
    got = getattr(ops.OPS, name)(*_meta(args))
    want, got = _leaves(want), _leaves(got)
    assert len(got) == len(want) > 0
    for w, o in zip(want, got):
        assert o.device.type == "meta"
        assert (tuple(o.shape), o.dtype) == (tuple(w.shape), w.dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_operator_has_no_cpu_kernel(name):
    """A CPU tensor never reaches a kernel's operator: there is no CPU
    implementation to fall back to (the wrappers run the plain versions
    before an operator is called)."""
    _, args = CASES[name](torch.Generator().manual_seed(0), F32)
    with pytest.raises(NotImplementedError):
        getattr(ops.OPS, name)(*args)


# ---- multi-stream ----------------------------------------------------------

def test_multistream_matches_single_stream(served, monkeypatch):
    model, args, _, _ = served
    g = torch.Generator().manual_seed(4)
    second = [a.clone() for a in args]
    second[0] = (second[0] + 0.1 * torch.rand(second[0].shape, generator=g))
    second[3] = second[3] * 1.5
    batch = {k: torch.cat([a, b]) for k, a, b in zip(streams.INPUTS, args,
                                                     second)}

    def refuse(*a, **k):
        raise AssertionError("a collective in a multi-stream forward")
    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "reduce_scatter", "all_to_all"):
        monkeypatch.setattr(dist, name, refuse)
    forward = streams.make_multistream_forward(model, ["cpu", "cpu"],
                                               n_iters=3)
    out = forward(batch)
    assert out.shape == (2, H, W, 2)
    with torch.no_grad():
        for s, window in enumerate((args, second)):
            assert torch.equal(out[s], model(*window)[-1][0])
    assert not torch.equal(out[0], out[1])
