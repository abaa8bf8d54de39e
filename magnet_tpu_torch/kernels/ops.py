"""The CUDA kernels as PyTorch operators (namespace ``magnet_tpu_torch``).

One operator per C entry point of ``build._SIGNATURES``, defined with
``torch.library``:

=====================  ==========================================
``conv3x3_bnact``      ``mt_conv3x3_bnact`` (decoder up2, up3)
``head_chain``         ``mt_head_chain``
``cost_volume_cw``     ``mt_cost_volume_cw``
``gnet_update``        ``mt_gnet_update``
``upsample_mask``      ``mt_upsample_mask`` (up to ``MAX_MAPS`` maps)
``upsample_mask_bwd``  ``mt_upsample_mask_bwd``
``psm_conv``           ``mt_psm_conv`` (F-Net chains, transitions)
``spp_tail``           ``mt_spp_tail``
``sweep_grad_src``     ``mt_sweep_grad_src``
``sweep_grad_ref``     ``mt_sweep_grad_ref`` (in ``cost_volume_cw.cu``)
``dw_conv``            ``mt_dw_conv``
``mbconv_block``       ``mt_mbconv_block``, once a stacked block
``res_block``          ``mt_res_block``
=====================  ==========================================

Each has a CUDA implementation (the operand checks, the output and scratch
allocation, the ``ctypes`` launch on the current stream and the launch
count on its wrapper's ``launches``) and a fake implementation that gives
the outputs' shapes, dtypes and device without running anything, which is
what ``torch.export`` and ``torch.library.opcheck`` trace through. No
operator has a CPU implementation: the wrappers in this package run the
plain PyTorch version for CPU tensors before they reach an operator, so a
CUDA tensor reaches a kernel or an error, never a plain version.

A program exported on a card (``serve/export.py``) holds these operators by
name; loading it needs this module imported, which registers them.
"""

from __future__ import annotations

import importlib

import torch

from magnet_tpu_torch.kernels import build

NAMESPACE = "magnet_tpu_torch"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LEAKY = 2
MAX_MAPS = 4            # maps a launch (csrc/upsample_mask.cu: UP_MAX_MAPS)
F32 = torch.float32

_LIB = torch.library.Library(NAMESPACE, "DEF")
SCHEMAS = {
    "conv3x3_bnact": "(Tensor x, Tensor? skip, Tensor w, Tensor? w_skip, "
                     "Tensor scale, Tensor shift, bool upsample, bool act) "
                     "-> Tensor",
    "head_chain": "(Tensor x, Tensor[] ws, Tensor[] bs, int c_out, "
                  "int relu_mask) -> Tensor",
    "cost_volume_cw": "(Tensor d, Tensor ref, Tensor src, Tensor ms, "
                      "Tensor R, Tensor t, Tensor valid, Tensor K, "
                      "Tensor rays, float kappa, int v_total) -> Tensor",
    "gnet_update": "(Tensor cv, Tensor feat, Tensor prev, Tensor[] ws, "
                   "Tensor[] bs) -> Tensor",
    "upsample_mask": "(Tensor[] maps, Tensor mask, int k) -> Tensor[]",
    "upsample_mask_bwd": "(Tensor[] grads, Tensor[] maps, Tensor mask, "
                         "int k) -> (Tensor[], Tensor)",
    "psm_conv": "(Tensor x, Tensor w, Tensor scale, Tensor shift, "
                "Tensor? res, int k, int stride, int dil, bool relu, "
                "str counter) -> Tensor",
    "spp_tail": "(Tensor raw, Tensor skip, Tensor br, Tensor w0, "
                "Tensor scale0, Tensor shift0, Tensor w1, int cout) -> Tensor",
    "sweep_grad_src": "(Tensor depth, Tensor ref, Tensor gbar, Tensor R, "
                      "Tensor t, Tensor valid, Tensor K, Tensor rays) "
                      "-> Tensor",
    "sweep_grad_ref": "(Tensor depth, Tensor src, Tensor gbar, Tensor R, "
                      "Tensor t, Tensor valid, Tensor K, Tensor rays) "
                      "-> Tensor",
    "dw_conv": "(Tensor x, Tensor w) -> Tensor",
    "mbconv_block": "(Tensor x, Tensor wpw, Tensor s1, Tensor wdw, "
                    "Tensor s2, Tensor wse1, Tensor bse1, Tensor wse2, "
                    "Tensor bse2, Tensor wpwl, Tensor s3, int K) -> Tensor",
    "res_block": "(Tensor x, Tensor w1, Tensor s1, Tensor t1, Tensor w2, "
                 "Tensor s2, Tensor t2, int dil) -> Tensor",
}
# the wrapper whose ``launches`` counts an operator's launches (psm_conv
# names its own: the chain, the downsample or the expand block)
COUNTERS = {"conv3x3_bnact": "conv3x3_bnact.conv3x3_bnact",
            "head_chain": "head_chain.head_chain",
            "cost_volume_cw": "cost_volume_cw.cost_volume_cw",
            "gnet_update": "gnet_update.gnet_update",
            "upsample_mask": "upsample_mask.upsample_mask",
            "upsample_mask_bwd": "upsample_mask.upsample_mask_bwd",
            "fused_residual_stage": "psm_blocks.fused_residual_stage",
            "downsample_block": "psm_blocks.downsample_block",
            "expand_block": "psm_blocks.expand_block",
            "spp_tail": "spp_tail.spp_tail",
            "sweep_grad_src": "sweep_grad_src.sweep_grad_src",
            "sweep_grad_ref": "sweep_grad_ref.sweep_grad_ref",
            "dw_conv": "dw_conv.dw_conv",
            "mbconv_block": "mbconv_chain.mbconv_chain",
            "res_block": "res_block.res_block"}
for _name, _schema in SCHEMAS.items():
    _LIB.define(_name + _schema)

# the operators, as the wrappers call them
OPS = getattr(torch.ops, NAMESPACE)


def _count(name: str, n: int = 1) -> None:
    module, attr = COUNTERS[name].rsplit(".", 1)
    getattr(_mod(module), attr).launches += n


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _dtype(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what}: unsupported dtype {t.dtype}")
    return _DTYPES[t.dtype]


def _check(t: torch.Tensor, what: str, shape, dtype, device,
           align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous ``shape`` tensor of ``dtype`` on
    ``device`` whose address is a multiple of ``align`` bytes."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{what}: {t.dtype} on {t.device}, "
                         f"want {dtype} on {device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{what}: must be contiguous and {align}-byte "
                         "aligned")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(entry: str, what: str, dev: torch.device, *args) -> None:
    """One call of the C entry point on ``dev``; raises on a CUDA error."""
    with torch.cuda.device(dev):
        err = getattr(build.library(), entry)(*args, _stream(dev))
    build.check(err, what)


# the CUDA implementations by operator, as plain functions
IMPLS = {}


def _impl(name: str):
    def register(fn):
        _LIB.impl(name, fn, "CUDA")
        IMPLS[name] = fn
        return fn
    return register


def _fake(name: str):
    return torch.library.register_fake(f"{NAMESPACE}::{name}", lib=_LIB)


def _mod(name: str):
    """A wrapper module of this package, imported at call time (each wrapper
    imports this module; its shapes and constants are its own)."""
    return importlib.import_module("magnet_tpu_torch.kernels." + name)


# ---- conv3x3_bnact ----------------------------------------------------------

def _conv_out(x, skip, scale):
    N, Hs, Ws, _ = x.shape
    H, W = (skip.shape[1], skip.shape[2]) if skip is not None else (Hs, Ws)
    return (N, H, W, scale.shape[0])


@_impl("conv3x3_bnact")
def _conv3x3_bnact(x, skip, w, w_skip, scale, shift, upsample, act):
    what = "conv3x3_bnact"
    dt, dev = x.dtype, x.device
    code = _dtype(x, what)
    N, Hs, Ws, Cx = x.shape
    N, H, W, Cout = _conv_out(x, skip, scale)
    Cs = skip.shape[-1] if skip is not None else 0
    vec = 16 // x.element_size()
    if Cx % vec or Cs % vec or Cout % vec:
        raise ValueError(f"{what}: channels ({Cx}, {Cs}, {Cout}) must be "
                         f"multiples of {vec}")
    if upsample and skip is None:
        raise ValueError(f"{what}: upsample takes its size from skip")
    if not upsample and (H, W) != (Hs, Ws):
        raise ValueError(f"{what}: skip and x differ in size")
    _check(x, "x", (N, Hs, Ws, Cx), dt, dev)
    if skip is not None:
        _check(skip, "skip", (N, H, W, Cs), dt, dev)
    if dt == torch.bfloat16:
        _check(w, "packed", _mod("conv3x3_bnact").packed_shape(
            Cx, Cs, Cout), dt, dev)
        if w_skip is not None:
            raise ValueError(f"{what}: the packed weight holds the skip's")
    else:
        _check(w, "w", (3, 3, Cx, Cout), dt, dev)
        if skip is not None:
            _check(w_skip, "w_skip", (3, 3, Cs, Cout), dt, dev)
    _check(scale, "scale", (Cout,), F32, dev)
    _check(shift, "shift", (Cout,), F32, dev)
    out = torch.empty((N, H, W, Cout), dtype=dt, device=dev)
    _launch("mt_conv3x3_bnact", what, dev, code, x.data_ptr(), _ptr(skip),
            w.data_ptr(), _ptr(w_skip), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), N, H, W, Hs, Ws, Cx, Cs, Cout, int(upsample),
            _LEAKY if act else 0)
    _count("conv3x3_bnact")
    return out


@_fake("conv3x3_bnact")
def _conv3x3_bnact_fake(x, skip, w, w_skip, scale, shift, upsample, act):
    return x.new_empty(_conv_out(x, skip, scale))


# ---- head_chain -------------------------------------------------------------

@_impl("head_chain")
def _head_chain(x, ws, bs, c_out, relu_mask):
    what = "head_chain"
    dt, dev = x.dtype, x.device
    code = _dtype(x, what)
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (N, H, W, C)")
    N, H, W, C0 = x.shape
    _check(x, "x", (N, H, W, C0), dt, dev)
    n = len(ws)
    if not 1 <= n <= 4 or len(bs) != n:
        raise ValueError(f"{what}: 1 to 4 convs, one bias each")
    for w, b in zip(ws, bs):
        _check(w, "operand", tuple(w.shape), dt, dev)
        _check(b, "bias operand", tuple(b.shape), F32, dev, 4)
    out = torch.empty((N, H, W, c_out), dtype=dt, device=dev)
    pad = [None] * (4 - n)
    _launch("mt_head_chain", what, dev, code, x.data_ptr(),
            *[w.data_ptr() for w in ws], *pad, *[b.data_ptr() for b in bs],
            *pad, out.data_ptr(), N, H, W, C0, n, c_out, relu_mask)
    _count("head_chain")
    return out


@_fake("head_chain")
def _head_chain_fake(x, ws, bs, c_out, relu_mask):
    return x.new_empty((*x.shape[:3], c_out))


# ---- cost_volume_cw ---------------------------------------------------------

@_impl("cost_volume_cw")
def _cost_volume_cw(d, ref, src, ms, R, t, valid, K, rays, kappa, v_total):
    what = "cost_volume_cw"
    dev, mdt = d.device, src.dtype
    code = _dtype(src, what)
    if d.dim() != 4 or src.dim() != 5:
        raise ValueError(f"{what}: d_volume must be (B, H, W, D) and "
                         "src_feat (B, V, H, W, C)")
    B, H, W, D = d.shape
    V, C = src.shape[1], src.shape[-1]
    MAX_C, MAX_D = _mod("cost_volume_cw").MAX_C, _mod("cost_volume_cw").MAX_D
    if C % (16 // src.element_size()) or C > MAX_C:
        raise ValueError(f"{what}: C={C} must be a multiple of 16 bytes and "
                         f"at most {MAX_C}")
    if D > MAX_D:
        raise ValueError(f"{what}: D={D} is over {MAX_D}")
    if v_total < 1:
        raise ValueError(f"{what}: v_total={v_total} must be at least 1")
    for tt, name, shape, dt in (
            (d, "d_volume", (B, H, W, D), F32), (ref, "ref_feat",
                                                 (B, H, W, C), mdt),
            (src, "src_feat", (B, V, H, W, C), mdt),
            (ms, "ops", (B, V, H, W, 2), mdt), (R, "R", (B, V, 3, 3), F32),
            (t, "t", (B, V, 3), F32), (valid, "is_valid", (B, V), F32),
            (K, "intM", (B, 3, 3), F32), (rays, "rays2d", (B, 3, H * W), F32)):
        _check(tt, name, shape, dt, dev, 4)
    out = torch.empty((B, H, W, D), dtype=F32, device=dev)
    _launch("mt_cost_volume_cw", what, dev, code, d.data_ptr(),
            ref.data_ptr(), src.data_ptr(), ms.data_ptr(), R.data_ptr(),
            t.data_ptr(), valid.data_ptr(), K.data_ptr(), rays.data_ptr(),
            out.data_ptr(), B, V, H, W, C, D, int(v_total), float(kappa))
    _count("cost_volume_cw")
    return out


@_fake("cost_volume_cw")
def _cost_volume_cw_fake(d, ref, src, ms, R, t, valid, K, rays, kappa,
                         v_total):
    return d.new_empty(d.shape, dtype=F32)


# ---- gnet_update ------------------------------------------------------------

@_impl("gnet_update")
def _gnet_update(cv, feat, prev, ws, bs):
    what = "gnet_update"
    g = _mod("gnet_update")
    GNET_HIDDEN, GNET_MAX_D = g.HIDDEN, g.MAX_D
    dt, dev = feat.dtype, cv.device
    code = _dtype(feat, what)
    B, H, W, D = cv.shape
    if D > GNET_MAX_D:
        raise ValueError(f"{what}: D={D} is over {GNET_MAX_D}")
    _check(cv, "cv", (B, H, W, D), dt, dev, 2)
    _check(feat, "feat_contrib", (B, H, W, GNET_HIDDEN), dt, dev)
    _check(prev, "prev", (B, H, W, 2), dt, dev, 4)
    if len(ws) != 4 or len(bs) != 3:
        raise ValueError(f"{what}: four weights and three biases")
    wdt = [dt, dt, dt, F32 if dt == torch.bfloat16 else dt]
    for w, shape, tdt in zip(ws, g.operand_shapes(D, dt), wdt):
        _check(w, "operand", shape, tdt, dev)
    for b, n in zip(bs, (GNET_HIDDEN, GNET_HIDDEN, 2)):
        _check(b, "bias operand", (n,), F32, dev, 4)
    out = torch.empty((B, H, W, 2), dtype=dt, device=dev)
    _launch("mt_gnet_update", what, dev, code, cv.data_ptr(),
            feat.data_ptr(), prev.data_ptr(), *[w.data_ptr() for w in ws],
            *[b.data_ptr() for b in bs], out.data_ptr(), B, H, W, D)
    _count("gnet_update")
    return out


@_fake("gnet_update")
def _gnet_update_fake(cv, feat, prev, ws, bs):
    return feat.new_empty((*cv.shape[:3], 2))


# ---- upsample_mask and its backward -----------------------------------------

def _check_maps(maps, mask, k, what):
    if not 1 <= len(maps) <= MAX_MAPS:
        raise ValueError(f"{what}: 1 to {MAX_MAPS} maps a launch")
    d0 = maps[0]
    dt, dev = d0.dtype, d0.device
    code = _dtype(d0, what)
    if d0.dim() != 4:
        raise ValueError(f"{what}: depth must be (B, H, W, C)")
    B, H, W, C = d0.shape
    for d in maps:
        _check(d, "map", (B, H, W, C), dt, dev, 2)
    _check(mask, "up_mask", (B, H, W, 9 * k * k), dt, dev, 2)
    return code, (B, H, W, C)


@_impl("upsample_mask")
def _upsample_mask(maps, mask, k):
    what = "upsample_mask"
    code, (B, H, W, C) = _check_maps(maps, mask, k, what)
    n = len(maps)
    outs = [torch.empty((B, H * k, W * k, C), dtype=maps[0].dtype,
                        device=mask.device) for _ in maps]
    pad = [None] * (MAX_MAPS - n)
    _launch("mt_upsample_mask", what, mask.device, code, n,
            *[d.data_ptr() for d in maps], *pad, mask.data_ptr(),
            *[o.data_ptr() for o in outs], *pad, B, H, W, C, k)
    _count("upsample_mask")
    return outs


@_fake("upsample_mask")
def _upsample_mask_fake(maps, mask, k):
    B, H, W, C = maps[0].shape
    return [d.new_empty((B, H * k, W * k, C)) for d in maps]


@_impl("upsample_mask_bwd")
def _upsample_mask_bwd(grads, maps, mask, k):
    what = "upsample_mask_bwd"
    code, (B, H, W, C) = _check_maps(maps, mask, k, what)
    if len(grads) != len(maps):
        raise ValueError(f"{what}: one gradient a map")
    for g in grads:
        _check(g, "gradient", (B, H * k, W * k, C), maps[0].dtype,
               mask.device, 2)
    n = len(maps)
    gmaps = [torch.empty_like(d) for d in maps]
    gmask = torch.empty_like(mask)
    pad = [None] * (MAX_MAPS - n)
    _launch("mt_upsample_mask_bwd", what, mask.device, code, n,
            *[g.data_ptr() for g in grads], *pad,
            *[d.data_ptr() for d in maps], *pad, mask.data_ptr(),
            *[g.data_ptr() for g in gmaps], *pad, gmask.data_ptr(),
            B, H, W, C, k)
    _count("upsample_mask_bwd")
    return gmaps, gmask


@_fake("upsample_mask_bwd")
def _upsample_mask_bwd_fake(grads, maps, mask, k):
    return [torch.empty_like(d) for d in maps], torch.empty_like(mask)


# ---- psm_conv: the F-Net's convs --------------------------------------------

def _psm_out(x, scale, stride):
    N, H, W, _ = x.shape
    return (N, (H - 1) // stride + 1, (W - 1) // stride + 1, scale.shape[0])


@_impl("psm_conv")
def _psm_conv(x, w, scale, shift, res, k, stride, dil, relu, counter):
    what = "psm conv"
    dt, dev = x.dtype, x.device
    code = _dtype(x, what)
    N, H, W, Ci = x.shape
    Co = scale.shape[0]
    vec = 16 // x.element_size()
    if k not in (1, 3) or stride not in (1, 2) or dil < 1:
        raise ValueError(f"{what}: window {k}, stride {stride}, "
                         f"dilation {dil}")
    if Ci % vec or Co % vec:
        raise ValueError(f"{what}: channels ({Ci}, {Co}) must be multiples "
                         f"of {vec}")
    if counter not in ("fused_residual_stage", "downsample_block",
                       "expand_block"):
        raise ValueError(f"{what}: unknown counter {counter!r}")
    _, Ho, Wo, _ = _psm_out(x, scale, stride)
    _check(x, "x", (N, H, W, Ci), dt, dev)
    _check(scale, "scale", (Co,), F32, dev)
    _check(shift, "shift", (Co,), F32, dev)
    if res is not None:
        _check(res, "res", (N, Ho, Wo, Co), dt, dev)
    kb = 0
    if dt == torch.bfloat16:
        if stride == 2 and k == 3 and dil != 1:
            raise ValueError(f"{what}: a stride of 2 takes a dilation of 1")
        kb = _mod("psm_blocks").k_block(Ci)
        _check(w, "packed", _mod("psm_blocks").packed_shape(k, Ci, Co), dt,
               dev)
    else:
        _check(w, "w", (k, k, Ci, Co), dt, dev)
    out = torch.empty((N, Ho, Wo, Co), dtype=dt, device=dev)
    _launch("mt_psm_conv", what, dev, code, x.data_ptr(), None, None,
            w.data_ptr(), scale.data_ptr(), shift.data_ptr(), _ptr(res),
            out.data_ptr(), N, H, W, Ci, 0, 0, Co, k * k, stride, dil,
            int(relu), kb)
    _count(counter)
    return out


@_fake("psm_conv")
def _psm_conv_fake(x, w, scale, shift, res, k, stride, dil, relu, counter):
    return x.new_empty(_psm_out(x, scale, stride))


# ---- spp_tail ---------------------------------------------------------------

@_impl("spp_tail")
def _spp_tail(raw, skip, br, w0, scale0, shift0, w1, cout):
    what = "spp_tail"
    sp = _mod("spp_tail")
    SPP_HIDDEN, SPP_KBLOCK = sp.HIDDEN, sp.KBLOCK
    SPP_MAX_OUT, SPP_MAX_KBLOCKS = sp.MAX_OUT, sp.MAX_KBLOCKS
    dt, dev = raw.dtype, raw.device
    code = _dtype(raw, what)
    N, H, W, C0 = raw.shape
    C1, C2 = skip.shape[-1], br.shape[-1]
    vec = 16 // raw.element_size()
    if C0 % vec or C1 % vec or C2 % vec:
        raise ValueError(f"{what}: channels ({C0}, {C1}, {C2}) must be "
                         f"multiples of {vec}")
    if cout % 16 or cout > SPP_MAX_OUT:
        raise ValueError(f"{what}: Cout={cout} must be a multiple of 16, "
                         f"at most {SPP_MAX_OUT}")
    _check(raw, "raw", (N, H, W, C0), dt, dev)
    _check(skip, "skip", (N, H, W, C1), dt, dev)
    _check(br, "br", (N, H, W, C2), dt, dev)
    _check(scale0, "scale0", (SPP_HIDDEN,), F32, dev)
    _check(shift0, "shift0", (SPP_HIDDEN,), F32, dev)
    zero = None
    if dt == torch.bfloat16:
        nkb = sum(_ceil(c, SPP_KBLOCK) // SPP_KBLOCK for c in (C0, C1, C2))
        if nkb > SPP_MAX_KBLOCKS:
            raise ValueError(f"{what}: {nkb} K blocks of {SPP_KBLOCK} "
                             f"channels, the kernel takes {SPP_MAX_KBLOCKS}")
        _check(w0, "packed w0", (nkb, 9, SPP_HIDDEN, SPP_KBLOCK), dt, dev)
        _check(w1, "packed w1", (2, 1, _ceil(cout, SPP_HIDDEN), SPP_KBLOCK),
               dt, dev)
    else:
        _check(w0, "w0", (3, 3, C0 + C1 + C2, SPP_HIDDEN), dt, dev)
        _check(w1, "w1", (SPP_HIDDEN, cout), dt, dev)
        zero = torch.zeros(cout, dtype=F32, device=dev)
    out = torch.empty((N, H, W, cout), dtype=dt, device=dev)
    _launch("mt_spp_tail", what, dev, code, raw.data_ptr(), skip.data_ptr(),
            br.data_ptr(), w0.data_ptr(), scale0.data_ptr(),
            shift0.data_ptr(), w1.data_ptr(), _ptr(zero), out.data_ptr(), N,
            H, W, C0, C1, C2, cout)
    _count("spp_tail")
    return out


@_fake("spp_tail")
def _spp_tail_fake(raw, skip, br, w0, scale0, shift0, w1, cout):
    return raw.new_empty((*raw.shape[:3], cout))


# ---- sweep_grad_src ---------------------------------------------------------

@_impl("sweep_grad_src")
def _sweep_grad_src(depth, ref, gbar, R, t, valid, K, rays):
    what = "sweep_grad_src"
    dev, mdt = ref.device, ref.dtype
    code = _dtype(ref, what)
    if ref.dim() != 4 or R.dim() != 4 or depth.dim() != 1:
        raise ValueError(f"{what}: ref_feat must be (B, H, W, C), R "
                         "(B, V, 3, 3) and d_center (D,)")
    B, H, W, C = ref.shape
    V, D = R.shape[1], depth.shape[0]
    MAX_C = _mod("sweep_grad_src").MAX_C
    if C > MAX_C:
        raise ValueError(f"{what}: C={C} is over {MAX_C}")
    for tt, name, shape, dt in (
            (depth, "d_center", (D,), F32), (ref, "ref_feat", (B, H, W, C),
                                              mdt),
            (gbar, "gbar", (B, H, W, D), F32), (R, "R", (B, V, 3, 3), F32),
            (t, "t", (B, V, 3), F32), (valid, "is_valid", (B, V), F32),
            (K, "intM", (B, 3, 3), F32), (rays, "rays2d", (B, 3, H * W), F32)):
        _check(tt, name, shape, dt, dev, 4)
    out = torch.empty((B, V, H, W, C), dtype=F32, device=dev)
    _launch("mt_sweep_grad_src", what, dev, code, depth.data_ptr(),
            ref.data_ptr(), gbar.data_ptr(), R.data_ptr(), t.data_ptr(),
            valid.data_ptr(), K.data_ptr(), rays.data_ptr(), out.data_ptr(),
            B, V, H, W, C, D)
    _count("sweep_grad_src")
    return out


@_fake("sweep_grad_src")
def _sweep_grad_src_fake(depth, ref, gbar, R, t, valid, K, rays):
    B, H, W, C = ref.shape
    return ref.new_empty((B, R.shape[1], H, W, C), dtype=F32)


# ---- sweep_grad_ref ---------------------------------------------------------

@_impl("sweep_grad_ref")
def _sweep_grad_ref(depth, src, gbar, R, t, valid, K, rays):
    what = "sweep_grad_ref"
    dev, mdt = src.device, src.dtype
    code = _dtype(src, what)
    if src.dim() != 5 or depth.dim() != 1:
        raise ValueError(f"{what}: src_feat must be (B, V, H, W, C) and "
                         "d_center (D,)")
    B, V, H, W, C = src.shape
    D = depth.shape[0]
    MAX_C, MAX_D = _mod("cost_volume_cw").MAX_C, _mod("cost_volume_cw").MAX_D
    if C % (16 // src.element_size()) or C > MAX_C:
        raise ValueError(f"{what}: C={C} must be a multiple of 16 bytes and "
                         f"at most {MAX_C}")
    if D > MAX_D:
        raise ValueError(f"{what}: D={D} is over {MAX_D}")
    for tt, name, shape, dt in (
            (depth, "d_center", (D,), F32),
            (src, "src_feat", (B, V, H, W, C), mdt),
            (gbar, "gbar", (B, H, W, D), F32), (R, "R", (B, V, 3, 3), F32),
            (t, "t", (B, V, 3), F32), (valid, "is_valid", (B, V), F32),
            (K, "intM", (B, 3, 3), F32), (rays, "rays2d", (B, 3, H * W), F32)):
        _check(tt, name, shape, dt, dev, 4)
    out = torch.empty((B, H, W, C), dtype=F32, device=dev)
    _launch("mt_sweep_grad_ref", what, dev, code, depth.data_ptr(),
            src.data_ptr(), gbar.data_ptr(), R.data_ptr(), t.data_ptr(),
            valid.data_ptr(), K.data_ptr(), rays.data_ptr(), out.data_ptr(),
            B, V, H, W, C, D)
    _count("sweep_grad_ref")
    return out


@_fake("sweep_grad_ref")
def _sweep_grad_ref_fake(depth, src, gbar, R, t, valid, K, rays):
    B, _, H, W, C = src.shape
    return src.new_empty((B, H, W, C), dtype=F32)


# ---- dw_conv ----------------------------------------------------------------

@_impl("dw_conv")
def _dw_conv(x, w):
    what = "dw_conv"
    dt, dev = x.dtype, x.device
    code = _dtype(x, what)
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (N, H, W, C)")
    N, H, W, C = x.shape
    K = w.shape[0]
    if K not in (3, 5) or C % (16 // x.element_size()):
        raise ValueError(f"{what}: window {K}, channels {C}")
    _check(x, "x", (N, H, W, C), dt, dev)
    _check(w, "w", (K, K, C), dt, dev)
    out = torch.empty_like(x)
    pt = (K - 1) // 2
    _launch("mt_dw_conv", what, dev, code, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), N, H, W, C, K, pt, pt)
    _count("dw_conv")
    return out


@_fake("dw_conv")
def _dw_conv_fake(x, w):
    return torch.empty_like(x)


# ---- mbconv_block: a chain of stacked MBConv blocks -------------------------

@_impl("mbconv_block")
def _mbconv_block(x, wpw, s1, wdw, s2, wse1, bse1, wse2, bse2, wpwl, s3, K):
    mb = _mod("mbconv_chain")
    what = "mbconv_chain"
    dt, dev = x.dtype, x.device
    code = _dtype(x, what)
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (N, H, W, C)")
    N, H, W, C = x.shape
    nb, _, M = wpw.shape
    R = wse1.shape[-1]
    vec = 16 // x.element_size()
    if K not in (3, 5) or C % vec or M % vec:
        raise ValueError(f"{what}: window {K}, channels ({C}, {M})")
    for t, name, shape, tdt in (
            (x, "x", (N, H, W, C), dt), (wpw, "wpw", (nb, C, M), dt),
            (s1, "s1", (nb, M), F32), (wdw, "wdw", (nb, K * K, M), dt),
            (s2, "s2", (nb, M), F32), (wse1, "wse1", (nb, M, R), F32),
            (bse1, "bse1", (nb, R), F32), (wse2, "wse2", (nb, R, M), F32),
            (bse2, "bse2", (nb, M), F32), (wpwl, "wpwl", (nb, M, C), dt),
            (s3, "s3", (nb, C), F32)):
        _check(t, name, shape, tdt, dev)
    p = mb.plan(N, H, W, C, M, R, K, x.element_size(),
                torch.cuda.get_device_properties(dev).multi_processor_count)
    tiles = N * p["tpf"] * p["ctiles"]
    d = torch.empty((N, H, W, M), dtype=dt, device=dev)
    pool = torch.empty((N, p["tiles"], M), dtype=F32, device=dev)
    separt = torch.empty((N, p["slices"], R), dtype=F32, device=dev)
    ws = torch.empty((tiles * p["splits"] if p["splits"] > 1 else 1,
                      mb.TM * mb.PN), dtype=F32, device=dev)
    counters = torch.zeros(N * p["slices"] + tiles, dtype=torch.int32,
                           device=dev)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    for b in range(nb):
        out = bufs[b % 2]
        _launch("mt_mbconv_block", what, dev, code, x.data_ptr(),
                wpw[b].data_ptr(), s1[b].data_ptr(), wdw[b].data_ptr(),
                s2[b].data_ptr(), wse1[b].data_ptr(), bse1[b].data_ptr(),
                wse2[b].data_ptr(), bse2[b].data_ptr(), wpwl[b].data_ptr(),
                s3[b].data_ptr(), d.data_ptr(), pool.data_ptr(),
                separt.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                out.data_ptr(), N, H, W, C, M, R, K, p["th"], p["tw"],
                p["kc"], *p["ex_layout"], *p["pr_layout"])
        _count("mbconv_block", mb.LAUNCHES_PER_BLOCK)
        x = out
    # the last block's buffer; the other one is scratch
    return x if nb else x.clone()


@_fake("mbconv_block")
def _mbconv_block_fake(x, wpw, s1, wdw, s2, wse1, bse1, wse2, bse2, wpwl,
                       s3, K):
    return torch.empty_like(x)


# ---- res_block --------------------------------------------------------------

@_impl("res_block")
def _res_block(x, w1, s1, t1, w2, s2, t2, dil):
    what = "res_block"
    dt, dev = x.dtype, x.device
    code = _dtype(x, what)
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (N, H, W, C)")
    N, H, W, C = x.shape
    if C % (16 // x.element_size()) or C > 128 or dil < 1:
        raise ValueError(f"{what}: channels {C}, dilation {dil}")
    RES_DILATIONS = _mod("res_block").DILATIONS
    if dt == torch.bfloat16 and dil not in RES_DILATIONS:
        raise ValueError(f"{what}: dilation {dil}, the bf16 kernel takes "
                         f"{RES_DILATIONS}")
    _check(x, "x", (N, H, W, C), dt, dev)
    wshape = (_mod("psm_blocks").packed_shape(3, C, C)
              if dt == torch.bfloat16
              else (3, 3, C, C))
    for name, w, s, t in (("1", w1, s1, t1), ("2", w2, s2, t2)):
        _check(w, "w" + name, wshape, dt, dev)
        _check(s, "s" + name, (C,), F32, dev)
        _check(t, "t" + name, (C,), F32, dev)
    out = torch.empty_like(x)
    _launch("mt_res_block", what, dev, code, x.data_ptr(), w1.data_ptr(),
            s1.data_ptr(), t1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
            t2.data_ptr(), out.data_ptr(), N, H, W, C, dil)
    _count("res_block")
    return out


@_fake("res_block")
def _res_block_fake(x, w1, s1, t1, w2, s2, t2, dil):
    return torch.empty_like(x)


def launch_counts() -> dict:
    """Each wrapper's ``launches``, by the counter's name."""
    return {name: getattr(_mod(path.split(".")[0]),
                          path.split(".")[1]).launches
            for name, path in COUNTERS.items()}


def op_names() -> list:
    """The operators, in ``build._SIGNATURES``' order."""
    return list(SCHEMAS)


assert [f"mt_{n}" for n in SCHEMAS] == list(build._SIGNATURES), \
    "one operator per C entry point"
