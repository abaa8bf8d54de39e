"""Serving export: the inference functions as ``torch.export`` programs.

The port of ``magnet_tpu/serve/export.py``. The forward (and the streaming
``encode``/``fuse`` pair) is traced once at a fixed shape with
``torch.export.export(strict=False)`` and serialized with
``torch.export.save``; a serving host runs it with no Python model code:

    blob = export_monolithic(model, img_h=480, img_w=640, n_views=4)
    fn = load_exported(blob)
    pred = fn(state_dict, ref, srcs, R, t, valid, intM, rays)

The weights are the function's first argument (the model's f32 state dict,
as ``model.state_dict()`` or a checkpoint gives it), not constants of the
program, so one artifact serves every checkpoint of the architecture. The
compute-dtype cast (``models/build.cast_for_inference``'s policy) and the
kernels' operand packing are traced into the program
(``torch.func.functional_call``; ``nn/layers.cached_fold`` folds afresh
while a program is traced).

Device note: the trace follows the device of the model. On a card the
program holds the port's kernels as the operators of
``kernels/ops.py`` (``torch.ops.magnet_tpu_torch.*``), as a JAX export on a
TPU host holds its Pallas kernels, and loading it needs that module
imported (``load_exported`` imports it); on the CPU it holds the kernels'
plain versions, as a JAX export on the CPU holds the XLA path.
"""

from __future__ import annotations

import io
from typing import Optional

import torch
import torch.nn as nn

from magnet_tpu_torch.nn.efficientnet import SqueezeExcite
from magnet_tpu_torch.nn.layers import WSConv2d, cast


def cast_keys(model: nn.Module) -> frozenset:
    """The state-dict keys that ``cast_for_inference`` casts to the compute
    dtype: the weights and biases of the convs other than the
    squeeze-excitation's and the weight-standardised ones."""
    skip = {id(c) for m in model.modules() if isinstance(m, SqueezeExcite)
            for c in m.modules()}
    keys = set()
    for name, m in model.named_modules():
        if (isinstance(m, nn.Conv2d) and not isinstance(m, WSConv2d)
                and id(m) not in skip):
            keys.update(f"{name}.{p}" for p, _ in m.named_parameters())
    return frozenset(keys)


def f32_state(model: nn.Module) -> dict:
    """The model's state dict with every floating tensor in f32: the
    exported functions' first argument."""
    return {k: v.detach().float() if v.is_floating_point() else v.detach()
            for k, v in model.state_dict().items()}


class _Call(nn.Module):
    """``model.<method>(*args, **kwargs)`` as a module's forward."""

    def __init__(self, model: nn.Module, method: str, kwargs: dict):
        super().__init__()
        self.model, self.method, self.kwargs = model, method, kwargs

    def forward(self, *args):
        return getattr(self.model, self.method)(*args, **self.kwargs)


class _Program(nn.Module):
    """``method(*args)`` of a model whose weights come in as a state dict,
    cast on the way (``torch.func.functional_call``). The model is held
    outside the module tree, so the exported program carries none of its
    weights. The first ``n_images`` arguments are cast to the compute
    dtype."""

    def __init__(self, model: nn.Module, method: str, dtype: torch.dtype,
                 n_images: int, **kwargs):
        super().__init__()
        self.__dict__["_call"] = _Call(model, method, kwargs)
        self.method, self.dtype, self.n_images = method, dtype, n_images
        self.casts = cast_keys(model)

    def forward(self, state: dict, *args):
        weights = {"model." + k: cast(v, self.dtype) if k in self.casts
                   else v for k, v in state.items()}
        args = ([cast(a, self.dtype) for a in args[:self.n_images]]
                + list(args[self.n_images:]))
        out = torch.func.functional_call(self._call, weights, tuple(args))
        return out[-1] if self.method in ("forward", "fuse") else tuple(out)


def _geometry(batch: int, n_views: int, h: int, w: int, device) -> list:
    z = dict(dtype=torch.float32, device=device)
    eye = torch.eye(3, **z)
    return [eye.expand(batch, n_views, 3, 3).contiguous(),      # R
            torch.zeros(batch, n_views, 3, **z),                # t
            torch.ones(batch, n_views, **z),                    # is_valid
            eye.expand(batch, 3, 3).contiguous(),               # intM
            torch.zeros(batch, 3, h * w, **z)]                  # rays2d


def _export(model: nn.Module, method: str, dtype, n_images: int, args,
            **kwargs) -> bytes:
    program = _Program(model.eval(), method, dtype, n_images, **kwargs)
    with torch.no_grad():
        ep = torch.export.export(program, (f32_state(model), *args),
                                 strict=False)
    # the example inputs would carry the weights into the artifact
    ep._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_monolithic(model: nn.Module, img_h: int, img_w: int,
                      n_views: int, batch: int = 1,
                      n_iters: Optional[int] = None,
                      compute_dtype: torch.dtype = torch.bfloat16) -> bytes:
    """The whole forward (``Magnet.forward``, the reference test_MaGNet
    protocol): (state, ref_img (B, H, W, 3), src_imgs (B, V, H, W, 3), R,
    t, is_valid, intM, rays2d at H/4 x W/4, all f32) -> the last
    iteration's (B, H, W, 2) (mu, sigma)."""
    dev = _device(model)
    imgs = [torch.zeros(batch, img_h, img_w, 3, device=dev),
            torch.zeros(batch, n_views, img_h, img_w, 3, device=dev)]
    return _export(model, "forward", compute_dtype, 2,
                   imgs + _geometry(batch, n_views, img_h // 4, img_w // 4,
                                    dev), n_iters=n_iters)


def export_encode(model: nn.Module, img_h: int, img_w: int, batch: int = 1,
                  compute_dtype: torch.dtype = torch.bfloat16) -> bytes:
    """The streaming per-frame encode (``Magnet.encode``): (state, imgs
    (N, H, W, 3) f32) -> (gauss, feat_d, feat_m) in the compute dtype."""
    imgs = torch.zeros(batch, img_h, img_w, 3, device=_device(model))
    return _export(model, "encode", compute_dtype, 1, [imgs])


def encode_shapes(model: nn.Module, img_h: int, img_w: int, batch: int,
                  compute_dtype: torch.dtype) -> list:
    """(shape, dtype) of each of ``encode``'s outputs at this size: one
    eager call of the function ``export_encode`` traces, on zeros."""
    imgs = torch.zeros(batch, img_h, img_w, 3, device=_device(model))
    program = _Program(model.eval(), "encode", compute_dtype, 1)
    with torch.no_grad():
        outs = program(f32_state(model), imgs)
    return [(tuple(o.shape), o.dtype) for o in outs]


def export_fuse(model: nn.Module, img_h: int, img_w: int, n_views: int,
                batch: int = 1, n_iters: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> bytes:
    """The streaming fusion (``Magnet.fuse``): (state, ref_gauss, x_d3,
    ref_feat, src_gauss (B, V, ...), src_feat (B, V, ...), R, t, is_valid,
    intM, rays2d) -> the last iteration's (B, H, W, 2); the encodings'
    shapes and dtypes are ``encode``'s at this size."""
    dev = _device(model)
    (gs, gdt), (ds, ddt), (ms, mdt) = encode_shapes(model, img_h, img_w,
                                                    batch, compute_dtype)
    enc = [torch.zeros(gs, dtype=gdt, device=dev),
           torch.zeros(ds, dtype=ddt, device=dev),
           torch.zeros(ms, dtype=mdt, device=dev),
           torch.zeros((batch, n_views) + gs[1:], dtype=gdt, device=dev),
           torch.zeros((batch, n_views) + ms[1:], dtype=mdt, device=dev)]
    return _export(model, "fuse", compute_dtype, 0,
                   enc + _geometry(batch, n_views, img_h // 4, img_w // 4,
                                   dev), n_iters=n_iters)


class Served(nn.Module):
    """A loaded program, called with the exported function's arguments. The
    trace took its inputs contiguous, and a ``.contiguous()`` of a
    contiguous tensor is not recorded, so the arguments are made contiguous
    here before they reach the program (the kernels' operators take
    contiguous operands)."""

    def __init__(self, program: nn.Module):
        super().__init__()
        self.program = program

    @property
    def graph(self):
        return self.program.graph

    def forward(self, state: dict, *args):
        return self.program({k: v.contiguous() for k, v in state.items()},
                            *[a.contiguous() for a in args])


def load_exported(blob: bytes) -> Served:
    """The program serialized in ``blob``, as a callable module taking the
    exported function's arguments. Registers the kernels' operators
    first."""
    from magnet_tpu_torch.kernels import ops  # noqa: F401
    return Served(torch.export.load(io.BytesIO(blob)).module())


def op_counts(program) -> dict:
    """How many times each ``magnet_tpu_torch`` operator stands in the graph
    of a program (``load_exported``'s module or an ``ExportedProgram``)."""
    counts = {}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", None)
        name = name() if callable(name) else ""
        if node.op == "call_function" and name.startswith(
                "magnet_tpu_torch::"):
            op = name.split("::")[1].split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return counts
