"""The arithmetic a reference convolution runs in.

``Precision`` rounds what enters a convolution: "float32" leaves both
operands as they are; "fp8" rounds the input and the weight to
float8_e4m3fn, each with a scale of its own that maps its largest magnitude
to the format's largest finite value, the per-tensor scaling an fp8 path
would use, convolves the rounded values in float32, and rounds the gradient
that flows back through each operand to float8_e5m2 the same way, as fp8
training keeps its gradients. The fp8 form is the benchmark's control: the
reference computed one precision below the bfloat16 that the
configurations state. "bfloat16" rounds the same operands and gradients to
bfloat16 (no scale: it has float32's range): the reference at the
configurations' own precision, a witness of what bfloat16 rounding alone
does to a number that the check compares.
"""

from __future__ import annotations

import torch

NAMES = ("float32", "fp8", "bfloat16")


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


class _RoundBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


_ROUND = {"fp8": _RoundFP8.apply, "bfloat16": _RoundBF16.apply}


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in NAMES:
            raise ValueError(f"unknown precision {name!r}; one of {NAMES}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "float32" else _ROUND[self.name](x)


def plain_float32() -> None:
    """Matrix products and convolutions in true float32 on the card: no
    TF32, which would round their operands to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
