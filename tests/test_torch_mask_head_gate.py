"""The gates that ``chip_smoke.py`` phase 13 holds a bf16 stage-3 step's
mask head to (``chip_smoke.mask_head_gates``): the mask logits' gradient
against the f32 head's, each conv's output against its exactly rounded bf16
result on the step's own input, and the head's gradients against the f64
backward through the step's own conv outputs. On the CPU, at a tiny head,
with PyTorch's bf16 convs: an honest bf16 step passes all three, and a fault
planted in one of its captured tensors fails the gate that holds it."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from magnet_tpu_torch.models.magnet import magnet_mask_head
from magnet_tpu_torch.nn.layers import conv2d, nchw, nhwc
from magnet_tpu_torch.ops.upsample import upsample_via_mask
from magnet_tpu_torch.train import steps

from test_torch_kernels import torch_threads  # noqa: F401

C_IN, HIDDEN, K = 16, 8, 4
B, HC, WC = 2, 6, 8
ARGS = types.SimpleNamespace(loss_gamma=0.8, max_depth=10.0, min_depth=1e-3)


def make_case() -> tuple:
    """A tiny mask head, its bf16 decoder feature, three bf16 coarse
    (mu, sigma) maps and a depth batch, made from a seed with numpy."""
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    head = magnet_mask_head(C_IN, 9 * K * K, hidden=HIDDEN)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(0, 0.3, p.shape).astype(np.float32)))
    x16 = torch.from_numpy(rng.normal(size=(B, HC, WC, C_IN)).astype(
        np.float32)).bfloat16()
    coarse = [torch.from_numpy(np.stack([
        rng.uniform(1, 6, (B, HC, WC)), rng.uniform(0.2, 1, (B, HC, WC))],
        -1).astype(np.float32)).bfloat16() for _ in range(3)]
    depth = torch.from_numpy(rng.uniform(
        0.5, 8, (B, HC * K, WC * K)).astype(np.float32))
    return head, x16, coarse, dict(depth=depth)


@pytest.fixture(scope="module")
def case():
    return make_case()


def bf16_step(head, x16, coarse, batch) -> dict:
    """The mask head's part of a bf16 stage-3 step, as the training path
    runs it (``run_head`` in train mode: the plain convs in x's dtype), with
    what ``chip_smoke.capture_bf16_step`` takes of it."""
    head.zero_grad(set_to_none=True)
    y, ins, outs = nchw(x16), [], []
    for m in head:
        if isinstance(m, torch.nn.Conv2d):
            ins.append(y.detach())
            y = conv2d(y, m)
            outs.append(y.detach())
        else:
            y = m(y)
    logits = nhwc(y)
    logits.retain_grad()
    preds = upsample_via_mask(coarse, logits, K)
    loss = steps.magnet_preds_loss(preds, batch["depth"], ARGS.loss_gamma,
                                   ARGS.max_depth, ARGS.min_depth)
    loss.backward()
    grads = {f"mask_head.{n}": p.grad.detach().clone()
             for n, p in head.named_parameters()}
    head.zero_grad(set_to_none=True)
    return dict(step=(float(loss.detach()), grads), coarse=coarse, x=x16,
                ins=ins, outs=outs, dlogits=logits.grad.detach())


def failures(case, cap) -> list:
    head, _, _, batch = case
    return cs.mask_head_failures(cs.mask_head_gates(head, K, cap, batch,
                                                    ARGS))


def test_honest_bf16_step_passes_every_gate(case):
    head, x16, coarse, batch = case
    cap = bf16_step(head, x16, coarse, batch)
    r = cs.mask_head_gates(head, K, cap, batch, ARGS)
    assert cs.mask_head_failures(r) == []
    assert len(r["forward"]) == 4
    assert r["upstream"]["rel_max"] > 0 and r["backward"]["grad"] > 0
    assert set(r["end_to_end"]["rel_l2"]) == set(cap["step"][1])


def _move(t: torch.Tensor, share: float) -> torch.Tensor:
    """t with a few elements moved by ``share`` of max|t|."""
    out = t.contiguous().clone()
    out.view(-1)[::out.numel() // 5] += share * t.abs().max()
    return out


@pytest.mark.parametrize("fault,gate", [
    ("conv 2 output", "mask-head conv 2 forward"),
    ("weight gradient", "mask-head backward"),
    ("mask-logit gradient", "mask-head upstream"),
])
def test_planted_fault_fails_its_gate(case, fault, gate):
    head, x16, coarse, batch = case
    cap = bf16_step(head, x16, coarse, batch)
    if fault == "conv 2 output":
        cap["outs"][2] = _move(cap["outs"][2], 0.05)
    elif fault == "weight gradient":
        grads = dict(cap["step"][1])
        grads["mask_head.2.weight"] = grads["mask_head.2.weight"] * 1.1
        cap["step"] = (cap["step"][0], grads)
    else:
        cap["dlogits"] = _move(cap["dlogits"], 0.05)
    failed = failures(case, cap)
    assert any(f.startswith(gate) for f in failed), failed


def test_f64_backward_through_given_forward_is_autograd(case):
    """``head64`` with ``actual`` equal to the f64 head's own conv outputs
    gives plain f64 autograd's gradients."""
    head, x16, _, _ = case
    rng = np.random.default_rng(1)
    dz = torch.from_numpy(rng.normal(size=(B, HC, WC, 9 * K * K)))
    outs = []
    plain, z = cs.head64(head, x16, False, outs=outs)
    z.backward(dz)
    given, z = cs.head64(head, x16, False, actual=outs)
    z.backward(dz)
    assert plain.keys() == given.keys()
    for n, p in plain.items():
        torch.testing.assert_close(given[n].grad, p.grad, rtol=0,
                                   atol=1e-12 * p.grad.abs().max().item())
