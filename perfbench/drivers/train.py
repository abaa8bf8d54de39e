"""Training steps: the general driver of training traffic.

Set-up builds the one training state (``program.fnet_training``: the model,
its optimizer and the step) from the seeded weights, stages
``distinct_batches`` batches made from the seed on the device, and drives
the state through its first ``checked_steps`` steps, one batch each, with
the window's own call: they are the warm-up and what the check compares
(each step's loss, the first step's softmaxed cost volume, the first
clipped gradient as the optimizer's first moment gives it back, and every
parameter's change over those steps). The window then goes on with the
same state, the batches in turn. A unit is a step.

One step of the window, drawn from the seed (reservoir sampling over all
its steps), is checked too: before it the state (parameters, Adam's
moments, the step count) is copied, after it the loss, the cost volume,
the first moment and the parameters are kept. The reference follows that
one step from the copied state, since it cannot reach it on its own: its
gradient, as the first moment's change gives it back, and the parameters'
change are held to the reference's, as are the loss and the cost volume.
"""

from __future__ import annotations

import random
import time

import torch

from perfbench import inputs, judge, program, weights
from perfbench.counts import model_flops
from perfbench.reference import nets, train as ref_train
from perfbench.reference.precision import Precision, plain_float32
from perfbench.spans import Spans

SPANS = {"fnet_fwd": "F-Net forward", "backward": "backward",
         "regather": "sweep backward: grad_ref (plain re-gather)",
         "update": "clip + AdamW"}


class Driver:
    unit = "train"

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.spans = None
        self.stage_times = None

    def layout(self):
        with torch.device("meta"):
            return nets.MagnetF(self.cfg["shape"]["fnet_feature_dim"])

    def weights(self):
        return weights.make_weights(self.layout(), self.seed, self.device,
                                    "train")

    def batches(self, B):
        g = torch.Generator(self.device).manual_seed(self.seed + 1)
        s = self.cfg["shape"]
        return [inputs.frame_set(g, B, s["V"], s, self.cfg["camera"],
                                 self.cfg["motion"], self.device,
                                 depth_m=self.cfg["train_depth_m"])
                for _ in range(self.mix["distinct_batches"])]

    def setup(self):
        t = time.perf_counter()
        self.state, self.step, _, self.args = \
            program.fnet_training(self.cfg["train_flags"], self.device,
                                  self.weights(), self.seed,
                                  self.cfg["train_total_steps"])
        self.data = self.batches(self.args.batch_size)
        self.setup_log = [("model and inputs", time.perf_counter() - t)]
        self.params = dict(self.state.model.named_parameters())
        start = {n: p.detach().clone() for n, p in self.params.items()}
        losses = []
        n = self.mix["checked_steps"]
        for i in range(n):
            if i == 0:
                cv, out = self._kept_step(self.data[0])
                first = self._moments()[0]
                b1 = ref_train.onecycle_beta1(0, self.total_steps())
                first = {k: m / (1 - b1) for k, m in first.items()}
            else:
                _, out = self.step(self.state, self.data[i])
            losses.append(out["loss"].detach())
        self.kept = {"losses": [float(x) for x in losses],
                     "cost_volume": cv, "first_grad": first,
                     "change": {k: p.detach() - start[k]
                                for k, p in self.params.items()}}
        self.window_step = None
        self.next = n
        self.setup_log.append(("first steps", time.perf_counter() - t))

    def total_steps(self):
        return self.cfg["train_total_steps"]

    def _moments(self):
        """Copies of Adam's (first, second) moments by parameter name;
        zeros before the first step."""
        st = self.state.optimizer.adamw.state
        return tuple({k: st[p][key].detach().clone() if key in st[p]
                      else torch.zeros_like(p)
                      for k, p in self.params.items()}
                     for key in ("exp_avg", "exp_avg_sq"))

    def _kept_step(self, batch):
        """One step through the window's own call, its softmaxed cost
        volume kept by a hook: (cost volume, the step's output)."""
        cvs = []
        hook = self.state.model.register_forward_hook(
            lambda m, a, out: cvs.append(out.detach().clone()))
        try:
            _, out = self.step(self.state, batch)
        finally:
            hook.remove()
        return cvs[0], out

    def _window_step(self, j):
        """The drawn step of the window on batch ``j``, with the state
        before it and what it gave."""
        count = self.state.optimizer.count
        params = {k: p.detach().clone() for k, p in self.params.items()}
        moments = self._moments()
        cv, out = self._kept_step(self.data[j])
        self.window_step = {
            "batch": j, "count": count, "params": params,
            "moments": moments, "loss": out["loss"].detach(),
            "cost_volume": cv, "first_after": self._moments()[0],
            "params_after": {k: p.detach().clone()
                             for k, p in self.params.items()}}

    def run_units(self, n_steps=None, seconds=None, keep=True):
        """Steps until ``n_steps`` are done or ``seconds`` have passed;
        returns (steps, elapsed s). With ``keep`` one of them, drawn from
        the seed, is kept for the check."""
        rng = random.Random(self.seed)
        i = 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            if n_steps is not None and i >= n_steps:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            j = self.next % len(self.data)
            # reservoir of one: every step of the window equally likely
            if keep and rng.random() * (i + 1) < 1:
                self._window_step(j)
            else:
                self.step(self.state, self.data[j])
            self.next += 1
            i += 1
        self._sync()
        return i, time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def units_of(self, steps):
        return steps

    def model_flops_per_unit(self):
        """One step's model FLOPs (``counts.model_flops.train_flops``)."""
        return model_flops.train_flops(self.cfg["shape"],
                                       self.args.batch_size)

    def open_spans(self):
        self.spans = Spans(self.device)
        if self.device.type == "cuda":
            self.stage_times = program.stage_times().__enter__()
        return self.spans

    def close_spans(self):
        if self.stage_times is not None:
            for key, name in SPANS.items():
                for pair in self.stage_times.events.get(name, []):
                    self.spans.events[key].append(pair)
            self.stage_times.__exit__(None, None, None)
            self.stage_times = None

    def release(self):
        for name in ("state", "step", "params"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, precision, params):
        plain_float32()
        ref = self.layout().to_empty(device=self.device)
        ref.load_state_dict(self.weights())
        if params is not None:
            with torch.no_grad():
                for k, p in ref.named_parameters():
                    p.copy_(params[k])
        return nets.set_precision(ref, Precision(precision))

    def _opt(self):
        a = self.args
        return dict(lr=a.lr, total_steps=self.total_steps(),
                    div_factor=a.div_factor,
                    final_div_factor=a.final_div_factor,
                    weight_decay=a.weight_decay, grad_clip=a.grad_clip,
                    max_depth=a.max_depth, min_depth=a.min_depth)

    def _d_center(self):
        a = self.args
        return ref_train.sid_centers(a.min_depth, a.max_depth,
                                     a.FNET_num_depth_bins).to(self.device)

    @staticmethod
    def _rows(batches, rows):
        if rows is None:
            return batches
        return [{k: v[:rows] for k, v in b.items()} for b in batches]

    def reference_out(self, precision="float32", rows=None):
        """The reference's first steps from the same weights and batches:
        each step's loss, the first step's cost volume, the first clipped
        gradient and each parameter's change. ``rows`` keeps that many rows
        of each batch (a fault the check must catch: part of the batch left
        out)."""
        ref = self._reference(precision, None)
        start = {n: p.detach().clone() for n, p in ref.named_parameters()}
        batches = self._rows(self.data[:self.mix["checked_steps"]], rows)
        out = ref_train.train_steps(ref, batches, self._d_center(),
                                    self._opt())
        out["change"] = {n: p.detach() - start[n]
                         for n, p in ref.named_parameters()}
        return out

    def window_out(self):
        """The drawn window step as the program took it: its loss, cost
        volume, clipped gradient (from the first moment's change) and the
        parameters' change."""
        w = self.window_step
        b1 = ref_train.onecycle_beta1(w["count"], self.total_steps())
        m0 = w["moments"][0]
        return {"losses": [float(w["loss"])],
                "cost_volume": w["cost_volume"],
                "first_grad": {k: (m - b1 * m0[k]) / (1 - b1)
                               for k, m in w["first_after"].items()},
                "change": {k: p - w["params"][k]
                           for k, p in w["params_after"].items()}}

    def reference_window(self, precision="float32", rows=None):
        """The reference's step from the state before the drawn window
        step, on the same batch."""
        w = self.window_step
        ref = self._reference(precision, w["params"])
        batches = self._rows([self.data[w["batch"]]], rows)
        out = ref_train.train_steps(ref, batches, self._d_center(),
                                    self._opt(), start=w["count"],
                                    moments=w["moments"])
        out["change"] = {n: p.detach() - w["params"][n]
                         for n, p in ref.named_parameters()}
        return out

    def numbers(self, subject="program"):
        """``judge.train_numbers`` of the first steps and, with ``win_`` in
        front, of the drawn window step, against the reference's: the
        program's, or (``subject`` "fp8") the reference computed in fp8
        put in the program's place."""
        control = subject != "program"
        first = self.reference_out(subject) if control else self.kept
        out = judge.train_numbers(first, self.reference_out())
        if self.window_step is not None:
            win = (self.reference_window(subject) if control
                   else self.window_out())
            out.update({"win_" + k: v for k, v in judge.train_numbers(
                win, self.reference_window()).items()})
        return out

    def compared(self):
        return self.mix["checked_steps"] + (self.window_step is not None)
