"""Depth maps from frame sets: the general driver of inference traffic.

A mix's parameters (``traffic/<mix>.json``): the driver runs
``Magnet.forward`` under ``torch.inference_mode`` on batches of ``batch``
reference frames with their source views, a closed loop with
``in_flight`` forwards in flight (each batch's inputs are uploaded from
pinned host memory on a stream of their own while the device runs the
forward before it; each last map goes back to pinned host memory, and the
loop waits only for the forward ``in_flight`` back). The frame sets cycle
through ``distinct_batches`` made from the seed. A unit of work is a map:
one reference frame.

Checked: a sample of ``checked_forwards`` forwards drawn from the seed
over the whole window (reservoir sampling): every iteration's map of them,
and the D-Net's and F-Net's outputs of those forwards (forward hooks on the
model keep a reference to the forward in hand's; a drawn forward's are
copied). The reference encodes the same frames, and runs the fusion from
the program's own encodings: so each stage is held by itself
(``judge.frame_numbers``). It also runs the fusion from its own encodings,
for the whole pipeline's gap (``map_*``), which is read but not limited,
and the witness, the reference in bfloat16, on the same frames and
encodings (``judge.witnessed``).
"""

from __future__ import annotations

import math
import random
import time

import torch

from perfbench import inputs, judge, program, weights
from perfbench.counts import model_flops
from perfbench.reference import magnet as ref_magnet, nets
from perfbench.reference.precision import Precision, plain_float32
from perfbench.spans import Spans


class Driver:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.unit = "maps"
        self.B = mix["batch"]
        self.spans = None

    # ---- set-up ----------------------------------------------------------
    def layout(self):
        s = self.cfg["shape"]
        with torch.device("meta"):
            return nets.Magnet(s["n_samples"], s["fnet_feature_dim"], s["k"])

    def weights(self):
        return weights.make_weights(self.layout(), self.seed, self.device,
                                    "eval", self.cfg.get("pins"))

    def frame_sets(self):
        g = torch.Generator(self.device).manual_seed(self.seed + 1)
        s = self.cfg["shape"]
        return [inputs.frame_set(g, self.B, s["V"], s, self.cfg["camera"],
                                 self.cfg["motion"], self.device)
                for _ in range(self.mix["distinct_batches"])]

    def setup(self):
        t = time.perf_counter()
        self.model, self.args = program.magnet(self.cfg["test_flags"],
                                               self.device, self.weights())
        self.setup_log = [("model", time.perf_counter() - t)]
        self.dtype = program.compute_dtype(self.args)
        self.n_iters = self.args.MAGNET_num_test_iter
        sets = self.frame_sets()
        pin = self.device.type == "cuda"
        keys = list(sets[0])
        self.host_sets = [
            [(fs[k].to(self.dtype) if k.endswith("img") or
              k.endswith("imgs") else fs[k]).cpu() for k in keys]
            for fs in sets]
        if pin:
            self.host_sets = [[t.pin_memory() for t in hs]
                              for hs in self.host_sets]
        self.slots = [[torch.empty_like(t, device=self.device)
                       for t in self.host_sets[0]]
                      for _ in range(self.mix["in_flight"])]
        H, W = self.cfg["shape"]["H"], self.cfg["shape"]["W"]
        self.host_out = [torch.empty((self.B, H, W, 2), dtype=self.dtype,
                                     pin_memory=pin)
                         for _ in range(self.mix["in_flight"])]
        self.copy_stream = torch.cuda.Stream(self.device) if pin else None
        del sets
        # the encodings of the forward in hand, kept with its maps when the
        # sample draws it
        self._enc = {}
        self.model.d_net.register_forward_hook(
            lambda m, a, out: self._enc.__setitem__("d", out))
        self.model.f_net.register_forward_hook(
            lambda m, a, out: self._enc.__setitem__("f", out))
        self.setup_log.append(("inputs", time.perf_counter() - t))
        # warm up the one shape the traffic uses
        self.run_units(2, keep=False)
        self.setup_log.append(("warm-up", time.perf_counter() - t))

    # ---- the traffic -----------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _event(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _batched(self, j, slot):
        """Enqueues a forward on frame set ``j`` in ``slot``."""
        dev_in, host_in = self.slots[slot], self.host_sets[j]
        cs = self.copy_stream
        if cs is not None:
            # the slot is free: the loop has waited for its last forward
            with torch.cuda.stream(cs):
                for d, h in zip(dev_in, host_in):
                    d.copy_(h, non_blocking=True)
            torch.cuda.current_stream(self.device).wait_stream(cs)
        else:
            for d, h in zip(dev_in, host_in):
                d.copy_(h)
        with torch.inference_mode():
            preds = self.model(*dev_in, n_iters=self.n_iters)
        self.host_out[slot].copy_(preds[-1], non_blocking=cs is not None)
        return preds, self._event()

    def run_units(self, n_forwards=None, seconds=None, keep=True):
        """Runs forwards until ``n_forwards`` are done or ``seconds`` have
        passed; returns (forwards, elapsed s)."""
        rng = random.Random(self.seed)
        k = self.mix["checked_forwards"]
        if keep:
            self.kept = []
        pending = {}
        i = 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            if n_forwards is not None and i >= n_forwards:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            j = i % len(self.host_sets)
            slot = i % self.mix["in_flight"]
            if slot in pending and pending[slot] is not None:
                pending[slot].synchronize()
            maps, pending[slot] = self._batched(j, slot)
            if keep:
                # reservoir: every forward of the window equally likely
                slot = (len(self.kept) if len(self.kept) < k
                        else rng.randrange(k) if rng.random() < k / (i + 1)
                        else None)
                if slot is not None:
                    enc = [t.clone() for t in (*self._enc["d"],
                                               self._enc["f"])]
                    item = (j, [m.clone() for m in maps], enc)
                    if slot == len(self.kept):
                        self.kept.append(item)
                    else:
                        self.kept[slot] = item
            i += 1
        self._sync()
        return i, time.perf_counter() - t0

    def units_of(self, forwards):
        return forwards * self.B

    def model_flops_per_unit(self):
        """One map's model FLOPs (``counts.model_flops.frame_flops``)."""
        return model_flops.frame_flops(self.cfg["shape"])

    # ---- traced run --------------------------------------------------------
    def open_spans(self):
        self.spans = Spans(self.device)
        self.spans.host("host_issue", self.model)
        self.spans.on_module("dnet", self.model.d_net)
        self.spans.on_module("fnet", self.model.f_net)
        self.spans.on_method("fuse", self.model, "fuse")
        return self.spans

    def close_spans(self):
        if self.spans is not None:
            self.spans.close()

    # ---- the check ---------------------------------------------------------
    def release(self):
        """Frees the program's state; the kept outputs stay."""
        for name in ("model", "slots", "copy_stream"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="float32"):
        plain_float32()
        ref = self.layout().to_empty(device=self.device)
        ref.load_state_dict(self.weights())
        return nets.set_precision(ref.eval(), Precision(precision))

    def numbers(self, subject="program"):
        """The numbers of ``judge.frame_numbers`` and ``map_numbers``, the
        worst over every frame of the kept forwards, and their ratios to
        the bfloat16 witness's (``judge.witnessed``): the program's, or
        (``subject`` "fp8") the reference computed in fp8 put in the
        program's place."""
        s, B, V = self.cfg["shape"], self.B, self.cfg["shape"]["V"]
        ref = self.reference()
        other = None if subject == "program" else self.reference(subject)
        witness = self.reference("bfloat16")
        k_list = ref_magnet.sampling_offsets(s["sampling_range"],
                                             s["n_samples"]).to(self.device)
        sets = self.frame_sets()
        worst, wit = {}, {}
        for j, maps, enc in self.kept:
            fs = sets[j]
            if (any(t.shape[0] != B * (V + 1) for t in enc)
                    or any(m.shape[0] != B for m in maps)):
                # the program left frames out: nothing to hold them to
                return dict.fromkeys(
                    judge.FRAME_NUMBERS + judge.WITNESS_NUMBERS, math.inf)
            for b in range(B):
                rows = [b] + list(range(B + b * V, B + (b + 1) * V))
                prog_enc = [ref_magnet.nchw(t[rows].float()) for t in enc]
                geo = [fs[k][b] for k in ("R", "t", "is_valid", "intM",
                                          "rays2d")]
                ref_enc = ref_magnet.encode(ref, fs["ref_img"][b],
                                            fs["src_imgs"][b])
                fuse = [s["n_iters"], s["kappa"], k_list, s["k"]]
                if other is None:
                    subj_enc = prog_enc
                    subj_maps = subj_whole = [m[b] for m in maps]
                else:
                    subj_enc = ref_magnet.encode(other, fs["ref_img"][b],
                                                 fs["src_imgs"][b])
                    subj_maps = ref_magnet.fuse(other, *prog_enc, *geo,
                                                *fuse)
                    subj_whole = ref_magnet.fuse(other, *subj_enc, *geo,
                                                 *fuse)
                ref_maps = ref_magnet.fuse(ref, *prog_enc, *geo, *fuse)
                nums = judge.frame_numbers(subj_enc, ref_enc, subj_maps,
                                           ref_maps)
                nums.update(judge.map_numbers(
                    subj_whole, ref_magnet.fuse(ref, *ref_enc, *geo, *fuse)))
                for key, v in nums.items():
                    worst[key] = max(worst.get(key, 0.0), v)
                # what bfloat16 rounding alone gives on this frame
                w_gauss = ref_magnet.encode(witness, fs["ref_img"][b],
                                            fs["src_imgs"][b],
                                            feature=False)
                w_maps = ref_magnet.fuse(witness, *prog_enc, *geo, *fuse)
                w_nums = judge.frame_numbers(
                    (w_gauss, *subj_enc[1:]), ref_enc, w_maps, ref_maps)
                for key in judge.WITNESSED:
                    wit[key] = max(wit.get(key, 0.0), w_nums[key])
        worst.update(judge.witnessed(worst, wit))
        return worst

    def compared(self):
        return len(self.kept) * self.B
