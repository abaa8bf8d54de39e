"""Depth maps from single images: the general driver of single-view
inference traffic.

A mix's parameters (``traffic/<mix>.json``): the driver builds the
program's single-view model (``models.build.build_adabins`` from the
configuration's ``test_flags``, on the meta device, then the benchmark's
seeded weights, cast by ``cast_for_inference``) and runs its forward under
``torch.inference_mode`` on batches of ``batch`` images, a closed loop
with ``in_flight`` forwards in flight: each batch is uploaded from pinned
host memory on a stream of its own while the device runs the forward
before it, each depth map goes back to pinned host memory, and the loop
waits only for the forward ``in_flight`` back. The images
(``inputs.images``) cycle through ``distinct_batches`` made from the seed.
A unit of work is a map: one image.

Weights: ``weights.make_weights`` from the seed with the configuration's
``pins``; then the conv that the configuration names ``standardise`` is
rescaled (``standardise``) so that its output, on the first seeded image
through the float32 reference, has per channel a mean of 0 and a standard
deviation of 1 over the image, as a trained network's normalised feature
has. A random network's feature is otherwise nearly constant over an
image (its spatial deviation about a tenth of its mean): the maps drawn
from it would be flat, and a head that flattens them would pass.

Checked: a sample of ``checked_forwards`` forwards drawn from the seed
over the whole window (reservoir sampling): their bin edges, depth maps
and decoder features u (a forward hook on the decoder keeps the forward in
hand's; a drawn forward's are copied). The reference
(``reference/adabins.py``) runs each image, a few at a time, and each
stage is held by itself (``numbers``):

* ``dec_rel``: u against the reference's from the same image, mean |diff|
  over mean |ref|;
* ``edges_rel``: the bin edges against the reference's mini-ViT run from
  the program's u, max |diff| over the reference edges' range;
* ``depth_rel``: the depth against the reference's mini-ViT and bins head
  run from the program's u, rms diff over the reference depth's standard
  deviation;
* ``depth_wit``: ``depth_rel`` over the same of the witness, the
  reference in bfloat16 from the same u (``judge.witnessed``' rule);
* ``head_bins``: the bins head by itself, in bins: the depth against the
  reference's probabilities from the program's u weighing the centres of
  the program's own edges, the median over the map of |diff| over the
  mean bin width ((max - min) / bins), whatever the map's spread. A depth
  flattened, or off by half a bin everywhere, reads about 0.5 or more;
  rounding reads far less, since its large errors sit at the rim, where
  the standardised feature is largest and rounding flips near-tied bins;
* ``map_rel``: the whole pipeline, the depth against the reference's from
  its own u; read, and not limited.

Each is the worst over the images. The traced run records the program's
spans (``utils.profiling.StageTimes``) under the keys of ``SPANS``.
"""

from __future__ import annotations

import math
import random
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import inputs, judge, program, weights
from perfbench.reference import adabins as ref_adabins
from perfbench.reference.precision import Precision, plain_float32
from perfbench.spans import Spans

SPANS = {"trunk": "AdaBins trunk", "decoder": "AdaBins decoder",
         "vit": "mViT", "bins": "bins head"}
NUMBERS = ("dec_rel", "edges_rel", "depth_rel", "depth_wit", "head_bins",
           "map_rel")
# images a reference call takes: a few 352x1216 images in float32 at a time
CHUNK = 4


def edges_gap(p, r) -> float:
    """max |p - r| over the range of r, per row of bin edges; inf where p
    cannot be held to r."""
    if p.shape != r.shape or not torch.isfinite(p).all():
        return math.inf
    return float((p.float() - r).abs().max() / (r.max() - r.min()))


def bins_gap(p, r, edges) -> float:
    """The median over the map of |p - r|, over the mean width of the bins
    that ``edges`` bound; inf as ``judge.spread_rel``."""
    if p.shape != r.shape or not torch.isfinite(p).all():
        return math.inf
    width = (edges[-1] - edges[0]) / (edges.numel() - 1)
    return float((p.float() - r).abs().flatten().median() / width)


@torch.no_grad()
def standardise(sd, layout, name, x):
    """``sd`` with the conv ``name`` rescaled, weight and bias, so that its
    output over the image x (1, 3, H, W) in the float32 reference (the
    module ``layout``, on any device) has per channel a mean of 0 and a
    standard deviation of 1."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    plain_float32()
    ref = layout.to_empty(device=x.device)
    ref.load_state_dict(sd)
    out = []
    hook = ref.get_submodule(name).register_forward_hook(
        lambda m, a, y: out.append(y))
    ref.eval()(x)
    hook.remove()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = flags
    y = out[0][0].flatten(1)
    mean, std = y.mean(1), y.std(1)
    sd = dict(sd)
    sd[name + ".weight"] = sd[name + ".weight"] / std.view(-1, 1, 1, 1)
    sd[name + ".bias"] = (sd[name + ".bias"] - mean) / std
    return sd


class Driver:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.unit = "maps"
        self.B = mix["batch"]
        self.spans = None
        self.stage_times = None
        self._standardised = None

    # ---- set-up ----------------------------------------------------------
    def layout(self):
        s = self.cfg["shape"]
        with torch.device("meta"):
            return ref_adabins.AdaBins(s["n_bins"], s["min_depth"],
                                       s["max_depth"])

    def weights(self):
        sd = weights.make_weights(self.layout(), self.seed, self.device,
                                  "eval", self.cfg.get("pins"))
        name = self.cfg.get("standardise")
        if name:
            # the standardised conv's tensors, made once
            if self._standardised is None:
                x = self.image_sets(1)[0][:1].permute(0, 3, 1, 2)
                new = standardise(sd, self.layout(), name, x)
                self._standardised = {k: new[k] for k in
                                      (name + ".weight", name + ".bias")}
            sd.update(self._standardised)
        return sd

    def image_sets(self, n=None):
        """The first ``n`` (default all) batches of images, (B, H, W, 3)
        contiguous, as a loader gives them."""
        g = torch.Generator(self.device).manual_seed(self.seed + 1)
        s = self.cfg["shape"]
        return [inputs.images(g, self.B, s["H"], s["W"], self.device)
                .contiguous()
                for _ in range(n or self.mix["distinct_batches"])]

    def build(self):
        from magnet_tpu_torch.core import config
        from magnet_tpu_torch.models import build
        args = config.parse_args(
            config.build_test_adabins_parser(),
            list(self.cfg["test_flags"]) + ["--device", str(self.device)])
        with program._no_host_init(build), torch.device("meta"):
            model = build.build_adabins(args, "meta")
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights())
        self.dtype = config.compute_dtype(args.compute_dtype)
        build.cast_for_inference(model, self.dtype)
        return model.eval()

    def setup(self):
        t = time.perf_counter()
        self.model = self.build()
        self.setup_log = [("model", time.perf_counter() - t)]
        pin = self.device.type == "cuda"
        self.host_sets = [x.to(self.dtype).cpu() for x in self.image_sets()]
        if pin:
            self.host_sets = [x.pin_memory() for x in self.host_sets]
        self.slots = [torch.empty_like(self.host_sets[0], device=self.device)
                      for _ in range(self.mix["in_flight"])]
        s = self.cfg["shape"]
        self.host_out = [torch.empty((self.B, -(-s["H"] // 2),
                                      -(-s["W"] // 2)), pin_memory=pin)
                         for _ in range(self.mix["in_flight"])]
        self.copy_stream = torch.cuda.Stream(self.device) if pin else None
        # the decoder feature of the forward in hand, kept with its outputs
        # when the sample draws it
        self._u = None
        self.model.decoder.register_forward_hook(
            lambda m, a, out: setattr(self, "_u", out))
        self.setup_log.append(("inputs", time.perf_counter() - t))
        # warm up the one shape the traffic uses
        self.run_units(2, keep=False)
        self.setup_log.append(("warm-up", time.perf_counter() - t))

    # ---- the traffic -----------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, j, slot):
        """Enqueues a forward on image batch ``j`` in ``slot``: (edges,
        depth, the end's event)."""
        dev_in, cs = self.slots[slot], self.copy_stream
        if cs is not None:
            # the slot is free: the loop has waited for its last forward
            with torch.cuda.stream(cs):
                dev_in.copy_(self.host_sets[j], non_blocking=True)
            torch.cuda.current_stream(self.device).wait_stream(cs)
        else:
            dev_in.copy_(self.host_sets[j])
        with torch.inference_mode():
            edges, depth = self.model(dev_in)
        self.host_out[slot].copy_(depth, non_blocking=cs is not None)
        ev = None
        if cs is not None:
            ev = torch.cuda.Event()
            ev.record()
        return edges, depth, ev

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
            if pending.get(slot) is not None:
                pending[slot].synchronize()
            edges, depth, pending[slot] = self._forward(j, slot)
            if keep:
                # reservoir: every forward of the window equally likely
                at = (len(self.kept) if len(self.kept) < k
                      else rng.randrange(k) if rng.random() < k / (i + 1)
                      else None)
                if at is not None:
                    item = (j, edges.clone(), depth.clone(), self._u.clone())
                    if at == len(self.kept):
                        self.kept.append(item)
                    else:
                        self.kept[at] = item
            i += 1
        self._sync()
        return i, time.perf_counter() - t0

    def units_of(self, forwards):
        return forwards * self.B

    def model_flops_per_unit(self):
        """One image's model FLOPs: ``FlopCounterMode`` over the reference
        on the meta device (convolutions and matrix products; the
        elementwise work, the softmax and the weighted sum left out)."""
        s = self.cfg["shape"]
        model = self.layout().eval()
        with torch.device("meta"):
            x = torch.empty(1, 3, s["H"], s["W"])
        mode = FlopCounterMode(display=False)
        with mode, torch.no_grad():
            model(x)
        return float(mode.get_total_flops())

    # ---- traced run --------------------------------------------------------
    def open_spans(self):
        self.spans = Spans(self.device)
        self.spans.host("host_issue", self.model)
        self.stage_times = program.stage_times().__enter__()
        return self.spans

    def close_spans(self):
        st = self.stage_times
        if st is None:
            return
        self.spans.close()
        for key, name in SPANS.items():
            self.spans.events[key] += st.events.get(name, [])
            if not self.spans.cuda:
                self.spans.host_ms[key] += [h.wall_s * 1e3
                                            for h in st.host.get(name, [])]
        st.__exit__(None, None, None)
        self.stage_times = None

    # ---- the check ---------------------------------------------------------
    def release(self):
        """Frees the program's state; the kept outputs stay."""
        for name in ("model", "slots", "copy_stream", "_u"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="float32"):
        plain_float32()
        ref = self.layout().to_empty(device=self.device)
        ref.load_state_dict(self.weights())
        return ref_adabins.set_precision(ref.eval(), Precision(precision))

    @torch.no_grad()
    def numbers(self, subject="program"):
        """``NUMBERS``, the worst over every image of the kept forwards:
        the program's, or (``subject`` "fp8") the reference computed in fp8
        put in the program's place."""
        ref = self.reference()
        other = None if subject == "program" else self.reference(subject)
        witness = self.reference("bfloat16")
        sets = self.image_sets()
        worst, wit = {}, {}
        for j, edges, depth, u in self.kept:
            if edges.shape[0] != self.B or depth.shape[0] != self.B:
                # the program left images out: nothing to hold them to
                return dict.fromkeys(NUMBERS, math.inf)
            for b0 in range(0, self.B, CHUNK):
                rows = slice(b0, b0 + CHUNK)
                x = sets[j][rows].permute(0, 3, 1, 2)
                prog_u = u[rows].permute(0, 3, 1, 2).float()
                ref_u = ref.features(x)
                ref_edges, ref_depth = ref.from_features(prog_u)
                if other is None:
                    subj_u = prog_u
                    subj_edges, subj_depth = edges[rows], depth[rows]
                    subj_whole = subj_depth
                else:
                    subj_u = other.features(x)
                    subj_edges, subj_depth = other.from_features(prog_u)
                    subj_depth = subj_depth[:, 0]
                    subj_whole = other.from_features(subj_u)[1][:, 0]
                head = ref.from_features(prog_u, subj_edges)[1][:, 0]
                whole = ref.from_features(ref_u)[1][:, 0]
                w_depth = witness.from_features(prog_u)[1][:, 0]
                for i in range(x.shape[0]):
                    nums = {"dec_rel": judge.abs_rel(subj_u[i], ref_u[i]),
                            "edges_rel": edges_gap(subj_edges[i],
                                                   ref_edges[i]),
                            "depth_rel": judge.spread_rel(subj_depth[i],
                                                          ref_depth[i, 0]),
                            "head_bins": bins_gap(subj_depth[i], head[i],
                                                  ref_edges[i]),
                            "map_rel": judge.spread_rel(subj_whole[i],
                                                        whole[i])}
                    for key, v in nums.items():
                        worst[key] = max(worst.get(key, 0.0), v)
                    wit["depth_rel"] = max(wit.get("depth_rel", 0.0),
                                           judge.spread_rel(w_depth[i],
                                                            ref_depth[i, 0]))
        worst["depth_wit"] = worst["depth_rel"] / max(wit["depth_rel"], 1e-12)
        return worst

    def compared(self):
        return len(self.kept) * self.B
