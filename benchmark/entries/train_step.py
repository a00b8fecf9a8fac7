"""Training steps through the program's own step: ``make_train_step``
(pixel loss, Adam) or, for a configuration with a ``gan`` group,
``make_gan_train_step`` (the generator's pixel, VGG19 perceptual and
adversarial losses and its Adam step, then the U-Net discriminator's two
BCE backwards and its Adam step).

Set-up builds that one step, drives it through the first ``check_steps``
steps on batches whose rows all differ, and reads what the check compares:
each step's losses, each leaf's first gradient from its optimizer's state
(Adam's first moment after one step is (1 - beta1) times it) and each
leaf's change after those steps.  The window then runs the same object on.
After the window the reference follows the same steps from the same seeded
weights and batches.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, List

import torch

from benchmark.harness import program
from benchmark.harness.check import loss_gap, median_leaf, moving_leaves
from benchmark.harness.spans import Spans, span
from benchmark.harness.synth import bicubic_down, generator, images, synth
from benchmark.reference import gan as gref
from benchmark.reference import hitsir as ref
from benchmark.reference.precision import Precision


def _floats(out) -> List[float]:
    return [float(t) for t in (out if isinstance(out, tuple) else (out,))]


class Entry:
    kind = "train"

    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.dtype = getattr(torch, self.traffic["dtype"])
        self.gan = "gan" in self.cfg
        self.spans = Spans() if trace else None
        t = self.traffic
        self.lr_pixels_per_step = t["batch"] * t["lr_size"] ** 2
        self.i = 0

    # ------------------------------------------------------------ program

    def _optimizer(self, params):
        from sisr_tpu_torch.configs.model_config import get_optimizer

        tc = self.cfg["train"]
        return get_optimizer(tc["optimizer"], params, tc["lr"],
                             {"betas": tc["betas"], "eps": tc["eps"], "weight_decay": 0})

    def setup(self) -> None:
        from sisr_tpu_torch.configs.model_config import get_loss_function
        from sisr_tpu_torch.train.train_state import make_gan_train_step, make_train_step

        cfg, dev = self.cfg, self.device
        self.model = program.hitsir(cfg, self.dtype, synth(ref.manifest(cfg), self.seed,
                                                             "generator", dev), dev, train=True)
        opt = self._optimizer(self.model.parameters())
        loss_fn = get_loss_function(cfg["train"]["loss"])
        self.nets = {"g": (self.model, opt)}
        if self.gan:
            gc_ = cfg["gan"]
            self.d = program.discriminator(cfg, synth(gref.d_manifest(gc_["ndf"]), self.seed,
                                                      "discriminator", dev), dev)
            self.perceptual = program.perceptual(synth(gref.vgg_manifest(), self.seed, "vgg",
                                                       dev), dev)
            d_opt = self._optimizer(self.d.parameters())
            self.nets["d"] = (self.d, d_opt)
            self.step_fn = make_gan_train_step(self.model, self.d, loss_fn, self.perceptual,
                                               opt, d_opt, gc_["perceptual_weight"],
                                               gc_["adversarial_weight"])
        else:
            self.step_fn = make_train_step(self.model, loss_fn, opt)
        self.inputs()
        self.gen = generator(self.seed, "dropout", dev)
        self._checked_steps()
        if self.spans is not None:
            self.spans.wrap(self.model, "model")
            if self.gan:
                self.spans.wrap(self.d, "discriminator")
                self.spans.wrap(self.perceptual.vgg, "vgg")

    def _checked_steps(self) -> None:
        beta1 = self.cfg["train"]["betas"][0]
        start = {n: {k: p.detach().clone() for k, p in m.named_parameters()}
                 for n, (m, _) in self.nets.items()}
        self.losses, self.grad_norms = [], {}
        for k in range(self.traffic["check_steps"]):
            self.losses.append(_floats(self.step()))
            if k == 0:
                self.grad_norms = {
                    n: {name: float(o.state[p]["exp_avg"].norm()) / (1.0 - beta1)
                        for name, p in m.named_parameters() if p in o.state}
                    for n, (m, o) in self.nets.items()}
        self.change_norms = {n: {k: float((p.detach() - start[n][k]).norm())
                                 for k, p in m.named_parameters()}
                             for n, (m, _) in self.nets.items()}

    def step(self):
        lr, hr = self.batches[self.i % len(self.batches)]
        self.i += 1
        if self.spans is None:
            return self.step_fn(lr, hr, self.gen)
        with span("step"):
            return self.step_fn(lr, hr, self.gen)

    def release(self) -> None:
        if self.spans is not None:
            self.spans.remove()
        self.model = self.d = self.perceptual = self.step_fn = self.nets = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- reference

    def reference(self, prec: Precision, half_batch: bool = False):
        """(losses, first-gradient norms, change norms) of the plain
        reference over the checked steps at ``prec`` (``float64``: weights
        and batches in float64, a witness of the float32 reference's own
        rounding); ``half_batch`` plants a fault: each step's loss over the
        first half of its batch."""
        cfg, dev, tc = self.cfg, self.device, self.cfg["train"]
        dt = torch.float64 if prec.name == "float64" else torch.float32
        o = ref.Ops(prec)
        G = {k: v.to(dt).requires_grad_(True) for k, v in
             synth(ref.manifest(cfg), self.seed, "generator", dev).items()}
        nets = {"g": G}
        opts = {"g": gref.Adam(G, tc["lr"], tc["betas"], tc["eps"])}
        if self.gan:
            gc_ = cfg["gan"]
            dw = {k: v.to(dt) for k, v in
                  synth(gref.d_manifest(gc_["ndf"]), self.seed, "discriminator", dev).items()}
            buffers = {k: v for k, v in dw.items() if k.endswith(("weight_u", "weight_v"))}
            D = {k: v.requires_grad_(True) for k, v in dw.items() if k not in buffers}
            V = {k: v.to(dt) for k, v in synth(gref.vgg_manifest(), self.seed, "vgg", dev).items()}
            nets["d"] = D
            opts["d"] = gref.Adam(D, tc["lr"], tc["betas"], tc["eps"])
        start = {n: {k: v.detach().clone() for k, v in p.items()} for n, p in nets.items()}
        losses, grad_norms = [], {}
        for step in range(self.traffic["check_steps"]):
            lr, hr = (t.to(dt) for t in self.batches[step])
            if half_batch:
                lr, hr = lr[:len(lr) // 2], hr[:len(hr) // 2]
            sr = ref.forward(G, cfg, lr, prec)
            grads = {}
            if self.gan:
                g_loss = (gref.l1(sr, hr)
                          + gc_["perceptual_weight"] * gref.perceptual_loss(o, V, sr, hr)
                          + gc_["adversarial_weight"]
                          * gref.bce(gref.discriminator(o, D, buffers, sr, gc_["ndf"]), True))
                grads["g"] = self._grads(g_loss, G)
                opts["g"].step(grads["g"])
                l_real = gref.bce(gref.discriminator(o, D, buffers, hr, gc_["ndf"]), True)
                l_fake = gref.bce(gref.discriminator(o, D, buffers, sr.detach(), gc_["ndf"]),
                                  False)
                grads["d"] = self._grads(l_real + l_fake, D)
                opts["d"].step(grads["d"])
                weight = 1.0 + gc_["perceptual_weight"] + gc_["adversarial_weight"]
                losses.append([float(g_loss.detach()) / weight,
                               float((l_real + l_fake).detach()) / 2.0])
            else:
                loss = gref.l1(sr, hr)
                grads["g"] = self._grads(loss, G)
                opts["g"].step(grads["g"])
                losses.append([float(loss.detach())])
            if step == 0:
                grad_norms = {n: {k: float(g.norm()) for k, g in gs.items()}
                              for n, gs in grads.items()}
            del sr, grads
        change = {n: {k: float((v.detach() - start[n][k]).norm()) for k, v in p.items()}
                  for n, p in nets.items()}
        return losses, grad_norms, change

    @staticmethod
    def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        names = list(params)
        gs = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        return {k: g for k, g in zip(names, gs) if g is not None}

    def numbers(self, prog, want, limits) -> list:
        """[(name, value, limit)] of program readings ``prog`` against the
        reference's ``want``, each (losses, grad norms, change norms)."""
        p_loss, p_grad, p_change = prog
        r_loss, r_grad, r_change = want
        steps = [loss_gap(p, r) for p, r in zip(p_loss, r_loss)]
        print("benchmark: loss gap by step " + ", ".join(f"{g:.3g}" for g in steps),
              file=sys.stderr)
        # the first step's: later steps carry max pools' argmax flips (see check.py)
        out = [("loss_gap", steps[0], limits.get("loss_gap"))]
        for n in r_grad:
            out.append((f"grad_gap.{n}",
                        median_leaf(f"grad.{n}", p_grad.get(n, {}), r_grad[n]),
                        limits.get(f"grad_gap.{n}")))
            keep = moving_leaves(r_grad[n])
            out.append((f"change_gap.{n}",
                        median_leaf(f"change.{n}", p_change.get(n, {}), r_change[n], keep),
                        limits.get(f"change_gap.{n}")))
        return out

    def check(self, limits) -> list:
        prog = (self.losses, self.grad_norms, self.change_norms)
        return self.numbers(prog, self.reference(Precision("float32")), limits)

    def inputs(self) -> None:
        """The pool of batches: HR crops made on the device from the seed,
        each LR the benchmark's bicubic of its HR."""
        t, s = self.traffic, self.cfg["upscale"]
        hr = images(generator(self.seed, "inputs", self.device), t["pool"] * t["batch"],
                    t["lr_size"] * s, t["lr_size"] * s, self.device)
        lr = bicubic_down(hr, s)
        b = t["batch"]
        self.batches = [(lr[k * b:(k + 1) * b], hr[k * b:(k + 1) * b]) for k in range(t["pool"])]

    def control(self, prec: str, limits, fault: str = "") -> list:
        """The check with the reference at ``prec`` (and with ``fault``
        'half_batch' planted) in the program's place; ``float64`` in its
        place reads how far the float32 reference itself lies from exact."""
        low = self.reference(Precision(prec), half_batch=fault == "half_batch")
        return self.numbers(low, self.reference(Precision("float32")), limits)
