"""Closed-loop batch classification, one client, one batch in flight
ahead.

The client submits batch i + 1, then reads batch i's logits to the host
with ``.cpu()`` (the top-1 classes come from them there); the read
waits for batch i + 1 too, as a plain client's does. (A read that waits
for its own batch alone, through an event, gave 3% more images a second
and four times the spread between runs on one card, the host then
pacing every batch.) The images are a pool of
``pool_batches`` batches made on the device from the seed in set-up;
which pool batch each submission sends is drawn from the seed. The
window closes at the first answer read after ``--seconds``: every batch
submitted is read. A batch's latency runs from its submission to its
logits on the host.

Traffic keys: ``batch``, ``pool_batches``. End-to-end: ``images_per_s``
(images read / window), ``image_batch_p95_ms`` (95th percentile over
every batch of the window). Check: ``logit_err``, the largest over every
batch of the window of ||logits - reference|| / ||reference|| (the
reference of the batch's pool entry, computed once an entry).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from perfbench.harness import Window, rng


class Driver:
    def __init__(self, env):
        self.env = env
        self.system = env.system
        t = env.traffic
        self.batch, self.pool = int(t["batch"]), int(t["pool_batches"])
        self.images = None
        self.rng = rng(env.seed, "order")
        self.answers = []               # (pool index, host logits)

    def _images(self):
        if self.images is None:
            self.images = self.env.reference.make_images(
                self.env.config, self.pool, self.batch, self.env.seed,
                self.env.device, getattr(torch, self.env.config["dtype"]))
        return self.images

    def _forward(self, idx):
        return self.system.classify(self._images()[idx])

    def warmup(self):
        for idx in range(min(2, self.pool)):
            self._forward(idx).cpu()

    def window(self, seconds, tracer) -> Window:
        pending = deque()
        lat = []
        n_sub = 0

        def submit():
            nonlocal n_sub
            tracer.at_unit(n_sub)
            idx = int(self.rng.integers(self.pool))
            t = time.perf_counter()
            with tracer.span("bench.submit"):
                out = self._forward(idx)
            pending.append((idx, t, out))
            n_sub += 1

        t0 = time.perf_counter()
        submit()
        while pending:
            if time.perf_counter() - t0 < seconds:
                submit()
            idx, t, out = pending.popleft()
            with tracer.span("bench.read"):
                host = out.cpu()
            done = time.perf_counter()
            host.numpy().argmax(-1)             # the client's top-1
            lat.append(done - t)
            self.answers.append((idx, host))
        t_end = time.perf_counter()
        n = len(self.answers)
        secs = t_end - t0
        return Window(
            seconds=secs, units=[{"kind": "images", "batch": self.batch}] * n,
            attempted=n_sub, failed=n_sub - n,
            e2e={"images_per_s": n * self.batch / secs,
                 "image_batch_p95_ms": 1e3 * float(np.percentile(lat, 95))})

    def release(self):
        self.system.release()

    def _errors(self, ref_logits):
        worst = 0.0
        for idx, host in self.answers:
            r = ref_logits[idx]
            err = float(torch.linalg.vector_norm(host - r)
                        / torch.linalg.vector_norm(r))
            worst = max(worst, err if np.isfinite(err) else float("inf"))
        return worst

    def _reference(self, reference, weights, precision):
        imgs = self._images()
        return [reference.logits(weights, self.env.config, imgs[i],
                                 precision).cpu()
                for i in range(self.pool)]

    def check(self, reference, weights) -> dict:
        return {"logit_err": self._errors(
            self._reference(reference, weights, "fp32"))}

    def control(self, reference, weights) -> dict:
        """The control in the port's place: the fp8 reference's logits of
        each pool batch held against the fp32 reference's."""
        ref = self._reference(reference, weights, "fp32")
        low = self._reference(reference, weights, "fp8")
        return {"logit_err": max(
            float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(low, ref))}
