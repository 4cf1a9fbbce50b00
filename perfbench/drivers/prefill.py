"""Closed-loop batch prefill (a scoring job's prompt pass), one batch
in flight ahead.

Each batch holds ``batch`` prompts of one length (a client that groups
its prompts by length). The lengths follow the traffic file's
``prompt_len``: a log-normal of the given ``median`` and ``sigma``,
clipped to ``max``. They come in cycles of ``cycle_batches`` batches
whose lengths are that distribution's quantiles at (j + 1/2) /
``cycle_batches``, in an order drawn from the seed, so every seed sends
the same work. The window closes at the end of the first cycle that
ends after ``--seconds``. Token ids are uniform over the vocabulary:
each batch is a slice, at an offset drawn from the seed, of a pool of
ids made on the device in set-up. The client submits batch i + 1, then
reads batch i's last-position logits to the host with ``.cpu()``, as a
plain client does (the read waits for batch i + 1 too).

End-to-end: ``prefill_tokens_per_s`` (the prompt tokens of every batch
read / window). Check: ``logit_err``, the largest over a sample of the
window's batches (``check_batches`` of them, drawn from the seed, one
of the longest among them) of ||logits - reference|| / ||reference||.
"""
from __future__ import annotations

import math
import statistics
import time
from collections import deque

import numpy as np
import torch

from perfbench.harness import Window, derive_seed, rng


def cycle_lengths(spec: dict, n: int) -> list:
    """The ``n`` prompt lengths of a cycle: the quantiles at (j + 1/2) / n
    of a log-normal of ``spec``'s median and sigma, clipped to its max."""
    z = statistics.NormalDist()
    return [min(int(spec["max"]), max(1, round(
        spec["median"] * math.exp(spec["sigma"] * z.inv_cdf((j + 0.5) / n)))))
        for j in range(n)]


class Driver:
    def __init__(self, env):
        self.env = env
        self.system = env.system
        t = env.traffic
        self.batch = int(t["batch"])
        self.lengths = cycle_lengths(t["prompt_len"], int(t["cycle_batches"]))
        self.cycle_len = len(self.lengths)
        self.longest = max(self.lengths)
        self.vocab = int(env.config["vocab_size"])
        self.pool_len = 2 * self.batch * self.longest
        gen = torch.Generator(device=env.device).manual_seed(
            derive_seed(env.seed, "tokens"))
        self.pool = torch.randint(0, self.vocab, (self.pool_len,),
                                  generator=gen, device=env.device)
        self.answers = []               # (length, offset, host logits)
        self.n_check = int(t.get("check_batches", 3))

    def _plan(self, i):
        """Unit i's (length, offset in the pool)."""
        cyc, pos = divmod(i, self.cycle_len)
        order = rng(self.env.seed, "cycle", cyc).permutation(self.lengths)
        n = int(order[pos])
        off = int(rng(self.env.seed, "offset", i).integers(
            self.pool_len - self.batch * n + 1))
        return n, off

    def _tokens(self, n, off):
        return self.pool[off:off + self.batch * n].view(self.batch, n)

    def _forward(self, n, off):
        return self.system.prefill(self._tokens(n, off))

    def warmup(self):
        for n in sorted(set(self.lengths)):
            self._forward(n, 0).cpu()

    def window(self, seconds, tracer) -> Window:
        pending = deque()
        units = []
        n_sub = 0

        def submit():
            nonlocal n_sub
            tracer.at_unit(n_sub)
            n, off = self._plan(n_sub)
            with tracer.span("bench.submit"):
                out = self._forward(n, off)
            pending.append((n, off, out))
            n_sub += 1

        t0 = time.perf_counter()
        submit()
        while pending:
            if (time.perf_counter() - t0 < seconds
                    or n_sub % self.cycle_len):
                submit()
            n, off, out = pending.popleft()
            with tracer.span("bench.read"):
                host = out.cpu()
            self.answers.append((n, off, host))
            units.append({"kind": "prefill", "batch": self.batch, "seq": n})
        secs = time.perf_counter() - t0
        tokens = sum(u["batch"] * u["seq"] for u in units)
        return Window(seconds=secs, units=units, attempted=n_sub,
                      failed=n_sub - len(units),
                      e2e={"prefill_tokens_per_s": tokens / secs})

    def release(self):
        self.system.release()

    def _sample(self):
        """Indices of the window's batches to check: one of the longest
        and the rest uniform, drawn from the seed."""
        r = rng(self.env.seed, "check")
        longest = max(n for n, _o, _h in self.answers)
        idx = [i for i, a in enumerate(self.answers) if a[0] == longest]
        pick = [int(r.choice(idx))]
        rest = [i for i in range(len(self.answers)) if i not in pick]
        k = min(self.n_check - 1, len(rest))
        pick += [int(i) for i in r.choice(rest, size=k, replace=False)]
        return pick

    def _ref(self, reference, weights, n, off, precision):
        toks = self._tokens(n, off)
        rows = torch.full((self.batch, 1), n - 1, device=toks.device)
        return reference.logits(weights, self.env.config, toks, rows,
                                 precision)[:, 0].cpu()

    @staticmethod
    def _err(a, b):
        err = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b))
        return err if np.isfinite(err) else float("inf")

    def check(self, reference, weights) -> dict:
        worst = 0.0
        for i in self._sample():
            n, off, host = self.answers[i]
            ref = self._ref(reference, weights, n, off, "fp32")
            worst = max(worst, self._err(host, ref))
        return {"logit_err": worst}

    def control(self, reference, weights) -> dict:
        """The fp8 reference in the port's place, on the same sample."""
        worst = 0.0
        for i in self._sample():
            n, off, _host = self.answers[i]
            ref = self._ref(reference, weights, n, off, "fp32")
            low = self._ref(reference, weights, n, off, "fp8")
            worst = max(worst, self._err(low, ref))
        return {"logit_err": worst}
