"""The high-S escalation lane (the engine's OOD verification sidecar).

Counterpart of ``repro.launch.engine.escalate``.  When a decoding slot's
carried MI reaches ``escalate_mi`` the engine hands the request to an
``EscalationLane``: a one-slot dense sidecar driven by a second
``ModelRunner`` on the engine's own parameter tensors, whose config
re-draws the uncertain head with ``escalate_s`` MC samples instead of the
serving S (``ServeEngine.escalation_runner`` keeps one runner, and on
CUDA one captured decode-chunk graph, per S).  More samples shrink the MC
error of the MI estimate, so the tokens a flagged request ships carry
the better uncertainty reading: the serving analogue of routing flagged
blood-cell images to a bigger verify pass (``examples/blood_cell_ood.py``).

The lane is plain mechanism: one request at a time, a batch re-prefill of
``prompt + tokens so far`` into its own dense cache (S changes the head's
draws only, never the KV), then decode chunks to the request's finish,
each one replay of the lane runner's graph and one host transfer.  It does
ONE unit of work per engine iteration (an admission or a chunk), so
escalations never stall the main pool's decode cadence.  A request whose
``prompt + max_new_tokens`` exceeds the lane's ``max_len`` does not fit
(``fits``) and keeps decoding in the main engine, counted once.
"""

from __future__ import annotations

import collections
import time

import numpy as np


class EscalationLane:
    """One-slot high-S finish lane over a dedicated ``ModelRunner``.

    Host-side state only: the cache and the carry are the lane
    runner's (reset in place when the lane is made, once a run), every write
    into them between chunks lands in place (``fill_``), and the lane's
    global step counter is its own (operand noise keys (slot, depth), so
    an escalated stream does not depend on when the engine escalated)."""

    def __init__(self, runner, *, chunk: int, eos_id=None, pad_to=None,
                 modality=None):
        self.runner = runner
        self.chunk = chunk
        self.eos_id = eos_id
        self.pad_to = pad_to          # prompt bucket (None: exact lengths)
        self.modality = modality
        self.max_len = runner.max_len
        self.queue: collections.deque = collections.deque()
        self.current = None
        self._carry = runner.start()  # (tok, cache, active, flags)
        self._step0 = 0

    def fits(self, req) -> bool:
        """The dense strip must hold the whole prompt + generation."""
        return len(req.prompt) + req.max_new_tokens <= self.max_len

    def has_work(self) -> bool:
        return self.current is not None or bool(self.queue)

    def submit(self, req) -> None:
        self.queue.append(req)

    def step(self, stats) -> bool:
        """One unit of lane work: admit the next escalated request, or
        decode one chunk of the current one.  Returns whether anything ran
        (the engine's stall guard)."""
        if self.current is None:
            if not self.queue:
                return False
            self._admit(self.queue.popleft())
            return True
        self._decode_chunk(stats)
        return True

    def _admit(self, req) -> None:
        """Re-prefill ``prompt + tokens so far`` into slot 0 (padded to
        the bucket where the family pads), pin the depth, and arm the
        carry with the last emitted token.  S changes no KV write, so the
        replayed cache is the one the request left in the main engine."""
        r = self.runner
        tok, cache, active, flags = self._carry
        seq = list(req.prompt) + list(req.tokens)
        n = len(seq)
        width = n
        if self.pad_to:
            width = min(-(-n // self.pad_to) * self.pad_to, self.max_len)
        toks = np.zeros((width,), np.int32)
        toks[:n] = seq
        r.prefill(cache, 0, toks, None, self.modality)
        if width > n:
            r.set_len(cache, 0, n)
        tok[0].fill_(int(seq[-1]))
        active[0].fill_(True)
        for v in flags.values():
            v[0].fill_(0)
        self.current = req

    def _decode_chunk(self, stats) -> None:
        """One decode chunk at the verify S, harvested into the request."""
        r = self.runner
        req = self.current
        tok, cache, active, flags = self._carry
        t0 = time.perf_counter()
        ys = r.fetch(r.scan(tok, cache, self._step0, active, flags)[3])
        dt = time.perf_counter() - t0
        stats.esc_decode_s += dt
        stats.decode_s += dt
        stats.esc_steps += self.chunk
        self._step0 += self.chunk
        for t in range(self.chunk):
            tk = int(ys["token"][t, 0])
            req.tokens.append(tk)
            for name in ("H", "SE", "MI", "p_max"):
                getattr(req, name).append(float(ys[name][t, 0]))
            req.epistemic_flags += int(ys["epistemic"][t, 0])
            req.aleatoric_flags += int(ys["aleatoric"][t, 0])
            req.last_mi = float(ys["MI"][t, 0])
            stats.esc_tokens += 1
            done_eos = self.eos_id is not None and tk == self.eos_id
            if done_eos or len(req.tokens) >= req.max_new_tokens:
                req.transition("finished",
                               reason="eos" if done_eos else "length")
                active[0].fill_(False)
                self.current = None
                break
