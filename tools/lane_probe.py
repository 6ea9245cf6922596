"""Where does a lane on a rank's own kv heads leave the unsharded lane?

The escalation lane (``launch/engine/escalate.py``) is a one-slot dense
runner: a batch re-prefill of the request (``registry.prefill``, the
plain ``layers.flash_attention``), then decode steps whose attention is
the plain dense read (``layers.decode_attention``).  Under ``--mesh
1x2`` it runs with ``TP.local_heads`` off (q, k and v gathered, every
head on every rank), because with it on the lane left the unsharded
engine's stream on the card.  This probe replays the lane's work at
phase 17's widths (qwen2-1.5B at full width cut to
``mesh_phase.LAYERS`` layers, the lane's 80-position strip) on two gloo
ranks of one device, with ``local_heads`` on and off, and holds every
layer's values to the unsharded lane's in this process:

* the hidden stream entering each norm (each layer's input, the
  residual after its attention, the final norm's input);
* q, k and v (the rank's heads against the same heads of the unsharded
  call);
* the attention read (``flash_attention`` / ``decode_attention``), the
  rank's heads likewise;
* the head's mean logits of every decode step.

It prints, for each mode, the first record that differs (its kind and
its call count: the reads run 4 a step, prefill first; the hidden
records 9 a step), or that every record is bit for bit; then the plain
reads of one rank's heads on contiguous per-rank tensors (as a rank
holds them) against the whole call, in bf16 as the read returns them
and as the two f32 einsums inside the dense read.

    python3 tools/lane_probe.py [--device cpu] [--reduced]

(on the card by default; ``--device cpu --reduced`` rehearses it).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PROMPT, MAX_LEN, STEPS = 40, 80, 8     # the lane's re-prefill and strip
HEAD_SPLIT = ("q", "k", "v", "read")


def lane_config(reduced: bool):
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.registry import reduced as small
    cfg = get_config("qwen2_1_5b")
    if reduced:
        # two kv heads, so that two ranks each hold one
        return dataclasses.replace(small(cfg), num_kv_heads=2,
                                   param_dtype="bfloat16")
    return dataclasses.replace(cfg, num_layers=4)


def _params(cfg, device):
    from repro_torch.models import registry as M
    return M.serving_params(M.init_train_params(
        cfg, torch.Generator(device=device).manual_seed(0), device))


class Recorder:
    """Wraps ``layers.rms_norm``, ``_qkv``, ``flash_attention`` and
    ``decode_attention``: every call's value, in call order, in host
    memory."""

    NAMES = ("rms_norm", "_qkv", "flash_attention", "decode_attention")

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.rows, self._orig = L, [], {}
        for name in self.NAMES:
            self._orig[name] = getattr(L, name)
            setattr(L, name, self._wrap(name, self._orig[name]))
        return self

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name == "rms_norm":
                self.rows.append(("hidden", args[0].detach().float().cpu()))
            elif name == "_qkv":
                for kind, t in zip(("q", "k", "v"), out):
                    self.rows.append((kind, t.detach().float().cpu()))
            else:
                self.rows.append(("read", out.detach().float().cpu()))
            return out
        return run

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.L, name, fn)


def lane_records(cfg, params, device, tp=None) -> list:
    """The lane's work on ``params`` (a rank's share under ``tp``): the
    re-prefill of a ``PROMPT``-token request into a one-slot
    ``MAX_LEN`` strip, then ``STEPS`` decode steps fed their argmax; the
    records, and the head's mean logits a step."""
    from repro_torch.models import registry as M

    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=g).to(device)
    with torch.inference_mode(), Recorder() as rec:
        hidden, cache = M.prefill(params, cfg, tokens, MAX_LEN, tp=tp)
        token = tokens[:, -1].to(torch.int32)
        for _ in range(STEPS):
            hidden, cache = M.decode_hidden(params, cfg, token, cache, tp=tp)
            logits = hidden.float() @ params["head"]["mu"].float()
            rec.rows.append(("logits", logits.cpu()))
            token = logits.argmax(-1).to(torch.int32)
    return rec.rows


def rank_records(tp, local_heads: bool, reduced: bool) -> list:
    """A rank's records with ``local_heads`` (spawned by ``Ranks``)."""
    from repro_torch.sharding import partition as P

    tp = dataclasses.replace(tp, local_heads=local_heads)
    cfg = lane_config(reduced)
    whole = _params(cfg, tp.device)
    dims = P.serve_dims(whole, tp.size)
    dims["head"] = dict.fromkeys(dims["head"])          # kernel entropy
    return lane_records(cfg, P.shard_params(whole, tp.rank, tp.size, dims),
                        tp.device, tp)


def first_difference(want: list, got: list, rank: int, size: int,
                     split: bool) -> str:
    """The first record of ``got`` (a rank's) that is not bit for bit the
    unsharded ``want``'s (its heads, where ``split``), with its layer
    count, or "bit for bit"."""
    seen: dict = {}
    if len(want) != len(got):
        return f"{len(got)} records against {len(want)}"
    for (kind, w), (kind2, g) in zip(want, got):
        n = seen[kind] = seen.get(kind, -1) + 1
        if kind in HEAD_SPLIT and split and g.shape != w.shape:
            h = w.shape[2] // size
            w = w[:, :, rank * h:(rank + 1) * h]
        if kind != kind2 or g.shape != w.shape:
            return f"record {kind} #{n}: {kind2} {tuple(g.shape)} against " \
                f"{tuple(w.shape)}"
        if not torch.equal(g, w):
            d = (g - w).abs().max().item()
            return f"first difference: {kind} call #{n} (max |d| {d:.3g}, " \
                f"|want| max {w.abs().max().item():.3g})"
    return "bit for bit"


def contiguous_reads(device) -> list[str]:
    """The plain reads of one rank's heads, its tensors contiguous as a
    rank holds them, against the same heads of the whole call at the
    lane's shapes (an 80-position strip, the 40-row re-prefill)."""
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device, torch.bfloat16)

    out = []
    q, k, v = rnd(1, 1, 12, 128), rnd(1, MAX_LEN, 2, 128), \
        rnd(1, MAX_LEN, 2, 128)
    lens = torch.tensor([PROMPT + 3], dtype=torch.int32, device=device)
    full = L.decode_attention(q, k, v, lens)[:, :, :6]
    part = L.decode_attention(q[:, :, :6].contiguous(),
                              k[:, :, :1].contiguous(),
                              v[:, :, :1].contiguous(), lens)
    out.append(("decode read", full, part))
    q, k, v = rnd(1, PROMPT, 12, 128), rnd(1, PROMPT, 2, 128), \
        rnd(1, PROMPT, 2, 128)
    out.append(("re-prefill read", L.flash_attention(q, k, v)[:, :, :6],
                L.flash_attention(q[:, :, :6].contiguous(),
                                  k[:, :, :1].contiguous(),
                                  v[:, :, :1].contiguous())))
    return [f"{name}, one rank's heads contiguous: " + (
        "bit for bit" if torch.equal(a, b) else
        f"max diff {(a.float() - b.float()).abs().max().item():.3g}")
        for name, a, b in out]


def f32_reads(device) -> list[str]:
    """The dense read's two f32 einsums (``layers.decode_attention``:
    scores, then probabilities times values) on one kv head's contiguous
    tensors against the same head of the call on two, before the read is
    rounded to bf16, at the lane's strip: equal, or the max difference."""
    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device, torch.bfloat16) \
            .float()

    q, k, v = rnd(1, 1, 2, 6, 128), rnd(1, MAX_LEN, 2, 128), \
        rnd(1, MAX_LEN, 2, 128)
    s_full = torch.einsum("bqgrd,bkgd->bgrqk", q, k)
    s_part = torch.einsum("bqgrd,bkgd->bgrqk", q[:, :, :1].contiguous(),
                          k[:, :, :1].contiguous())
    p = torch.softmax(s_full / 128 ** 0.5, dim=-1)
    o_full = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
    o_part = torch.einsum("bgrqk,bkgd->bqgrd", p[:, :1].contiguous(),
                          v[:, :, :1].contiguous())
    return [f"f32 {name} on one kv head of two: " + (
        "equal" if torch.equal(a, b) else
        f"max diff {(a - b).abs().max().item():.3g} of "
        f"{a.abs().max().item():.3g}")
        for name, a, b in (("scores", s_full[:, :1], s_part),
                           ("read", o_full[:, :, :1], o_part))]


def probe(device: str, reduced: bool) -> dict:
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.launch import mesh as meshlib

    torch.set_num_threads(1)
    cfg = lane_config(reduced)
    out = {}
    with meshlib.Ranks(2, device, timeout_s=300) as ranks:
        want = lane_records(cfg, _params(cfg, device), device)
        for local in (True, False):
            got = ranks.run(rank_records, local, reduced)
            out[local] = [first_difference(want, g, r, 2, local)
                          for r, g in enumerate(got)]
            print(f"lane probe, local_heads {'on' if local else 'off'}: "
                  + "; ".join(f"rank {r}: {line}"
                              for r, line in enumerate(out[local])),
                  flush=True)
    for line in contiguous_reads(device) + f32_reads(device):
        print(f"lane probe: {line}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card or pass --device "
                         "cpu --reduced")
    probe(args.device, args.reduced)


if __name__ == "__main__":
    main()
