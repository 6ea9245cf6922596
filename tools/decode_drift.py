"""How far the paged decode kernel's read and the gather read part, per
layer and through the model, at full width on one GPU.

    python3 tools/decode_drift.py

For phi-3-vision-4.2b (one 640-token prompt whose first 576 positions
are random prefix embeds, then zero embeds) and qwen2-1.5b (a 256-token
prompt), random weights from seed 0, the prompt prefilled into a paged
slot through a shuffled block row:

- the whole decode path on the kernel read against the whole path on
  the gather read, four steps: the hidden states' distance, relative to
  the norm;
- one step layer by layer, both reads given the same query and pool:
  each read's output against an f64 read of the same K/V, the two reads
  against each other, and the residual stream's distance when the
  kernel read's output is carried on (its own input) against the gather
  read's, layer by layer.

Reads that each sit within a bf16 rounding of the f64 read still part
the two bf16 paths by an ulp here and there, and the parts grow through
the layers: that growth, not the kernel, sets the whole-path distance.
``chip_smoke.py``'s vlm prefix check holds each layer's read instead.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def exact_read(q, k, v, n: int) -> torch.Tensor:
    """One slot's decode attention in f64 over the first ``n`` keys of its
    gathered (1, S, Hkv, D) strips; q (1, 1, H, D)."""
    H, D = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    qg = q.double().reshape(Hkv, H // Hkv, D)
    s = torch.einsum("grd,kgd->grk", qg, k[0, :n].double()) / D ** 0.5
    out = torch.einsum("grk,kgd->grd", torch.softmax(s, dim=-1),
                       v[0, :n].double())
    return out.reshape(1, 1, H, D)


def drift(arch: str, P: int, S: int, dev) -> None:
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import registry as M
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    kcfg = dataclasses.replace(cfg, decode_attn="kernel")
    gcfg = dataclasses.replace(cfg, decode_attn="gather")
    g = torch.Generator(device=dev).manual_seed(26)
    emb = torch.randn((1, P, cfg.d_model), generator=g, device=dev) \
        if P else None
    toks = torch.randint(1, cfg.vocab_size - 1, (1, S), generator=g,
                         device=dev)
    cases = [("no prefix", None)] if not P else \
        [("random embeds", emb), ("zero embeds", torch.zeros_like(emb))]
    for label, e in cases:
        with torch.inference_mode():
            cache = M.make_cache(kcfg, 1, S + 48, device=dev, layout="paged",
                                 kv_block=16)
            _, sub = M.prefill(params, gcfg, toks, S, e)
            MB = cache["block_table"].shape[1]
            row = torch.randperm(MB, generator=torch.Generator().manual_seed(
                5)).to(torch.int32).to(dev)
            M.write_slot(kcfg, cache, 0, sub, row)

            kc = {k: v.clone() for k, v in cache.items()}
            gc = {k: v.clone() for k, v in cache.items()}
            tok = toks[:, -1].to(torch.int32)
            whole = []
            for _ in range(4):
                hk, _ = T.decode_hidden(params, kcfg, tok, kc)
                hg, _ = T.decode_hidden(params, gcfg, tok, gc)
                whole.append(rel(hk, hg))
                tok = (hg.float() @ params["head"]["mu"]).argmax(-1).to(
                    torch.int32)

            tok = toks[:, -1].to(torch.int32)
            x = L.apply_embed(params["embed"], tok[:, None])
            xk = x.clone()
            lens, table = cache["len"], cache["block_table"]
            rot = L.rope_tables(lens.reshape(-1, 1), cfg.head_dim,
                                cfg.rope_theta)
            at = L.paged_index(cache["k"].shape[1], cache["k"].shape[2],
                               table, lens, 1)
            eff = L.mapped_span(table, cache["k"].shape[2], lens + 1)
            k_f64, g_f64, k_g, carried = [], [], [], []
            for i in range(cfg.num_layers):
                bp = T.layer(params["blocks"], i)
                pools = (cache["k"][i], cache["v"][i])
                q, k, v = L._qkv(bp["attn"], cfg, L.rms_norm(x, bp["ln1"]),
                                 rot)
                for pool, new in zip(pools, (k, v)):
                    L.paged_scatter(pool, table, lens, new, at)
                kg, vg = (L.paged_gather(p, table) for p in pools)
                o_k = ops.paged_decode_attention(q, *pools, table, lens + 1)
                o_g = L.decode_attention(q, kg, vg, eff)
                o_64 = exact_read(q, kg, vg, int(eff[0]))
                k_f64.append(rel(o_k, o_64))
                g_f64.append(rel(o_g, o_64))
                k_g.append(rel(o_k, o_g))
                x = x + L._mm(o_g.reshape(1, 1, -1), bp["attn"]["wo"])
                x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]))
                qk, _, _ = L._qkv(bp["attn"], cfg, L.rms_norm(xk, bp["ln1"]),
                                  rot)
                o_kk = ops.paged_decode_attention(qk, *pools, table, lens + 1)
                xk = xk + L._mm(o_kk.reshape(1, 1, -1), bp["attn"]["wo"])
                xk = xk + L.apply_mlp(bp["mlp"], cfg,
                                      L.rms_norm(xk, bp["ln2"]))
                carried.append(rel(xk, x))
        final = rel(L.rms_norm(xk, params["final_norm"], cfg.norm_eps),
                    L.rms_norm(x, params["final_norm"], cfg.norm_eps))
        print(f"{cfg.name}, {label}, prompt {S}: whole decode paths, kernel "
              f"read vs gather read, hidden apart by "
              + ", ".join(f"{w:.4f}" for w in whole) + " of the norm "
              f"(4 steps); one step, per layer, the same input: the kernel "
              f"read within {max(k_f64):.3g} of an f64 read (median "
              f"{sorted(k_f64)[len(k_f64) // 2]:.3g}), the gather read "
              f"within {max(g_f64):.3g} (median "
              f"{sorted(g_f64)[len(g_f64) // 2]:.3g}), the two within "
              f"{max(k_g):.3g} of each other; carried through the layers "
              f"the residual parts by "
              + ", ".join(f"{c:.4f}" for c in carried)
              + f"; final hidden {final:.4f}", flush=True)
    del params
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on a GPU", file=sys.stderr)
        sys.exit(1)
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build

    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda")
    drift("phi_3_vision_4_2b", 576, 640, dev)
    drift("qwen2_1_5b", 0, 256, dev)


if __name__ == "__main__":
    main()
