"""Time the chains' attention launches (#2/#3's ``attn_fwd`` and ``attn_bwd``)
of two checkouts of the repository on one card, in turns.

    python scripts/compare_chain_attention.py --parent <dir> --change <dir> \
        [--out chiprun_out/compare_chain_attention.json]

Each turn is a child process that imports one tree's port (its own
``csrc/``, built into its own ``build/``) and its ``chip_smoke.py`` helpers,
and at each row of ``ROWS`` (B 32, the flagship's d 256 with 2 heads of 128,
rate 0.30, the inputs drawn from one seed, so both trees see the same values)
times the attention as ``ops/layer_sm90.py`` launches it for the encoder
(self, the slices of a packed qkv), the decoder's causal self-attention (the
same) and its cross-attention (q, and the slices of a packed kv): the
forward's and the backward's device time per call from a CUDA graph of their
calls (``chip_smoke.graph_ms``), and the same of
``F.scaled_dot_product_attention`` with ``dropout_p`` 0.30 on the same (B, H,
T, hd) views (``is_causal`` for the self-attention of the decoder; forward,
and forward plus its autograd backward): the library call that computes the
same function with its own mask stream, timed and never used by the port.
Each child holds its launches to their plain versions (2e-2 · max in bf16,
1e-5 · max in f32) and reports the form each took where its tree has
``layer_sm90.attention_route``. Turns run parent, change, change, parent.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (T, dtype): 8 and 16 bars in bf16 (the registers form's lengths), and 8 bars
# in f32 (the scores form in both trees: a control of the turns' spread)
ROWS = [(128, "bfloat16"), (256, "bfloat16"), (128, "float32")]
KINDS = ("encoder", "decoder_self", "decoder_cross")
B, D, H = 32, 256, 2


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from transformergrooveinfilling_tpu_torch.ops import fused_layer, layer_sm90

    dev = torch.device("cuda")
    cs.phase_device()
    rng = np.random.default_rng(25)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    hd = D // H
    for t, dname in ROWS:
        dtype = getattr(torch, dname)
        route = fused_layer.route_kernels(dtype)
        fwd_k, bwd_k = (next(k for n, k in route.items() if n.endswith(s))
                        for s in ("attn_fwd", "attn_bwd"))
        rows = B * t

        def n(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

        for kind in KINDS:
            causal = kind == "decoder_self"
            if kind == "decoder_cross":
                q, kv = n(rows, D), n(rows, 2 * D)
                k, v = kv[:, :D], kv[:, D:]
                dq, dkv = torch.empty_like(q), torch.empty_like(kv)
                dk, dv = dkv[:, :D], dkv[:, D:]
            else:
                qkv = n(rows, 3 * D)
                q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
                dqkv = torch.empty_like(qkv)
                dq, dk, dv = dqkv[:, :D], dqkv[:, D:2 * D], dqkv[:, 2 * D:]
            da, again = n(rows, D), torch.empty(rows, D, device=dev, dtype=dtype)
            args = (seed, fused_layer.SITE_ATTN, 0.3, H, t, causal)
            kf = lambda: layer_sm90.attention_forward(fwd_k, q, k, v, *args)  # noqa: E731
            kb = lambda: layer_sm90.attention_backward(  # noqa: E731
                bwd_k, q, k, v, da, dq, dk, dv, again, *args)
            out = kf()
            kb()
            torch.cuda.synchronize()
            bar = 2e-2 if dtype == torch.bfloat16 else 1e-5
            errs = {}
            want = layer_sm90.attention_backward_reference(q, k, v, da, *args)
            for name, got, ref in zip(("dq", "dk", "dv", "out_again"), (dq, dk, dv, again), want):
                errs[name] = cs.max_err(got, ref)
                cs.check(errs[name] <= bar * float(ref.float().abs().max()),
                         f"{root}: {kind} T {t} {dname} {name} off by {errs[name]}")
            ref = layer_sm90.attention_forward_reference(q, k, v, *args)
            errs["out"] = cs.max_err(out, ref)
            cs.check(errs["out"] <= bar * float(ref.float().abs().max()),
                     f"{root}: {kind} T {t} {dname} out off by {errs['out']}")
            # the library call on the same views, (B, H, T, hd)
            q4, k4, v4 = (x.detach().view(B, t, H, hd).transpose(1, 2).requires_grad_(True)
                          for x in (q, k, v))
            g4 = da.view(B, t, H, hd).transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=0.3,
                                                      is_causal=causal)

            def sdpa_both():
                return torch.autograd.grad(sdpa(), (q4, k4, v4), g4)

            form = (layer_sm90.attention_route(q, k, v, t, H)
                    if hasattr(layer_sm90, "attention_route") else "scores")
            print(json.dumps({
                "t": t, "dtype": dname, "kind": kind, "form": form, "max_abs_err": errs,
                "fwd_device_ms": cs.graph_ms(kf, n=20, reps=3),
                "bwd_device_ms": cs.graph_ms(kb, n=20, reps=3),
                "sdpa_fwd_device_ms": cs.graph_ms(sdpa, n=20, reps=3),
                "sdpa_fwd_bwd_device_ms": cs.graph_ms(sdpa_both, n=20, reps=3)}), flush=True)


def bound_ms(t: int, dname: str, backward: bool) -> float:
    """Bytes at 3.35 TB/s: q, k, v read and the output written (forward);
    q, k, v and dA read, dq, dk, dv and the output again written (backward)."""
    size = 2 if dname == "bfloat16" else 4
    return (8 if backward else 4) * B * t * D * size / 3.35e12 * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--out", default="chiprun_out/compare_chain_attention.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(os.path.abspath(args.worker))
        return
    turns = []
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(getattr(args, name))
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--parent", "-",
                              "--change", "-", "--worker", root], cwd=root,
                             capture_output=True, text=True, timeout=1500)
        if run.returncode:
            raise SystemExit(f"{name} turn failed (exit {run.returncode}):\n{run.stderr[-4000:]}")
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith("{") and '"fwd_device_ms"' in line]
        device = next(json.loads(line) for line in run.stdout.splitlines()
                      if '"phase": "device"' in line)
        turns.append({"tree": name, "nvidia_smi": device["nvidia_smi"], "rows": rows})
        print(json.dumps({"turn": name, "rows": len(rows)}), flush=True)
    summary = []
    for i, first in enumerate(turns[0]["rows"]):
        row = {key: first[key] for key in ("t", "dtype", "kind")}
        row["bound_fwd_ms"] = bound_ms(first["t"], first["dtype"], False)
        row["bound_bwd_ms"] = bound_ms(first["t"], first["dtype"], True)
        for turn in turns:
            r = turn["rows"][i]
            for key in ("fwd_device_ms", "bwd_device_ms", "sdpa_fwd_device_ms",
                        "sdpa_fwd_bwd_device_ms"):
                row.setdefault(f"{turn['tree']}_{key}", []).append(r[key])
            row[f"{turn['tree']}_form"] = r["form"]
        summary.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"turns": turns, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
