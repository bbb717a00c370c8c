"""Kernel-against-plain parity for every CUDA kernel of the port, as an
artifact (modelled on tools/pallas_parity.py, with its cases and pass rule).

Each case runs a kernel through its wrapper on `--device` and its plain
PyTorch version on fp32 copies of the same inputs, and records the largest
error and the error normalised by 2e-2 * max|plain| + 1e-3 (pass below 1):
  - K1-K3: `hstu_attn_varlen` forward and dq/dk/dv (causal, contextual +
    targets in groups of 2, a window of 64), and K4 forward and drab;
  - K5: the int8 forward (`quantized=True`) against the plain int8 version;
  - K6 and K6-int8: paged delta attention over bf16 and int8 pages;
  - K7: beam-decode attention with GQA and random ancestry.
On CPU tensors every wrapper runs its plain version, so `--device cpu`
checks the harness, not a kernel.

Usage: python -m recsys_examples_torch.tools.kernel_parity [--device cuda]
           [--out recsys_examples_torch/_build/kernel_parity.json]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

from recsys_examples_torch.utils.device import resolve_device

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "_build", "kernel_parity.json")


def _maxerr(a, b):
    """(max abs err, err normalised by rtol * scale + atol). Pass = < 1.
    atol floors the comparison at bf16 rounding noise, so near-zero outputs
    do not inflate the relative measure."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    err = float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    return err, err / (2e-2 * scale + 1e-3)


def _record(results, kernel, got, want):
    aerr, rerr = _maxerr(got.detach().float().cpu(), want.detach().float().cpu())
    results.append({"kernel": kernel, "max_abs_err": aerr, "norm_err": rerr,
                    "pass": rerr < 1.0})


def check_varlen(results, dev):
    from recsys_examples_torch.ops.hstu_attention import hstu_attn_varlen
    from recsys_examples_torch.ops.hstu_attention_ref import (
        hstu_mha_int8_reference,
        hstu_mha_reference,
    )

    H, D, N = 2, 128, 512
    lengths = np.array([400, 37, 256, 129], np.int64)
    T = 1024
    offs_np = np.concatenate([[0], np.cumsum(lengths)])
    offs = torch.as_tensor(offs_np, device=dev)
    rng = np.random.default_rng(0)

    def mk(scale=0.3):
        x = rng.standard_normal((T, H, D)).astype(np.float32) * scale
        x[offs_np[-1]:] = 0
        return torch.as_tensor(x, device=dev).to(torch.bfloat16)

    q, k, v = mk(), mk(), mk()
    cases = {
        "causal": (None, None, {}),
        "ctx_targets": (np.array([3, 2, 0, 1]), np.array([10, 4, 6, 8]),
                        dict(target_group_size=2)),
        "local_window": (None, None, dict(max_attn_len=64)),
    }
    for name, (nc, nt, kw) in cases.items():
        nc = None if nc is None else torch.as_tensor(nc, device=dev)
        nt = None if nt is None else torch.as_tensor(nt, device=dev)
        qk = [x.clone().requires_grad_() for x in (q, k, v)]
        out = hstu_attn_varlen(*qk, offs, N, num_contextuals=nc, num_targets=nt,
                               alpha=0.08, **kw)
        out.float().sum().backward()
        rk = [x.float().clone().requires_grad_() for x in (q, k, v)]
        ref = hstu_mha_reference(N, 0.08, *rk, offs, num_contextuals=nc,
                                 num_targets=nt, **kw)
        ref.sum().backward()
        _record(results, f"hstu_attn_varlen/{name}/fwd", out, ref)
        for gi in range(3):
            _record(results, f"hstu_attn_varlen/{name}/d{'qkv'[gi]}",
                    qk[gi].grad, rk[gi].grad)
        if name == "causal":   # K5 against the plain int8 version
            from recsys_examples_torch.ops.hstu_attention import quantize_per_tensor

            out8 = hstu_attn_varlen(q, k, v, offs, N, alpha=0.08, quantized=True)
            (q8, sq), (k8, sk), (v8, sv) = (quantize_per_tensor(x) for x in (q, k, v))
            ref8 = hstu_mha_int8_reference(N, 0.08, q8, k8, v8, sq, sk, sv, offs)
            _record(results, "hstu_attn_varlen_quantized_calibrated", out8, ref8)

    # K4: the relative attention bias, forward and drab
    B = len(lengths)
    rab0 = torch.as_tensor(rng.standard_normal((B, H, N, N)).astype(np.float32) * 0.1,
                           device=dev)
    rab = rab0.clone().requires_grad_()
    out = hstu_attn_varlen(q, k, v, offs, N, alpha=0.08, rab=rab)
    out.float().sum().backward()
    rab_ref = rab0.clone().requires_grad_()
    ref = hstu_mha_reference(N, 0.08, q.float(), k.float(), v.float(), offs, rab=rab_ref)
    ref.sum().backward()
    _record(results, "hstu_attn_varlen_rab/fwd", out, ref)
    _record(results, "hstu_attn_varlen_rab/drab", rab.grad, rab_ref.grad)


def check_paged(results, dev):
    from recsys_examples_torch.ops.paged_hstu_attention import (
        paged_hstu_delta_attention,
        paged_hstu_delta_attention_ref,
        quantize_kv_pages,
    )

    rng = np.random.default_rng(1)
    B, S, H, dh, pg, P, maxp = 4, 16, 2, 128, 16, 64, 8

    def mk(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.3,
                               device=dev).to(torch.bfloat16)

    q, nk, nv = mk((B, S, H, dh)), mk((B, S, H, dh)), mk((B, S, H, dh))
    kp, vp = mk((P, pg, H, dh)), mk((P, pg, H, dh))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    pt = i32(rng.integers(0, P, (B, maxp)))
    clen, nl = i32([32, 0, 128, 77]), i32([16, 3, 9, 16])
    out = paged_hstu_delta_attention(q, kp, vp, pt, clen, nk, nv, nl, None, 0.08, 256.0)
    f = lambda x: x.float()
    ref = paged_hstu_delta_attention_ref(f(q), f(kp), f(vp), pt, clen, f(nk), f(nv), nl,
                                         None, 0.08, 256.0)
    _record(results, "paged_hstu_delta_attention", out, ref)
    k8, v8, ks, vs = quantize_kv_pages(kp, vp)
    out8 = paged_hstu_delta_attention(q, k8, v8, pt, clen, nk, nv, nl, None, 0.08, 256.0,
                                      k_scales=ks, v_scales=vs)
    ref8 = paged_hstu_delta_attention_ref(
        f(q), k8.float() * ks[..., None], v8.float() * vs[..., None], pt, clen, f(nk),
        f(nv), nl, None, 0.08, 256.0)
    _record(results, "paged_hstu_delta_attention_int8", out8, ref8)


def check_beam(results, dev):
    from recsys_examples_torch.ops.beam_decode_attention import (
        beam_decode_attn,
        beam_decode_attn_ref,
    )

    rng = np.random.default_rng(2)
    B, W, H, Hkv, D, S, Nst = 4, 8, 4, 2, 128, 64, 3

    def mk(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.3,
                               device=dev).to(torch.bfloat16)

    q = mk((B, W, H, D))
    kc, vc = mk((B, S, Hkv, D)), mk((B, S, Hkv, D))
    clens = torch.as_tensor(np.array([64, 17, 33, 5], np.int32), device=dev)
    kb, vb = mk((B, Nst, W, Hkv, D)), mk((B, Nst, W, Hkv, D))
    anc = torch.as_tensor(rng.integers(0, W, (B, Nst, W)).astype(np.int32), device=dev)
    out = beam_decode_attn(q, kc, vc, clens, kb, vb, anc, sm_scale=0.09)
    f = lambda x: x.float()
    ref = beam_decode_attn_ref(f(q), f(kc), f(vc), clens, f(kb), f(vb), anc, sm_scale=0.09)
    _record(results, "beam_decode_attn", out, ref)


def run(device="cuda"):
    dev = resolve_device(device)
    results = []
    check_varlen(results, dev)
    check_paged(results, dev)
    check_beam(results, dev)
    return dev, results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    dev, results = run(args.device)
    ok = all(r["pass"] for r in results)
    artifact = {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "all_pass": ok,
        "results": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"bench": "kernel_parity", "all_pass": ok, "cases": len(results),
                      "backend": dev.type, "artifact": args.out}))
    if not ok:
        for r in results:
            if not r["pass"]:
                print("FAIL", r, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
