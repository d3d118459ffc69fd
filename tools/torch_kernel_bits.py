#!/usr/bin/env python3
"""Do two checkouts of the port give the same bits from the same kernels?

    python3 tools/torch_kernel_bits.py save OUT.pt [--root CHECKOUT]
    python3 tools/torch_kernel_bits.py compare A.pt B.pt

``save`` runs, on the card, the CUDA kernels of the checkout at ``--root``
(default: this one) that a change to shared sources could move — the f32
forwards and walks of ``csrc/lstm_seq.cu``, the two-cell forward and
backward in f32 and bf16, both dense-stack forwards and the f32 dense-stack
backward — on inputs made from a fixed seed, and saves every output.
``compare`` reports, per output, whether two saved runs are bitwise equal,
and exits 1 if any differs. Run ``save`` once per checkout (each in its own
process: both define the same package) on one card, then ``compare``.
Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _inputs(seed: int = 0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0)
    return rng, (lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev))


def _lstm(out: dict):
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    _, f = _inputs(1)
    T, B, IN, H = 16, 200, 103, 256
    ins = (f(T, B, IN), f(IN, 4 * H, scale=0.1), f(4 * H, scale=0.1), f(H, 4 * H, scale=0.1),
           f(B, H, scale=0.5), f(B, H, scale=0.5))
    out["lstm_fwd"] = ls.lstm_seq_fwd(*ins)
    h, c, z, hp, cp = out["lstm_train_fwd"] = ls.lstm_seq_train_fwd(*ins)
    dh, dc = f(T, B, H, scale=1e-2), f(T, B, H, scale=1e-2)
    rk_t = ins[3].T.contiguous()
    out["lstm_walk"] = ls.lstm_seq_walk(z, cp, c, dh, dc, rk_t)
    out["lstm_walk_drk"] = ls.lstm_seq_walk_drk(z, cp, c, hp, dh, dc, rk_t)
    xz = f(T, B, 4 * H)
    out["lstm_xz_train_fwd"] = ls.lstm_seq_xz_train_fwd(xz, *ins[3:])


def _two_cell(out: dict):
    import torch

    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    _, f = _inputs(2)
    T, B, IN, H, L = 16, 200, 101, 256, 8
    for mode in ("f32", "bf16"):
        ins = [f(T, B, IN), f(T, B, IN), f(T, B, L), f(IN, 4 * H, scale=0.1),
               f(4 * H, scale=0.1), f(H, 4 * H, scale=0.1), f(IN, 4 * H, scale=0.1),
               f(4 * H, scale=0.1), f(H, 4 * H, scale=0.1), f(L, 4 * H, scale=0.1),
               f(H, 2 * L, scale=0.1), f(2 * L, scale=0.1), f(B, H, scale=0.5),
               f(B, H, scale=0.5), f(B, H, scale=0.5), f(B, H, scale=0.5)]
        if mode == "bf16":
            for i in (0, 1, 3, 5, 6, 8, 9, 10):
                ins[i] = ins[i].bfloat16()
        fwd = out[f"two_cell_fwd_{mode}"] = tc.two_cell_fwd(*ins)
        hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd = fwd
        xe, xd, eps, we, _, rke, wdx, _, rkd, kz, wz = ins[:11]
        res = (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd,
               f(*hd.shape, scale=1e-2), f(*zargs.shape, scale=1e-2), we, rke, wdx, rkd, kz, wz)
        out[f"two_cell_bwd_{mode}"] = tc.two_cell_bwd(*res)
        torch.cuda.synchronize()


def _vae(out: dict):
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    rng, f = _inputs(3)
    for label, (B, D, Cw, H, L, K) in {"train": (100, 88, 88, 88, 4, 13),
                                       "wide": (1024, 976, 256, 1024, 16, 13)}.items():
        g = lambda i, o: f(i, o, scale=(2.0 / (i + o)) ** 0.5)
        ws = dict(whw=g(D, Cw), bhw=f(Cw, scale=0.1), wwz=g(Cw, 2 * (K - 1)),
                  bwz=f(2 * (K - 1), scale=0.1), whx=g(D, H), whw2=g(K, H), bh=f(H, scale=0.1),
                  wzz=g(H, 2 * L), bzz=f(2 * L, scale=0.1), wdw=g(K, H), wdxp=g(D, H),
                  wdz=g(L, H), bd=f(H, scale=0.1), wxh=g(H, D), bxh=f(D, scale=0.1))
        x, xp = (f(B, D) > 1.0).float(), (f(B, D) > 1.0).float()
        ins = [x, xp, f(B, K - 1), f(B, L), *ws.values()]
        out[f"vae_fwd_f32_{label}"] = o = vd.vae_dense_fwd(*ins)
        xhat, wargs, zargs, w, a1, a2, a3 = o
        cot = [f(*t.shape, scale=1e-2) for t in (xhat, wargs, zargs, w)]
        mats = (ws["whw"], ws["wwz"], ws["whx"], ws["whw2"], ws["wzz"], ws["wdw"], ws["wdxp"],
                ws["wdz"], ws["wxh"])
        out[f"vae_bwd_f32_{label}"] = vd.vae_dense_bwd(x, xp, ins[2], ins[3], a1, a2, a3, xhat,
                                                       wargs, zargs, w, *cot, *mats)
        b16 = list(ins)
        for i in (0, 1, 4, 6, 8, 9, 11, 13, 14, 15, 17):
            b16[i] = b16[i].bfloat16()
        out[f"vae_fwd_bf16_{label}"] = vd.vae_dense_fwd(*b16)


def save(path: str, root: str | None):
    if root:
        sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import classifying_vae_lstm_tpu_torch

    print(f"package: {Path(classifying_vae_lstm_tpu_torch.__file__).parent}")
    out: dict = {}
    for part in (_lstm, _two_cell, _vae):
        part(out)
    torch.cuda.synchronize()
    flat = {f"{k}/{i}": t.cpu() for k, v in out.items()
            for i, t in enumerate(v if isinstance(v, (tuple, list)) else (v,)) if t is not None}
    torch.save(flat, path)
    print(f"saved {len(flat)} outputs of {len(out)} kernel calls to {path}")


def compare(a: str, b: str) -> int:
    import torch

    x, y = torch.load(a), torch.load(b)
    differ = sorted(k for k in x if k not in y or not torch.equal(x[k], y[k]))
    missing = sorted(set(y) - set(x))
    print(f"{len(x)} outputs: {len(x) - len(differ)} bitwise equal; differ: {differ or 'none'}"
          + (f"; only in {b}: {missing}" if missing else ""))
    return 1 if differ or missing else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("out")
    s.add_argument("--root", help="checkout whose package to run (default: this one)")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        save(args.out, args.root or str(Path(__file__).resolve().parents[1]))
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
