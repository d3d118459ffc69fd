#!/usr/bin/env python3
"""Do two checkouts of the port give the same bits from the same kernels?

    python3 tools/torch_kernel_bits.py save OUT.pt [--root CHECKOUT]
    python3 tools/torch_kernel_bits.py compare A.pt B.pt

``save`` runs, on the card, the CUDA kernels of the checkout at ``--root``
(default: this one) that a change to shared sources could move — the f32
forwards of ``csrc/lstm_seq.cu`` and the f32 walks, the two-cell forward and
backward in f32 and bf16, both dense-stack forwards and backwards, the
int8 cl_vrnn generation kernel (probabilities with u = 1 and sampled frames
at H=1,536, 64 songs x (32 + 256) steps) and the f32 / bf16 one (on those
weights, and sampled frames at H=256), the int8 cl_vae
generation kernel (D=1,024 with x_prev, 64 songs x 64 steps: H=4,160, whose
weight slices stay in shared memory, and H=5,120 and 7,808, which stream
some), the f32 / bf16 cl_vae generation kernels past one block's shared
memory (f32 at D=88, H=256; bf16 at D=1,024, H=5,120, 64 songs x 64
steps) and at the committed checkpoints' width and without hidden layers
(the trained jsball_vae in f32; bf16 at H=256; f32 without hidden layers)
— on inputs made from a fixed seed, and saves every output. It also calls
both dense-stack forwards and the f32 backward, the int8 and the f32 /
bf16 cl_vae kernels and the f32 LSTM forwards a second time and exits 1
unless each gives the same bits again.
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
    out["lstm_xz_fwd"] = ls.lstm_seq_xz_fwd(xz, *ins[3:])
    return {"lstm_fwd": lambda: ls.lstm_seq_fwd(*ins),
            "lstm_train_fwd": lambda: ls.lstm_seq_train_fwd(*ins),
            "lstm_xz_train_fwd": lambda: ls.lstm_seq_xz_train_fwd(xz, *ins[3:]),
            "lstm_xz_fwd": lambda: ls.lstm_seq_xz_fwd(xz, *ins[3:])}


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

    again = {}
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
        res = (x, xp, ins[2], ins[3], a1, a2, a3, xhat, wargs, zargs, w, *cot, *mats)
        out[f"vae_bwd_f32_{label}"] = vd.vae_dense_bwd(*res)
        again[f"vae_fwd_f32_{label}"] = lambda ins=ins: vd.vae_dense_fwd(*ins)
        again[f"vae_bwd_f32_{label}"] = lambda res=res: vd.vae_dense_bwd(*res)
        b16 = list(ins)
        for i in (0, 1, 4, 6, 8, 9, 11, 13, 14, 15, 17):
            b16[i] = b16[i].bfloat16()
        out[f"vae_fwd_bf16_{label}"] = vd.vae_dense_fwd(*b16)
        again[f"vae_fwd_bf16_{label}"] = lambda b16=b16: vd.vae_dense_fwd(*b16)
        # the bf16 backward, whose weight gradients run csrc/wgrad.cuh's
        # kernel with its bf16 flags, on the f32 run's residuals
        b16_res = list(res)
        for i in (0, 1, 15, 16, 17, 18, 19, 20, 21, 22, 23):
            b16_res[i] = b16_res[i].bfloat16()
        out[f"vae_bwd_bf16_{label}"] = vd.vae_dense_bwd(*b16_res)
    return again


def _int8(out: dict):
    import dataclasses

    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    rng, _ = _inputs(4)
    dev = torch.device("cuda", 0)
    B, Tseed, nsteps, D, H, L, K = 64, 32, 256, 88, 1536, 2, 13
    total = Tseed + nsteps

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    zeros = lambda n: np.zeros(n, np.float32)
    raw = {"encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                         "bias": zeros(4 * H)},
           "decoder_h": {"kernel": glorot(D + L + K, 4 * H),
                         "recurrent_kernel": glorot(H, 4 * H), "bias": zeros(4 * H)},
           "Z_mean": {"kernel": glorot(H, L), "bias": zeros(L)},
           "Z_log_var": {"kernel": glorot(H, L), "bias": zeros(L)},
           "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -2.0, np.float32)}}
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=16,
                         n_classes=K, use_x_prev=True, bf16_compute=True, lstm_backend="pallas")
    t = lambda a: torch.from_numpy(a).to(dev)
    seeds = t((rng.random((B, Tseed, D)) < 0.1).astype(np.float32))
    eps = t(rng.standard_normal((B, total, L)).astype(np.float32))
    u = t(rng.random((B, total, D)).astype(np.float32))
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    params = params_from_numpy(raw, dev)
    run = lambda uu, rp: cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, uu, ws,
                                                        return_probs=rp, mode="int8")
    out["int8_cl_vrnn_probs_u1"] = run(torch.ones_like(u), True)
    out["int8_cl_vrnn_frames"] = run(u, False)
    # the f32 / bf16 generation kernel on the same weights (streamed slices)
    # and at jsball_vrnn4's width (H=256: resident), probabilities with u = 1
    for mode in ("bf16", "f32"):
        out[f"{mode}_cl_vrnn_probs_u1"] = cg.generate_cl_vrnn_batch_cuda(
            params, cfg, seeds, nsteps, eps, torch.ones_like(u), ws, return_probs=True, mode=mode)
    H = 256
    cfg = dataclasses.replace(cfg, intermediate_dim=H, latent_dim=8, bf16_compute=False)
    L = 8
    raw = {"encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                         "bias": zeros(4 * H)},
           "decoder_h": {"kernel": glorot(D + L + K, 4 * H),
                         "recurrent_kernel": glorot(H, 4 * H), "bias": zeros(4 * H)},
           "Z_mean": {"kernel": glorot(H, L), "bias": zeros(L)},
           "Z_log_var": {"kernel": glorot(H, L), "bias": zeros(L)},
           "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -2.0, np.float32)}}
    eps = t(rng.standard_normal((B, total, L)).astype(np.float32))
    out["f32_cl_vrnn_h256_frames"] = cg.generate_cl_vrnn_batch_cuda(
        params_from_numpy(raw, dev), cfg, seeds, nsteps, eps, u, ws, mode="f32")
    torch.cuda.synchronize()


def _int8_vae(out: dict):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    rng, _ = _inputs(5)
    dev = torch.device("cuda", 0)
    B, nsteps, D, L, K, Cw = 64, 64, 1024, 16, 13, 256

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    zeros = lambda n: np.zeros(n, np.float32)
    again = {}
    # weight slices resident in shared memory (H=4,160), the head's tiles
    # streamed (H=5,120), the head and the x rows streamed (H=7,808)
    for H in (4160, 5120, 7808):
        raw = {"h_w": {"kernel": glorot(D, Cw), "bias": zeros(Cw)},
               "w_mean": {"kernel": glorot(Cw, K - 1), "bias": zeros(K - 1)},
               "w_log_var": {"kernel": glorot(Cw, K - 1), "bias": zeros(K - 1)},
               "h": {"kernel": glorot(D + K, H), "bias": zeros(H)},
               "z_mean": {"kernel": glorot(H, L), "bias": zeros(L)},
               "z_log_var": {"kernel": glorot(H, L), "bias": zeros(L)},
               "decoder_h": {"kernel": glorot(K + D + L, H), "bias": zeros(H)},
               "x_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -2.0, np.float32)}}
        cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                            intermediate_class_dim=Cw, n_classes=K, use_x_prev=True,
                            bf16_compute=True, gen_backend="pallas")
        t = lambda a: torch.from_numpy(a).to(dev)
        seeds = t((rng.random((B, D)) < 0.1).astype(np.float32))
        eps = t(rng.standard_normal((B, nsteps, L)).astype(np.float32))
        u = t(rng.random((B, nsteps, D)).astype(np.float32))
        ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
        params = params_from_numpy(raw, dev)
        run = lambda uu, rp, params=params, cfg=cfg, seeds=seeds, eps=eps, ws=ws: (
            cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, uu, ws,
                                           return_probs=rp, mode="int8"))
        name = "int8_cl_vae" if H == 4160 else f"int8_cl_vae_h{H}"
        out[f"{name}_probs_u1"] = run(torch.ones_like(u), True)
        out[f"{name}_frames"] = run(u, False)
        torch.cuda.synchronize()
        again[f"{name}_frames"] = lambda run=run, u=u: run(u, False)
    return again


def _wide_vae(out: dict):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    rng, _ = _inputs(6)
    dev = torch.device("cuda", 0)
    B, nsteps, K, Cw = 64, 64, 13, 88
    again = {}
    for D, H, L, use_xp, mode in ((88, 256, 4, True, "f32"), (1024, 5120, 16, False, "bf16")):
        def dense(i, o):
            lim = np.sqrt(6.0 / (i + o))
            return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                    "bias": np.zeros(o, np.float32)}

        n_xp = D if use_xp else 0
        raw = {"h_w": dense(D, Cw), "w_mean": dense(Cw, K - 1), "w_log_var": dense(Cw, K - 1),
               "h": dense(D + K, H), "z_mean": dense(H, L), "z_log_var": dense(H, L),
               "decoder_h": dense(K + n_xp + L, H), "x_decoded_mean": dense(H, D)}
        raw["x_decoded_mean"]["bias"][:] = -2.0
        cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                            intermediate_class_dim=Cw, n_classes=K, use_x_prev=use_xp,
                            bf16_compute=mode == "bf16")
        t = lambda a: torch.from_numpy(a).to(dev)
        seeds = t((rng.random((B, D)) < 0.1).astype(np.float32))
        eps = t(rng.standard_normal((B, nsteps, L)).astype(np.float32))
        u = t(rng.random((B, nsteps, D)).astype(np.float32))
        ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
        params = params_from_numpy(raw, dev)
        run = lambda uu, rp, params=params, cfg=cfg, seeds=seeds, eps=eps, ws=ws: (
            cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, uu, ws,
                                           return_probs=rp))
        name = f"{mode}_cl_vae_h{H}"
        out[f"{name}_probs_u1"] = run(torch.ones_like(u), True)
        out[f"{name}_frames"] = run(u, False)
        torch.cuda.synchronize()
        again[f"{name}_frames"] = lambda run=run, u=u: run(u, False)
    return again


def _cluster_vae(out: dict):
    """The f32 / bf16 cl_vae generation kernel at the widths of the committed
    checkpoints and below 8 blocks: the trained jsball_vae (f32, D=H=88,
    L=4, x_prev), and seeded weights in bf16 at H=256 and without hidden
    layers (f32), 64 songs x 64 steps (in a checkout with the cluster
    kernel, its outputs; in its parent, the kernels it replaced)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    rng, _ = _inputs(7)
    dev = torch.device("cuda", 0)
    B, nsteps, D, L, K = 64, 64, 88, 4, 13
    again = {}
    for name, H, mode in (("jsball_vae", 88, "f32"), ("bf16_cl_vae_h256", 256, "bf16"),
                          ("no_hidden_cl_vae", 0, "f32")):
        if name == "jsball_vae":
            raw, cfg, _ = common.load_model("artifacts/jsball_vae.npz", "cl_vae")
        else:
            def dense(i, o):
                lim = np.sqrt(6.0 / (i + o))
                return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                        "bias": np.zeros(o, np.float32)}

            raw = {"h_w": dense(D, 88), "w_mean": dense(88, K - 1),
                   "w_log_var": dense(88, K - 1)}
            if H:
                raw.update(h=dense(D + K, H), z_mean=dense(H, L), z_log_var=dense(H, L),
                           decoder_h=dense(K + D + L, H), x_decoded_mean=dense(H, D))
            else:
                raw.update(z_mean=dense(D + K, L), z_log_var=dense(D + K, L),
                           x_decoded_mean=dense(K + D + L, D))
            raw["x_decoded_mean"]["bias"][:] = -2.0
            cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                                intermediate_class_dim=88, n_classes=K, use_x_prev=True,
                                bf16_compute=mode == "bf16")
        t = lambda a: torch.from_numpy(a).to(dev)
        seeds = t((rng.random((B, D)) < 0.1).astype(np.float32))
        eps = t(rng.standard_normal((B, nsteps, cfg.latent_dim)).astype(np.float32))
        u = t(rng.random((B, nsteps, D)).astype(np.float32))
        ws = torch.eye(cfg.n_classes, device=dev)[torch.arange(B, device=dev) % cfg.n_classes]
        params = params_from_numpy(raw, dev)
        run = lambda uu, rp, params=params, cfg=cfg, seeds=seeds, eps=eps, ws=ws: (
            cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, uu, ws,
                                           return_probs=rp))
        out[f"{name}_probs_u1"] = run(torch.ones_like(u), True)
        out[f"{name}_frames"] = run(u, False)
        torch.cuda.synchronize()
        again[f"{name}_frames"] = lambda run=run, u=u: run(u, False)
        again[f"{name}_probs_u1"] = lambda run=run, u=u: run(torch.ones_like(u), True)
    return again


def save(path: str, root: str | None):
    if root:
        sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import classifying_vae_lstm_tpu_torch

    print(f"package: {Path(classifying_vae_lstm_tpu_torch.__file__).parent}")
    out: dict = {}
    again = {}
    for part in (_lstm, _two_cell, _vae, _int8, _int8_vae, _wide_vae, _cluster_vae):
        again.update(part(out) or {})
    torch.cuda.synchronize()
    differ = []
    for name, fn in again.items():
        second = fn()
        torch.cuda.synchronize()
        first = out[name] if isinstance(out[name], (tuple, list)) else (out[name],)
        second = second if isinstance(second, (tuple, list)) else (second,)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            differ.append(name)
    print(f"a second call of {sorted(again)}: bitwise equal: {not differ}"
          + (f"; differ: {differ}" if differ else ""))
    flat = {f"{k}/{i}": t.cpu() for k, v in out.items()
            for i, t in enumerate(v if isinstance(v, (tuple, list)) else (v,)) if t is not None}
    torch.save(flat, path)
    print(f"saved {len(flat)} outputs of {len(out)} kernel calls to {path}")
    return 1 if differ else 0


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
        return save(args.out, args.root or str(Path(__file__).resolve().parents[1]))
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
