"""The tools' step-decomposition probes (``ops/exp_lstm.py``): each plain
version against the TPU tool's own kernel in interpret mode.

The Pallas calls are built around the tools' kernel bodies as the tools
build them (``tools/exp_h512_ablation.run_micro``,
``tools/repro_full_bwd_fault.run_mini``) or come from the tool itself
(``tools/exp_lstm_interleave._interleaved_call``); no tool file is changed.
Inputs come from numpy with a seed. Shapes: (B, H, bb) = (64, 128, 32) for
the h512 kernels (their ``--smoke`` shape), T=8, B=32, H=16, block_b=16,
block_t=4 for the interleave, the tool's MINI shape (B=40, H=256, T=8,
IN=128, a 16-row block that 40 rows leave partial) for the six mini cases.

Tolerances, each against the largest entry of the output (of each output
block for the h512 kernels, which carry their state across blocks):

* the chains: 1e-2 (bf16 operands, f32 sums; h is rounded to bf16 every
  step, so a summation order that flips one rounding moves the rest of the
  chain by about a bf16 step);
* the gates kernels: 1e-5 (f32 elementwise, another tanh);
* the off-chain product: 1e-5 (exact bf16 products, f32 sums in another
  order);
* the mini walk: 1e-4 for its f32 accumulators (they grow ~H times a step,
  to ~5e16) and 1e-2 for dx, bf16, each step's slice apart;
* the interleave: 1e-2 against JAX's kernel (bf16 z and h operands) and
  1e-5 against the port's ``lstm_seq_xz_train_fwd_plain``, as the JAX tool
  holds its kernel to ``_forward_train_call``.

The magnitudes are guarded: rk is scaled by 1 / (0.02 sqrt(H)) so that |h|
stays within [1e-3, 1e3] over all nb*T steps of a chain (the tool's
rk * 0.02 drives h to ~1e-21 by T=16, where any kernel passes), and the
tests assert that it does. The card-only comparisons of the CUDA kernels
with these plain versions are in ``tests/test_torch_cuda.py`` (``-k exp``).
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex  # noqa: E402
from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls  # noqa: E402
from tools import exp_h512_ablation as h512  # noqa: E402
from tools import exp_lstm_interleave as ilv  # noqa: E402
from tools import repro_full_bwd_fault as fault  # noqa: E402

B, H, BB = 64, 128, 32  # the h512 tool's --smoke shape
H4, NB, T = 4 * H, B // BB, h512.T
V = pltpu.VMEM


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(width):
    return pl.BlockSpec((BB, width), lambda b: (b, 0), memory_space=V)


def _const(rows, width):
    return pl.BlockSpec((rows, width), lambda b: (0, 0), memory_space=V)


def _call(kernel, in_specs, out_specs, out_shape, scratch):
    # run_micro's pallas_call, in interpret mode off the TPU
    return pl.pallas_call(kernel, grid=(NB,), in_specs=in_specs, out_specs=out_specs,
                          out_shape=out_shape, scratch_shapes=scratch,
                          interpret=jax.default_backend() != "tpu",
                          compiler_params=h512._params())


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _jbf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _rk(rng):
    # keeps |h| of O(1) over the chain: the product's gain 0.02 sigma sqrt(H) is 1
    return _f32(rng, H, H4, scale=1 / (0.02 * np.sqrt(H)))


def _close_per_block(got, want, tol, lo=1e-3, hi=1e3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    for b in range(NB):
        g, w = got[b * BB:(b + 1) * BB], want[b * BB:(b + 1) * BB]
        top = np.abs(w).max()
        assert np.isfinite(g).all() and lo <= top <= hi, (b, top)
        assert np.abs(g - w).max() <= tol * top, (b, np.abs(g - w).max(), top)


@pytest.mark.parametrize("name", ["chain_mm", "chain_mm_x2"])
def test_chain_matches_the_tool_kernel(name):
    rng = np.random.default_rng(0)
    h0, rk = _f32(rng, B, H), _rk(rng)
    kern = {"chain_mm": h512._chain_mm_kernel, "chain_mm_x2": h512._chain_mm_x2_kernel}[name]
    call = _call(kern, [_rows(H), _const(H, H4)], _rows(H),
                 jax.ShapeDtypeStruct((B, H), jnp.float32), [V((BB, H), jnp.float32)])
    want = call(jnp.asarray(h0), _jbf16(rk))
    got = getattr(ex, name)(torch.from_numpy(h0), _bf16(rk), BB)
    _close_per_block(got, want, 1e-2)


def test_chain_carries_the_state_across_blocks():
    """Block 1 continues block 0's rows; it never reads its own h0 rows (the
    TPU kernel's scratch is set at grid step 0 only)."""
    rng = np.random.default_rng(0)
    h0, rk = torch.from_numpy(_f32(rng, B, H)), _bf16(_rk(rng))
    out = ex.chain_mm(h0, rk, BB)
    h0b = h0.clone()
    h0b[BB:] = 0.0
    assert torch.equal(ex.chain_mm(h0b, rk, BB), out)
    assert torch.equal(ex.chain_mm(h0[:BB], rk, BB, T=NB * T), out[BB:])


@pytest.mark.parametrize("name", ["chain_mm_x2_fullwidth", "chain_mm_encdec"])
def test_two_chains_match_the_tool_kernel(name):
    rng = np.random.default_rng(1)
    h0, g0, rkA, rkB = _f32(rng, B, H), _f32(rng, B, H), _rk(rng), _rk(rng)
    kern = {"chain_mm_x2_fullwidth": h512._chain_mm_x2_full_kernel,
            "chain_mm_encdec": h512._chain_mm_encdec_kernel}[name]
    out = jax.ShapeDtypeStruct((B, H), jnp.float32)
    call = _call(kern, [_rows(H), _rows(H), _const(H, H4), _const(H, H4)],
                 (_rows(H), _rows(H)), (out, out), [V((BB, H), jnp.float32)] * 2)
    want = call(jnp.asarray(h0), jnp.asarray(g0), _jbf16(rkA), _jbf16(rkB))
    got = getattr(ex, name)(torch.from_numpy(h0), torch.from_numpy(g0), _bf16(rkA),
                            _bf16(rkB), BB)
    for g, w in zip(got, want):
        _close_per_block(g, w, 1e-2)


def test_encdec_couples_the_second_chain():
    rng = np.random.default_rng(1)
    args = (torch.from_numpy(_f32(rng, B, H)), torch.from_numpy(_f32(rng, B, H)),
            _bf16(_rk(rng)), _bf16(_rk(rng)), BB)
    a_full, b_full = ex.chain_mm_x2_fullwidth(*args)
    a_enc, b_enc = ex.chain_mm_encdec(*args)
    assert torch.equal(a_full, a_enc) and torch.equal(a_full, ex.chain_mm(args[0], args[2], BB))
    assert not torch.equal(b_full, b_enc)


@pytest.mark.parametrize("name", ["gates_fwd", "gates_bwd"])
def test_gates_match_the_tool_kernel(name):
    rng = np.random.default_rng(2)
    z0 = _f32(rng, B, H4)
    kern = {"gates_fwd": h512._gates_fwd_kernel, "gates_bwd": h512._gates_bwd_kernel}[name]
    call = _call(kern, [_rows(H4)], _rows(H), jax.ShapeDtypeStruct((B, H), jnp.float32),
                 [V((BB, H), jnp.float32)])
    want = call(jnp.asarray(z0))
    got = getattr(ex, name)(torch.from_numpy(z0), BB)
    # gates_fwd's state is o * tanh(c), within (-1, 1); gates_bwd's grows or
    # shrinks by a fixed factor an element and step
    _close_per_block(got, want, 1e-5, lo=1e-2, hi=1e4)


def test_offchain_matches_the_tool_kernel():
    rng = np.random.default_rng(3)
    hp, dz, xp = _f32(rng, B, H), _f32(rng, B, H4), _f32(rng, B, 128)
    shapes = (jax.ShapeDtypeStruct((H, H4), jnp.float32),
              jax.ShapeDtypeStruct((128, H4), jnp.float32))
    call = _call(h512._offchain_mm_kernel, [_rows(H), _rows(H4), _rows(128)],
                 (_const(H, H4), _const(128, H4)), shapes, [V((BB, H4), jnp.float32)])
    want = call(_jbf16(hp), _jbf16(dz), _jbf16(xp))
    got = ex.offchain_mm(_bf16(hp), _bf16(dz), _bf16(xp), BB)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # every block is multiplied by block 0's dz
    d0 = _bf16(dz)[:BB].float()
    ref = sum(_bf16(hp)[b * BB:(b + 1) * BB].float().T @ d0 for b in range(NB)) * T
    assert torch.allclose(got[0], ref, rtol=1e-5, atol=1e-3)


def test_interleave_matches_the_tool_kernel_and_the_training_forward():
    rng = np.random.default_rng(4)
    Ti, Bi, Hi = 8, 32, 16
    xz, rk = _f32(rng, Ti, Bi, 4 * Hi), _f32(rng, Hi, 4 * Hi, scale=0.05)
    h0, c0 = _f32(rng, Bi, Hi, scale=0.1), _f32(rng, Bi, Hi, scale=0.1)
    want = ilv._interleaved_call(_jbf16(xz), _jbf16(rk), jnp.asarray(h0), jnp.asarray(c0),
                                 block_b=16, block_t=4)
    args = (_bf16(xz), _bf16(rk), torch.from_numpy(h0), torch.from_numpy(c0))
    got = ex.lstm_interleave_train_fwd(*args)
    base = ls.lstm_seq_xz_train_fwd_plain(*args)
    assert [g.dtype for g in got] == [torch.float32, torch.float32, torch.bfloat16]
    for g, w, b in zip(got, want, base):
        g, w, b = g.float().numpy(), np.asarray(w, np.float32), b.float().numpy()
        assert 1e-2 < np.abs(w).max() < 1e2
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, b, atol=1e-5, rtol=1e-5)


def _mini_call(case):
    # run_mini's pallas_call around the tool's kernel body
    Bm, Hm, Tm, IN, bb, bt = (fault.MINI[k] for k in ("B", "H", "T", "IN", "bb", "bt"))
    H4m, nb, nt = 4 * Hm, pl.cdiv(Bm, bb), Tm // bt
    rev = lambda b, t: (nt - 1 - t, b, 0)  # noqa: E731
    const = lambda b, t: (0, 0)  # noqa: E731
    dw_rows = IN if case == "min_all" else Hm
    return pl.pallas_call(
        functools.partial(fault._mini_kernel, case, nt, Bm), grid=(nb, nt),
        in_specs=[pl.BlockSpec((bt, bb, H4m), rev, memory_space=V),
                  pl.BlockSpec((bt, bb, Hm), rev, memory_space=V),
                  pl.BlockSpec((bt, bb, IN), rev, memory_space=V)],
        out_specs=(pl.BlockSpec((bt, bb, IN), rev, memory_space=V),
                   pl.BlockSpec((Hm, H4m), const, memory_space=V),
                   pl.BlockSpec((dw_rows, H4m), const, memory_space=V),
                   pl.BlockSpec((1, H4m), const, memory_space=V)),
        out_shape=(jax.ShapeDtypeStruct((Tm, Bm, IN), jnp.bfloat16),
                   jax.ShapeDtypeStruct((Hm, H4m), jnp.float32),
                   jax.ShapeDtypeStruct((dw_rows, H4m), jnp.float32),
                   jax.ShapeDtypeStruct((1, H4m), jnp.float32)),
        scratch_shapes=[V((bb, Hm), jnp.float32)],
        interpret=jax.default_backend() != "tpu",
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=96 * 2**20))


@pytest.mark.parametrize("case", ex.MINI_CASES)
def test_mini_walk_matches_the_tool_kernel(case):
    assert fault.CASES[:6] == list(ex.MINI_CASES)
    Bm, Hm, Tm, IN = (fault.MINI[k] for k in ("B", "H", "T", "IN"))
    assert Bm % fault.MINI["bb"] != 0  # the last row tile is partial
    rng = np.random.default_rng(5)
    z, h, x = _f32(rng, Tm, Bm, 4 * Hm), _f32(rng, Tm, Bm, Hm), _f32(rng, Tm, Bm, IN)
    want = _mini_call(case)(_jbf16(z), _jbf16(h), _jbf16(x))
    got = ex.mini_walk(case, _bf16(z), _bf16(h), _bf16(x))
    # only the outputs a case writes are compared: the others are never
    # initialised by the TPU kernel (NaN in interpret mode)
    written = [case in ("min_dx_out", "min_all"), True, case in ("min_dw", "min_all"),
               case in ("min_db", "min_all")]
    for i, (g, w, wr) in enumerate(zip(got, want, written)):
        assert (g is not None) == wr
        if not wr:
            continue
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.isfinite(g).all() and g.shape == w.shape
        if i == 0:  # dx, bf16: each step against its own largest entry
            for t in range(Tm):
                assert np.abs(g[t] - w[t]).max() <= 1e-2 * np.abs(w[t]).max(), t
        else:  # the accumulators reach ~5e16: relative to the largest entry
            assert np.abs(w).max() > 1e15
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_plain_versions_refuse_what_the_kernels_do_not_take():
    h0 = torch.zeros(64, 16)
    with pytest.raises(ValueError, match="multiple of bb"):
        ex.chain_mm(h0, torch.zeros(16, 64, dtype=torch.bfloat16), 48)
    with pytest.raises(ValueError, match="and bb of 2"):
        ex.chain_mm_x2(torch.zeros(63, 16), torch.zeros(16, 64, dtype=torch.bfloat16), 21)
    with pytest.raises(ValueError, match="case"):
        ex.mini_walk("min_none", *(torch.zeros(2, 16, s, dtype=torch.bfloat16)
                                   for s in (16, 4, 4)))


def test_launch_counts_start_at_zero_and_reset():
    ex.reset_counts()
    assert ex.counts() == {k: 0 for k in ex.KERNELS}
    ex.chain_mm(torch.zeros(64, 16), torch.zeros(16, 64, dtype=torch.bfloat16), 32)
    assert ex.counts()["chain_mm"] == 0  # the CPU runs the plain version: no launch


def _tool(name, *args):
    # one intra-op thread in the tool's processes too
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(ROOT / "tools" / name), *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)


def test_fault_ladder_tool_runs_the_plain_versions_on_the_cpu(tmp_path):
    """``tools/torch_repro_full_bwd_fault.py --device cpu``: each mini case
    in its own process, every output finite; the real and autograd rungs
    are the card's (the plain versions at B=500 need no CPU run here)."""
    out = tmp_path / "ladder.json"
    r = _tool("torch_repro_full_bwd_fault.py", "--device", "cpu", "--cases", "min_base,min_all",
              "--out", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    import json

    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and [row["case"] for row in doc["rows"]] == ["min_base",
                                                                             "min_all"]
    assert all(row["returncode"] == 0 and row["finite"] for row in doc["rows"])


def test_ablation_tool_smoke_on_the_cpu():
    r = _tool("torch_exp_h512_ablation.py", "--device", "cpu", "--smoke")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "plain versions only" in r.stdout


@pytest.mark.parametrize("name", ["chain_mm", "chain_mm_x2_fullwidth"])
def test_blockwise_plain_restarts_each_block_from_the_carried_state(name):
    rng = np.random.default_rng(6)
    h0, g0 = torch.from_numpy(_f32(rng, B, H)), torch.from_numpy(_f32(rng, B, H))
    rks = (_bf16(_rk(rng)),) if name == "chain_mm" else (_bf16(_rk(rng)), _bf16(_rk(rng)))
    starts = (h0,) if name == "chain_mm" else (h0, g0)
    whole = getattr(ex, f"{name}_plain")(*starts, *rks, BB)
    blockwise = ex.chain_plain_blockwise(name, whole, *starts, *rks, bb=BB)
    for w, b in zip(whole if isinstance(whole, tuple) else (whole,),
                    blockwise if isinstance(blockwise, tuple) else (blockwise,)):
        assert torch.equal(w, b)
    # a kernel that started block 1 from its own h0 rows would be caught
    shifted = getattr(ex, f"{name}_plain")(*(s.roll(BB, 0) for s in starts), *rks, BB)
    first = lambda o: o[0] if isinstance(o, tuple) else o  # noqa: E731
    wrong = torch.cat([first(whole)[:BB], first(shifted)[:BB]])
    got = first(ex.chain_plain_blockwise(name, (wrong, wrong) if isinstance(whole, tuple)
                                         else wrong, *starts, *rks, bb=BB))
    assert not torch.allclose(got[BB:], wrong[BB:], rtol=1e-2, atol=1e-2)


def _chain_in_another_order(h, rk, nb, order, T=T):
    # chain_mm_plain's function with another correct f32 sum order of each
    # step's product: the K sum split into its even and odd terms, or taken
    # in f64 and rounded back to f32
    Hc = h.shape[1]
    rkf = rk.float()[:, :Hc]
    outs = []
    for _ in range(nb):
        for _ in range(T):
            op = h.to(torch.bfloat16).float()
            if order == "even_odd":
                p = op[:, 0::2] @ rkf[0::2] + op[:, 1::2] @ rkf[1::2]
            else:
                p = (op.double() @ rkf.double()).float()
            h = p * 0.02
        outs.append(h)
    return torch.cat(outs)


@pytest.mark.parametrize("order", ["even_odd", "f64"])
def test_two_correct_chains_part_by_about_a_percent(order):
    """Why the card tests hold the chain kernels block by block
    (``chain_plain_blockwise``) and one step at a time, and not as whole
    chains: the plain chain against itself with another sum order, on the
    card test's inputs at (B, H, bb) = (1,024, 512, 256) (nb*T = 64 steps).
    One step parts by ~3e-7 of the largest entry; h is rounded to bf16 every
    step, so flipped roundings pile up: the whole chains part by more than
    the 1e-2 the kernels are held to, while each 16-step block restarted from
    the other chain's own state stays within it (~6e-3)."""
    Bw, Hw, bbw = 1024, 512, 256
    rng = np.random.default_rng(0)  # tests/test_torch_cuda.py _exp_inputs(dev, 1024, 512)
    h0 = torch.from_numpy(_f32(rng, Bw, Hw))
    _f32(rng, Bw, Hw)  # g0
    rk = _bf16(_f32(rng, Hw, 4 * Hw, scale=50 / np.sqrt(Hw)))
    rel = lambda g, w: ((g - w).abs().max() / w.abs().max()).item()  # noqa: E731
    blocks = [slice(b * bbw, (b + 1) * bbw) for b in range(Bw // bbw)]
    other = _chain_in_another_order(h0[:bbw], rk, Bw // bbw, order)
    whole = ex.chain_mm_plain(h0, rk, bbw)
    restarted = ex.chain_plain_blockwise("chain_mm", other, h0, rk, bb=bbw)
    for s in blocks:
        assert 1e-3 <= whole[s].abs().max().item() <= 1e3
    one = rel(_chain_in_another_order(h0[:bbw], rk, 1, order, T=1),
              ex.chain_mm_plain(h0[:bbw], rk, bbw, T=1))
    assert one <= 1e-5, one
    assert max(rel(other[s], whole[s]) for s in blocks) > 1e-2
    assert all(rel(other[s], restarted[s]) <= 1e-2 for s in blocks)
