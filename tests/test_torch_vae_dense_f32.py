"""The plan of the f32 dense-stack kernels (``ops/vae_dense.plan``), on the CPU.

The kernels (``csrc/vae_dense.cu``) run only on the card. How a call is laid
out there comes from a plan that the library computes in C and checks
against this Python mirror when it loads. These tests hold the mirror:

* the training shape (the jsball_vae widths with 13 keys, B=100) is
  resident: every weight in each block's shared memory, 4 rows and 512
  threads a block; the seq-concat width (D=976, Cw=256, H=1024, L=16,
  B=1024) streams its weights through a ring, 8 rows a block; wider shapes
  stream 4, 2 and 1 rows a block (the card tests' streamed cases);
* the plan refuses exactly the configs :func:`vae_dense.fits` refuses, at
  random widths and at the edge of the width rule;
* its shared-memory bytes equal a recount of the tiles each kernel takes
  (the order of ``take`` in the kernels), within the card's limit;
* its weight-gradient tiles cover every weight and bias gradient once.
"""

import dataclasses
import random

import pytest

from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

TRAIN = dict(B=100, D=88, Cw=88, H=88, L=4, K=13, use_xp=True)
WIDE = dict(B=1024, D=976, Cw=256, H=1024, L=16, K=13, use_xp=True)


def _plan(d, **kw):
    return vd.plan(d["B"], d["D"], d["Cw"], d["H"], d["L"], d["K"], d["use_xp"], **kw)


def _cfg(d):
    return tvae.Config(original_dim=d["D"], intermediate_dim=d["H"], latent_dim=d["L"],
                       intermediate_class_dim=d["Cw"], n_classes=d["K"], use_x_prev=d["use_xp"])


def test_training_shape_is_resident():
    p = _plan(TRAIN)
    weights = 88 * 88 * 4 + 88 * 24 + 13 * 88 * 2 + 88 * 8 + 4 * 88  # 36,432 floats
    assert (p.resident, p.rows, p.threads, p.stages, p.slot) == (True, 4, 512, 0, 0)
    assert p.wfloats == weights and p.tiles == 25
    assert p.wg_tile == 32 and max(p.fwd_smem, p.bwd_smem) <= 232448
    assert p.scratch == 100 * (88 + 2 * 88 + 3 * 4 + 24 + 88)


def test_wide_shape_streams():
    p = _plan(WIDE)
    assert (p.resident, p.rows, p.threads, p.stages) == (False, 8, 256, 3)
    # a slot holds 8 rows of the 1,024-wide weights and 8 columns of the 1,024-tall ones
    assert p.slot >= 8 * 1024 + 8 and p.wfloats == 3 * p.slot
    assert (p.tiles, p.wg_tile) == (128, 64) and max(p.fwd_smem, p.bwd_smem) <= 232448
    assert vd.smem_bytes(_cfg(WIDE)) == max(p.fwd_smem, p.bwd_smem)


# (shape, rows a block, ring slots) of the streamed layout: the shapes of
# tests/test_torch_cuda.py's streamed cases and of the library's plan checks
STREAMED = {
    "wide": (WIDE, 8, 3),
    "two_column_passes": (dict(B=9, D=300, Cw=40, H=280, L=5, K=13, use_xp=True), 8, 3),
    "four_rows": (dict(B=9, D=1024, Cw=256, H=2048, L=16, K=13, use_xp=True), 4, 3),
    # the f32 seq-concat width of the H=5,120 checkpoints
    "two_rows": (dict(B=5, D=1024, Cw=256, H=5120, L=16, K=13, use_xp=True), 2, 3),
    "one_row": (dict(B=3, D=7000, Cw=64, H=96, L=4, K=5, use_xp=True), 1, 3),
    "one_row_two_slots": (dict(B=4, D=16, Cw=14400, H=16, L=1, K=2, use_xp=False), 1, 2),
}


@pytest.mark.parametrize("case", sorted(STREAMED))
def test_streamed_rows_a_block(case):
    """The streamed layout takes the most rows a block (8, 4, 2, 1) that fit
    beside its ring, and as many slots (3, else 2) as leave room for them."""
    d, rows, stages = STREAMED[case]
    p = _plan(d)
    assert (p.resident, p.rows, p.threads, p.stages) == (False, rows, 256, stages)
    assert p.tiles == -(-d["B"] // rows) and max(p.fwd_smem, p.bwd_smem) <= 232448
    if rows < 8:  # twice the rows would not fit beside the ring
        w = (d["D"], d["Cw"], d["H"], d["L"], d["K"])
        fwd = vd._fwd_tiles(*w, d["use_xp"], 2 * rows, 256)
        bwd = vd._bwd_tiles(*w, 2 * rows, 256)
        assert vd._BAR_BYTES + 4 * (p.wfloats + max(fwd, bwd)) > 232448


def _fits_rule(d):
    cfg = _cfg(d)
    return vd.fits(cfg)


def _random_dims(rng):
    return dict(B=rng.choice([1, 7, 100, 300]), D=rng.randint(1, 4000), Cw=rng.randint(1, 4000),
                H=rng.randint(1, 4000), L=rng.randint(1, 140), K=rng.randint(1, 140),
                use_xp=rng.random() < 0.5)


def test_refuses_exactly_what_fits_refuses():
    rng = random.Random(0)
    seen = {True: 0, False: 0}
    for _ in range(3000):
        d = _random_dims(rng)
        accepted = _plan(d) is not None
        assert accepted == _fits_rule(d), d
        seen[accepted] += 1
    assert min(seen.values()) > 200  # both sides of the rule were drawn


def test_accepts_every_width_at_the_edge_of_the_rule():
    """Grow one width to the largest the rule takes (and just past it): the
    plan finds a layout there, and refuses one past."""
    rng = random.Random(1)
    for _ in range(150):
        d = _random_dims(rng)
        d.update(L=rng.randint(1, 128), K=rng.randint(2, 128))
        which = rng.choice(["D", "Cw", "H"])
        lo, hi = 1, 40000
        if not _fits_rule({**d, which: 1}):
            continue
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if _fits_rule({**d, which: mid}) else (lo, mid - 1)
        assert _plan({**d, which: lo}) is not None, (d, which, lo)
        assert _plan({**d, which: lo + 1}) is None


def _recount(d, p):
    """The shared-memory bytes of each kernel from the tiles it takes, in the
    order of ``take`` in csrc/vae_dense.cu (each [F][rows] tile on 16 bytes)."""
    up4 = lambda n: (n + 3) // 4 * 4
    R, T, D, Cw, H, L, K = p.rows, p.threads, d["D"], d["Cw"], d["H"], d["L"], d["K"]
    K1 = K - 1
    fwd = [D, D if d["use_xp"] else 0, Cw, 2 * K1, K, H, 2 * L, L, K1, L]
    fwd_floats = sum(up4(F * R) for F in fwd) + T * R + up4(Cw + 2 * K1 + 2 * H + 2 * L + D)
    bwd = [D, H, K, L, 2 * L, D, 2 * K1, Cw, K, 2 * K1, K1, 2 * K1, 2 * L, L, 2 * L]
    words = [-(-H // 32), -(-H // 32), -(-Cw // 32)]
    bwd_floats = (sum(up4(F * R) for F in bwd) + T * R + sum(up4(w * R) for w in words))
    return 128 + 4 * (p.wfloats + fwd_floats), 128 + 4 * (p.wfloats + bwd_floats)


@pytest.mark.parametrize("d", [TRAIN, WIDE, dict(TRAIN, use_xp=False), dict(WIDE, use_xp=False),
                               dict(B=9, D=300, Cw=40, H=280, L=5, K=13, use_xp=True),
                               dict(B=4, D=16, Cw=14400, H=16, L=1, K=2, use_xp=False)])
def test_bytes_agree_with_the_kernels_tiles(d):
    p = _plan(d)
    assert (p.fwd_smem, p.bwd_smem) == _recount(d, p)
    assert max(p.fwd_smem, p.bwd_smem) <= 232448
    shapes = [(r, c) for r, c in vd._weight_shapes(d["D"], d["Cw"], d["H"], d["L"], d["K"],
                                                   d["use_xp"]) if r]
    if p.resident:
        assert p.wfloats == max(vd._WG_STAGE, sum(-(-r * c // 4) * 4 for r, c in shapes))
    else:
        # a slot takes one row of every weight and one column of every weight
        assert p.slot >= max(max(c, r + 1) for r, c in shapes)
        assert p.wfloats == max(p.stages * p.slot, vd._WG_STAGE)


def test_weight_gradient_tiles_cover_every_job():
    for d in (TRAIN, WIDE, dict(TRAIN, use_xp=False)):
        p = _plan(d)
        jobs = vd._wg_shapes(d["D"], d["Cw"], d["H"], d["L"], d["K"], d["use_xp"])
        assert len(jobs) == 15 - (not d["use_xp"])
        t = p.wg_tile
        covered = sum(-(-M // t) * t * -(-N // t) * t for M, N in jobs)
        assert p.wg_tiles == sum(-(-M // t) * -(-N // t) for M, N in jobs)
        assert covered >= sum(M * N for M, N in jobs)


def test_fits_and_smem_bytes_agree_with_the_plan():
    for d in (TRAIN, WIDE):
        cfg = _cfg(d)
        assert vd.fits(cfg) and 0 < vd.smem_bytes(cfg) <= 232448
    too_wide = _cfg(dict(TRAIN, H=8192))
    assert not vd.fits(too_wide) and vd.smem_bytes(too_wide) == 0
    assert not vd.fits(dataclasses.replace(_cfg(TRAIN), n_classes=129))
