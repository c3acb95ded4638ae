"""The fp32-cache form of K1/K2, on the CPU.

The port's fp32 kernels (``csrc/flash_attend_f32.cu`` ``attend_f32_kernel``
and, for 64-row tiles, ``attend_f32_tile_kernel``) size their query tile to
the G*Q rows of one (row, kv head) through the host function
``f32_tile_plan``. Here: the plan is a function of G*Q and D only
and fits a block's shared memory, the split plan is the one every cache
type shares, and the plain versions the kernel is held to on the card
(``reference_attend`` and the split arithmetic ``split_attend``) agree with
the JAX package's ``reference_attend`` in fp32 at 2e-5 (atol = rtol) at the
G*Q values where the query tiles cut: causal, tree bias, ALiBi and the
fused append into a stacked cache.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import attention as jatt
from flexflow_tpu_torch.kernels import attention as tatt

TOL = 2e-5
# G*Q -> (query heads, kv heads, query width): one row, a decode, GQA at
# 16, multi-query past one tile of 16, a prefill chunk, past one tile of
# 64, and Falcon-7B's 71 heads on one kv head at width 8
GQ_SHAPES = {1: (4, 4, 1), 8: (8, 8, 8), 16: (8, 4, 8), 17: (17, 1, 1),
             64: (8, 8, 64), 65: (13, 1, 5), 568: (71, 1, 8)}
MODES = ("causal", "tree-bias", "alibi")


@pytest.mark.parametrize("gq,D,qm", [
    (1, 128, 8), (8, 128, 8), (9, 128, 16), (16, 128, 16), (17, 128, 32),
    (32, 64, 32), (33, 64, 64), (64, 128, 64), (65, 128, 64),
    (568, 64, 64), (1, 512, 8), (8, 512, 8), (16, 512, 16),
    (64, 512, 16), (568, 256, 16), (17, 2816, 8)])
def test_f32_tile_plan_by_gq(gq, D, qm):
    # the least tile that holds G*Q rows, else the largest; the wide
    # kernel (D >= 256) stages q whole, so its tiles stop at 16 rows, and
    # at 8 once 16 rows of q no longer fit
    assert list(inspect.signature(tatt.f32_tile_plan).parameters) == [
        "GQ", "D"]
    got, smem = tatt.f32_tile_plan(gq, D)
    assert got == qm
    assert smem == tatt.f32_smem_bytes(qm, D)


@pytest.mark.parametrize("D", [64, 128, 256, 512, 768, 1024, 2560, 5120])
def test_f32_plans_fit_shared_memory(D):
    sms_share = 228 * 1024            # an SM's shared memory
    for gq in range(1, 600):
        qm, smem = tatt.f32_tile_plan(gq, D)
        tiles = (tatt.F32_WIDE_QUERY_TILES if D >= tatt.WIDE_HEAD_DIM
                 else tatt.F32_QUERY_TILES)
        assert qm in tiles and smem <= tatt.SMEM_PER_BLOCK
        # q [qm, D + 4] and the ring [stages, 32, DC + 4], fp32; the
        # 64-row tile swizzles (no padding) and adds P [64, 64], corr, l
        dcol = min(D, tatt.WIDE_HEAD_DIM)
        stages = (tatt.F32_WIDE_STAGES if D >= tatt.WIDE_HEAD_DIM
                  else tatt.F32_STAGES)
        if qm == 64:
            assert smem == 4 * (64 * D + 4 * 32 * D + 64 * 64 + 2 * 64)
        else:
            assert smem == 4 * (qm * (D + 4) + stages * tatt.F32_UNIT
                                * (dcol + 4))
        if D <= 512:
            # two blocks an SM (1 KiB each reserved), as split_plan assumes
            assert 2 * (smem + 1024) <= sms_share
    # past 5120 no fp32 tile fits: the kernel does not take such a cache
    assert tatt.f32_tile_plan(1, 5376) is None
    assert tatt.kernel_takes("cuda", 256, 5120, torch.float32)
    assert not tatt.kernel_takes("cuda", 256, 5376, torch.float32)
    assert tatt.kernel_takes("cuda", 256, 5376, torch.bfloat16)


def test_split_plan_is_the_same_for_fp32():
    # one plan for every cache type: it takes no dtype and no query width
    assert list(inspect.signature(tatt.split_plan).parameters) == [
        "R", "KH", "S", "sms"]
    assert tatt.split_plan(8, 32, 256, 132) == (1, 4)
    assert tatt.split_plan(8, 32, 4096, 132) == (1, 64)
    assert tatt.split_plan(1, 32, 4096, 132) == (8, 8)
    assert tatt.split_plan(8, 12, 256, 132) == (1, 4)      # D320's heads
    assert tatt.split_plan(2, 4, 1024, 132) == (4, 4)


def _inputs(gq, mode, seed, D=None, L=None):
    """numpy inputs of one case: R 2 over S 128 (two 64-position tiles)."""
    H, KH, Q = GQ_SHAPES[gq]
    D = D or (64 if gq >= 64 else 128)
    R, S = 2, 128
    rng = np.random.RandomState(seed)
    lead = () if L is None else (L,)
    c = dict(q=rng.randn(R, Q, H, D).astype(np.float32),
             k=rng.randn(*lead, R, KH, S, D).astype(np.float32),
             v=rng.randn(*lead, R, KH, S, D).astype(np.float32),
             lengths=np.array([S - 3, 37], np.int32), bias=None, alibi=None,
             causal=True)
    c["qpos"] = (c["lengths"][:, None] - Q
                 + np.arange(Q, dtype=np.int32)[None]).clip(0).astype(
                     np.int32)
    if mode == "tree-bias":
        bias = np.where(rng.rand(R, Q, S) < 0.4, jatt.NEG_INF, 0.0)
        bias[:, :, 0] = 0.0           # at least one visible key per row
        c.update(bias=bias.astype(np.float32), causal=False)
    elif mode == "alibi":
        c["alibi"] = (rng.rand(H) * 0.2).astype(np.float32)
    return c


def _jax_ref(c, k, v):
    def j(a):
        return None if a is None else jnp.asarray(a)

    return np.asarray(jatt.reference_attend(
        j(c["q"]), j(k), j(v), j(c["lengths"]), j(c["qpos"]),
        bias=j(c["bias"]), alibi=j(c["alibi"]), causal=c["causal"]))


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gq", sorted(GQ_SHAPES))
def test_fp32_plain_versions_match_jax(gq, mode):
    c = _inputs(gq, mode, seed=gq + 7 * MODES.index(mode))
    jref = _jax_ref(c, c["k"], c["v"])
    kw = dict(bias=_t(c["bias"]), alibi=_t(c["alibi"]), causal=c["causal"])
    args = (_t(c["q"]), _t(c["k"]), _t(c["v"]), _t(c["lengths"]),
            _t(c["qpos"]))
    ref = tatt.reference_attend(*args, **kw)
    # the kernels' arithmetic over 64-position tiles, one split and two
    # (one tile each, combined in order)
    splits = [tatt.split_attend(*args, plan=plan, **kw)
              for plan in ((1, 2), (2, 1))]
    assert ref.dtype == torch.float32
    for out in [ref] + splits:
        np.testing.assert_allclose(out.numpy(), jref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("gq", sorted(GQ_SHAPES))
def test_fp32_stacked_append_matches_jax(gq):
    # K2's form on a stacked [L, R, KH, S, D] cache: the new row written in
    # place into layer 1 at appos = lengths - 1 (row 1 skipped with -1),
    # then attention over that layer; the JAX side on the numpy append
    c = _inputs(gq, "causal", seed=100 + gq, L=3)
    H, KH, Q = GQ_SHAPES[gq]
    R, D = c["q"].shape[0], c["q"].shape[-1]
    rng = np.random.RandomState(200 + gq)
    kn = rng.randn(R, 1, KH, D).astype(np.float32)
    vn = rng.randn(R, 1, KH, D).astype(np.float32)
    appos = np.array([c["lengths"][0] - 1, -1], np.int32)
    k_np, v_np = c["k"].copy(), c["v"].copy()
    k_np[1, 0, :, appos[0]] = kn[0, 0]
    v_np[1, 0, :, appos[0]] = vn[0, 0]
    jref = _jax_ref(c, k_np[1], v_np[1])
    tk, tv = _t(c["k"]), _t(c["v"])
    out, k_out, v_out = tatt.flash_attend(
        _t(c["q"]), tk, tv, _t(c["lengths"]), _t(c["qpos"]),
        append_kv=(_t(kn), _t(vn), _t(appos)), layer_idx=1)
    assert k_out is tk and v_out is tv
    np.testing.assert_array_equal(tk.numpy(), k_np)
    np.testing.assert_array_equal(tv.numpy(), v_np)
    np.testing.assert_allclose(out.numpy(), jref, atol=TOL, rtol=TOL)
