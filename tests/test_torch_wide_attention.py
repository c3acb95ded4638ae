"""The 16-bit wide form of K1/K2 (head dims 256 and its multiples), on the
CPU.

The port's bf16/fp16 wide kernel (``csrc/flash_attend.cu``
``attend_mma_wide_kernel``) launches a cluster of one block per 256-column
slice of O for each (row, kv head, query tile, split), two blocks an SM,
and takes its split plan from ``wide_split_plan``. Here: the plan depends
on (R, KH, S, D, SM count) only, fills an H100 in one wave at the serving
shapes, and leaves ``split_plan`` (the D <= 128 and fp32 forms') as it
was; the cluster layout covers every head dim the kernel takes; and the
plain versions the kernel is held to on the card (``reference_attend``
and the split arithmetic ``split_attend`` at the plan's splits) agree with
the JAX package's ``reference_attend`` in fp32 at 1e-5 (atol = rtol) on a
head dim of 320 served from a cache padded to 512 (the padded layout of
``padded_head_dim``).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import attention as jatt
from flexflow_tpu_torch.kernels import attention as tatt
from flexflow_tpu_torch.ops.inc_attention import pad_head_dim

TOL = 1e-5
H100_SMS = 132
# the serving shapes at R 8, S 256: (kv heads, cache head dim) of head dims
# 256 (16 heads), 320 (12 heads on a cache padded to 512), 512 (8 heads)
# and 768 (5 heads)
SERVING = {"D256": (16, 256), "D320": (12, 512), "D512": (8, 512),
           "D768": (5, 768)}


def _blocks(R, KH, D):
    """Blocks a split of the wide kernel launches (one query tile)."""
    _, ncl, cs, _ = tatt.wide_shape(D)
    return R * KH * ncl * cs


def _slots(D, sms=H100_SMS):
    per_sm = tatt.SMEM_PER_SM // (tatt.wide_smem_bytes(D)
                                  + tatt.SMEM_RESERVED)
    return sms * per_sm


def test_wide_plan_depends_on_shapes_only():
    # its inputs are the cache's shapes and the SM count: no query width,
    # no lengths, no dtype
    assert list(inspect.signature(tatt.wide_split_plan).parameters) == [
        "R", "KH", "S", "D", "sms"]
    # a width-1 decode, a width-8 decode and a 64-wide prefill chunk over
    # one cache take one plan: the same arguments give the same plan
    for R, KH, S, D in ((8, 12, 256, 512), (2, 4, 1024, 512),
                        (1, 32, 4096, 256), (4, 4, 512, 768)):
        plans = {Q: tatt.wide_split_plan(R, KH, S, D, H100_SMS)
                 for Q in (1, 8, 64)}
        assert len(set(plans.values())) == 1


@pytest.mark.parametrize("name", sorted(SERVING))
def test_wide_plan_one_wave_at_the_serving_shapes(name):
    KH, D = SERVING[name]
    R, S = 8, 256
    n, tps = tatt.wide_split_plan(R, KH, S, D, H100_SMS)
    assert (n - 1) * tps < -(-S // tatt.BLOCK_S) <= n * tps
    # two 112 KiB blocks an SM: every block of the launch in one wave
    assert _slots(D) == 2 * H100_SMS
    assert n * _blocks(R, KH, D) <= _slots(D)
    # S 256 is 4 tiles: one split (the parent's D 320 launch, 192 blocks
    # at one an SM, took a wave and a half)
    assert (n, tps) == (1, 4)


@pytest.mark.parametrize("R,KH,S,D", [
    (1, 32, 4096, 256), (8, 8, 4096, 512), (2, 4, 1024, 512),
    (4, 4, 512, 256), (4, 4, 512, 768), (1, 1, 64, 512), (3, 4, 200, 1024),
    (1, 2, 32768, 2048), (1, 8, 8192, 2304), (8, 32, 256, 256)])
def test_wide_plan_splits_evenly_within_one_wave(R, KH, S, D):
    n, tps = tatt.wide_split_plan(R, KH, S, D, H100_SMS)
    tiles = -(-S // tatt.BLOCK_S)
    assert (n - 1) * tps < tiles <= n * tps   # whole tiles, no empty split
    assert n == 1 or tps >= tatt.SPLIT_MIN_TILES
    blocks = _blocks(R, KH, D)
    if blocks >= _slots(D):
        assert n == 1
    else:
        assert n * blocks <= _slots(D)
        # no fewer splits than one wave allows, but for the 4-tile minimum
        assert n == -(-tiles // max(-(-tiles // (_slots(D) // blocks)),
                                    tatt.SPLIT_MIN_TILES))


def test_split_plan_unchanged():
    # the D <= 128 and fp32 forms keep their plan
    assert list(inspect.signature(tatt.split_plan).parameters) == [
        "R", "KH", "S", "sms"]
    assert tatt.split_plan(8, 32, 256, 132) == (1, 4)
    assert tatt.split_plan(8, 32, 4096, 132) == (1, 64)
    assert tatt.split_plan(1, 32, 4096, 132) == (8, 8)
    assert tatt.split_plan(8, 12, 256, 132) == (1, 4)
    assert tatt.split_plan(2, 4, 1024, 132) == (4, 4)
    assert tatt.split_plan(2, 2, 512, 132) == (2, 4)
    assert tatt.split_plan(8, 8, 4096, 132) == (5, 13)


@pytest.mark.parametrize("D,shape", [
    (256, (1, 1, 1, 1)), (512, (2, 1, 2, 1)), (768, (3, 1, 3, 1)),
    (2048, (8, 1, 8, 1)), (2304, (9, 2, 5, 2)), (5376, (21, 3, 7, 3)),
    (8192, (32, 4, 8, 4))])
def test_wide_cluster_layout(D, shape):
    nch, ncl, cs, kpr = tatt.wide_shape(D)
    assert (nch, ncl, cs, kpr) == shape
    # every column chunk is some rank's score chunk and some block's
    # output slice; a cluster is at most the portable 8 blocks
    assert cs <= tatt.WIDE_CLUSTER and ncl * cs >= nch
    assert sorted(r + p * cs for r in range(cs) for p in range(kpr)
                  if r + p * cs < nch) == list(range(nch))
    smem = tatt.wide_smem_bytes(D)
    assert smem <= tatt.SMEM_PER_BLOCK
    # q chunks and two [64, 256] 16-bit units, and the fp32 partial
    # scores where a cluster has two ranks or more
    assert smem == (kpr + 2) * 64 * 256 * 2 + (64 * 64 * 4 if cs > 1 else 0)
    if D <= 2048:
        assert 2 * (smem + tatt.SMEM_RESERVED) <= tatt.SMEM_PER_SM


def test_kernel_takes_wide_heads():
    bf, h16, f32 = torch.bfloat16, torch.float16, torch.float32
    for D in (256, 512, 768, 5376, 8192):
        assert tatt.kernel_takes("cuda", 256, D, bf)
        assert tatt.kernel_takes("cuda", 256, D, h16)
    # past 8192 q and the ring no longer fit a 16-bit block
    assert not tatt.kernel_takes("cuda", 256, 8448, bf)
    assert tatt.kernel_takes("cuda", 256, 5120, f32)
    assert not tatt.kernel_takes("cuda", 256, 5376, f32)
    assert not tatt.kernel_takes("cpu", 256, 512, bf)


MODES = ("causal", "tree-bias", "alibi", "append")


def _inputs(mode, seed, D=320, Dp=512):
    """numpy inputs of one case at head dim D: R 2 rows, GQA (4 query
    heads on 2 kv heads), 8 queries, S 512 (8 tiles: the wide plan cuts
    it in two splits)."""
    R, Q, H, KH, S = 2, 8, 4, 2, 512
    rng = np.random.RandomState(seed)
    c = dict(q=rng.randn(R, Q, H, D).astype(np.float32),
             k=rng.randn(R, KH, S, D).astype(np.float32),
             v=rng.randn(R, KH, S, D).astype(np.float32),
             lengths=np.array([S - 40, 301], np.int32), bias=None,
             alibi=None, causal=True, append=None)
    c["qpos"] = (c["lengths"][:, None] - Q
                 + np.arange(Q, dtype=np.int32)[None]).astype(np.int32)
    if mode == "tree-bias":
        bias = np.where(rng.rand(R, Q, S) < 0.4, jatt.NEG_INF, 0.0)
        bias[:, :, 0] = 0.0           # at least one visible key per row
        c.update(bias=bias.astype(np.float32), causal=False)
    elif mode == "alibi":
        c["alibi"] = (rng.rand(H) * 0.2).astype(np.float32)
    elif mode == "append":
        # K2: the new row at each row's last position (row 1 in the first
        # split, row 0 in the second)
        c["append"] = (rng.randn(R, 1, KH, D).astype(np.float32),
                       rng.randn(R, 1, KH, D).astype(np.float32),
                       c["lengths"] - 1)
    return c


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("mode", MODES)
def test_wide_plain_versions_on_a_padded_cache_match_jax(mode):
    D, Dp = 320, tatt.padded_head_dim(320)
    assert Dp == 512
    c = _inputs(mode, seed=MODES.index(mode) + 31)
    R, Q, H, _ = c["q"].shape
    KH, S = c["k"].shape[1], c["k"].shape[2]
    k, v = c["k"], c["v"]
    tk, tv = pad_head_dim(_t(k), Dp), pad_head_dim(_t(v), Dp)
    if c["append"] is not None:
        kn, vn, appos = c["append"]
        k, v = k.copy(), v.copy()
        for r, p in enumerate(appos):
            k[r, :, p], v[r, :, p] = kn[r, 0], vn[r, 0]
        tatt.append_at(tk, tv, pad_head_dim(_t(kn), Dp),
                       pad_head_dim(_t(vn), Dp), _t(appos))
        # the padded cache after the append: the plain append, zeros past D
        np.testing.assert_array_equal(tk[..., :D].numpy(), k)
        assert not tk[..., D:].any() and not tv[..., D:].any()

    def j(a):
        return None if a is None else jnp.asarray(a)

    scale = 1.0 / np.sqrt(D)
    jref = np.asarray(jatt.reference_attend(
        j(c["q"]), j(k), j(v), j(c["lengths"]), j(c["qpos"]),
        bias=j(c["bias"]), alibi=j(c["alibi"]), causal=c["causal"],
        qk_scale=scale))
    plan = tatt.wide_split_plan(R, KH, S, Dp, H100_SMS)
    assert plan == (2, 4)
    kw = dict(bias=_t(c["bias"]), alibi=_t(c["alibi"]), causal=c["causal"],
              qk_scale=scale)
    args = (pad_head_dim(_t(c["q"]), Dp), tk, tv, _t(c["lengths"]),
            _t(c["qpos"]))
    outs = [tatt.reference_attend(*args, **kw),
            tatt.split_attend(*args, plan=plan, **kw),
            tatt.split_attend(*args, plan=(1, 8), **kw)]
    for out in outs:
        assert out.dtype == torch.float32 and out.shape == (R, Q, H * Dp)
        out = out.reshape(R, Q, H, Dp)
        # the padded columns of the output are zeros
        assert not out[..., D:].any()
        np.testing.assert_allclose(out[..., :D].reshape(R, Q, H * D).numpy(),
                                   jref, atol=TOL, rtol=TOL)
