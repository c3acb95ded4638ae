"""Port attention vs the JAX package, on the CPU.

The same numpy inputs go through the port's ``flash_attend`` (on CPU
tensors: its plain PyTorch version) and ``reference_attend``, and through
the JAX package's ``flash_attend`` (the Pallas kernel in interpret mode)
and ``reference_attend``. Outputs are compared on active rows only
(``lengths > 0``): a length-0 row has no defined average. Tolerances
(atol = rtol): fp32 2e-5, bf16 2e-2. The hand-written CUDA kernels run
only on a card; their test skips here.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flexflow_tpu.kernels import attention as jatt
from flexflow_tpu_torch import kernels as tk
from flexflow_tpu_torch.kernels import attention as tatt

TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _case(name):
    """numpy inputs of one flash_attend case (the cases of
    tests/test_pallas_kernels.py)."""
    rng = np.random.RandomState(
        (CASES + SPLIT_CASES + FP32_GQ_CASES + WIDE_CASES).index(name))
    c = dict(dtype="float32", causal=True, bias=None, alibi=None,
             append=None, layer_idx=None)

    def qkv(R, Q, H, KH, D, S, L=None):
        lead = () if L is None else (L,)
        c.update(q=rng.randn(R, Q, H, D).astype(np.float32),
                 k=rng.randn(*lead, R, KH, S, D).astype(np.float32),
                 v=rng.randn(*lead, R, KH, S, D).astype(np.float32))

    if name.startswith("decode"):
        qkv(4, 1, 8, 4, 128, 256)
        c["lengths"] = np.array([37, 1, 256, 0], np.int32)
        c["qpos"] = (c["lengths"] - 1).clip(0)[:, None]
        c["dtype"] = name.split("-")[1]
    elif name == "prefill-causal":
        qkv(3, 32, 8, 8, 64, 256)
        c["lengths"] = np.array([32, 7, 20], np.int32)
        c["qpos"] = np.tile(np.arange(32, dtype=np.int32)[None], (3, 1))
    elif name == "tree-bias-alibi":
        qkv(2, 16, 8, 4, 128, 256)
        c["lengths"] = np.array([100, 60], np.int32)
        c["qpos"] = np.array([[i + 40 for i in range(16)],
                              [i + 20 for i in range(16)]], np.int32)
        bias = np.where(rng.rand(2, 16, 256) < 0.4, jatt.NEG_INF, 0.0)
        bias[:, :, 0] = 0.0           # at least one visible key per row
        c.update(bias=bias.astype(np.float32), causal=False,
                 alibi=(rng.rand(8) * 0.2).astype(np.float32))
    elif name == "gqa":
        qkv(2, 4, 16, 2, 128, 128)
        c["lengths"] = np.array([128, 50], np.int32)
        c["qpos"] = np.array([[124 + i for i in range(4)],
                              [46 + i for i in range(4)]], np.int32)
    elif name == "lengths-clamped":
        qkv(2, 1, 4, 4, 64, 256)
        c["lengths"] = np.array([256 + 64, 256], np.int32)
        c["qpos"] = np.array([[255], [255]], np.int32)
    elif name == "d64-decode-bf16":
        qkv(4, 1, 8, 4, 64, 512)
        c["lengths"] = np.array([300, 5, 512, 257], np.int32)
        c["qpos"] = (c["lengths"] - 1)[:, None]
        c["dtype"] = "bfloat16"
    elif name.startswith("split"):
        # R * KH = 4 streams over S = 512: split_plan cuts 2 splits of 256
        qkv(2, 8, 4, 2, 128, 512)
        lengths = {"split-lengths-zero": [0, 200],
                   "split-at-boundary": [256, 512],
                   "split-over-S": [600, 257],
                   "split-append-later": [301, 11]}[name]
        c["lengths"] = np.array(lengths, np.int32)
        last = np.minimum(c["lengths"], 512).clip(1) - 1
        c["qpos"] = last[:, None] + np.arange(8, dtype=np.int32)[None]
        if name == "split-append-later":  # appos 300 lies in split 1 of 2
            appos = c["lengths"] - 1
            c["append"] = (rng.randn(2, 1, 2, 128).astype(np.float32),
                           rng.randn(2, 1, 2, 128).astype(np.float32), appos)
            c["dtype"] = "bfloat16"
    elif name.startswith("fp32-gq"):
        # the fp32 kernel's query tiles: K1 and K2 at G*Q = 1 .. 568, the
        # new row appended at each row's last position
        H, KH, Q = _GQ_SHAPES[int(name[len("fp32-gq"):])]
        D = 64 if H * Q // KH >= 64 else 128
        qkv(2, Q, H, KH, D, 256)
        c["lengths"] = np.array([200, 37], np.int32)
        c["qpos"] = (c["lengths"][:, None] - Q
                     + np.arange(Q, dtype=np.int32)[None]).clip(0)
        c["append"] = (rng.randn(2, 1, KH, D).astype(np.float32),
                       rng.randn(2, 1, KH, D).astype(np.float32),
                       c["lengths"] - 1)
    elif name.startswith("wide"):
        # the 16-bit wide kernel: K1 and K2 at head dim D, GQA, S 512 (its
        # plan cuts two splits), the new row at each row's last position
        _, d, dt = name.split("-")
        D = int(d[1:])
        qkv(2, 8, 4, 2, D, 512)
        c["lengths"] = np.array([420, 97], np.int32)
        c["qpos"] = c["lengths"][:, None] - 8 + np.arange(
            8, dtype=np.int32)[None]
        c["append"] = (rng.randn(2, 1, 2, D).astype(np.float32),
                       rng.randn(2, 1, 2, D).astype(np.float32),
                       c["lengths"] - 1)
        c["dtype"] = dt
    elif name.startswith("append"):
        stacked = name == "append-stacked"
        R, KH = (2, 4) if stacked else (4, 4)
        qkv(R, 8, 4 if stacked else 8, KH, 128, 256, L=3 if stacked else None)
        appos = (np.array([10, 130], np.int32) if stacked
                 else np.array([37, 0, 255, -1], np.int32))   # -1 = skip row
        c["append"] = (rng.randn(R, 1, KH, 128).astype(np.float32),
                       rng.randn(R, 1, KH, 128).astype(np.float32), appos)
        c["lengths"] = np.where(appos >= 0, appos + 1, 0).astype(np.int32)
        c["qpos"] = (appos.clip(0)[:, None]
                     + np.arange(8, dtype=np.int32)[None])
        c["layer_idx"] = 1 if stacked else None
    else:
        raise KeyError(name)
    return c


CASES = ["decode-float32", "decode-bfloat16", "prefill-causal",
         "tree-bias-alibi", "gqa", "lengths-clamped", "d64-decode-bf16",
         "append-per-layer", "append-stacked"]
# split-S cases: lengths 0, exactly at the split boundary, past S, and the
# appended row in the second split
SPLIT_CASES = ["split-lengths-zero", "split-at-boundary", "split-over-S",
               "split-append-later"]
MANY_SMS = 132   # an H100's SM count: R * KH = 4 streams leave it idle
# G*Q -> (query heads, kv heads, query width) where the fp32 kernel's query
# tiles cut (tests/test_torch_fp32_attention.py holds the plain side)
_GQ_SHAPES = {1: (4, 4, 1), 8: (8, 8, 8), 16: (8, 4, 8), 17: (17, 1, 1),
              64: (8, 8, 64), 65: (13, 1, 5), 568: (71, 1, 8)}
FP32_GQ_CASES = [f"fp32-gq{gq}" for gq in sorted(_GQ_SHAPES)]
# the 16-bit wide kernel at head dims 256, 512 and 768
WIDE_CASES = [f"wide-d{D}-{dt}" for D in (256, 512, 768)
              for dt in ("bfloat16", "float16")]


def _appended(cache, append, layer_idx, which):
    """numpy cache after the plain append (rows with appos < 0 skipped)."""
    out = cache.copy()
    lay = out if layer_idx is None else out[layer_idx]
    for r, p in enumerate(append[2]):
        if p >= 0:
            lay[r, :, p] = append[which][r, 0]
    return out


@pytest.mark.parametrize("name", CASES)
def test_flash_attend_matches_jax(name):
    c = _case(name)
    dt = c["dtype"]
    tol = TOL[dt]
    act = c["lengths"] > 0

    def j(a, f=True):
        return None if a is None else jnp.asarray(a, _JNP[dt] if f else None)

    def t(a, f=True):
        return None if a is None else (
            torch.tensor(a).to(_TORCH[dt]) if f else torch.tensor(a))

    kw = dict(causal=c["causal"], layer_idx=c["layer_idx"])
    # --- JAX: the Pallas kernel (interpret mode) and the jnp oracle ---
    jap = None if c["append"] is None else (
        j(c["append"][0]), j(c["append"][1]), j(c["append"][2], False))
    jres = jatt.flash_attend(j(c["q"]), j(c["k"]), j(c["v"]),
                             j(c["lengths"], False), j(c["qpos"], False),
                             bias=j(c["bias"], False),
                             alibi=j(c["alibi"], False), append_kv=jap,
                             interpret=True, **kw)
    jout = jres if jap is None else jres[0]
    kc, vc = c["k"], c["v"]
    if c["append"] is not None:
        kc = _appended(kc, c["append"], c["layer_idx"], 0)
        vc = _appended(vc, c["append"], c["layer_idx"], 1)
    kl = kc if c["layer_idx"] is None else kc[c["layer_idx"]]
    vl = vc if c["layer_idx"] is None else vc[c["layer_idx"]]
    jlen = np.minimum(c["lengths"], kl.shape[-2])
    jref = jatt.reference_attend(j(c["q"]), j(kl), j(vl), j(jlen, False),
                                 j(c["qpos"], False),
                                 bias=j(c["bias"], False),
                                 alibi=j(c["alibi"], False),
                                 causal=c["causal"])

    # --- port: flash_attend on CPU tensors (the plain path) + oracle ---
    tk.reset_counts()
    tkc, tvc = t(c["k"]), t(c["v"])
    tap = None if c["append"] is None else (
        t(c["append"][0]), t(c["append"][1]), t(c["append"][2], False))
    tres = tatt.flash_attend(t(c["q"]), tkc, tvc, t(c["lengths"], False),
                             t(c["qpos"], False), bias=t(c["bias"], False),
                             alibi=t(c["alibi"], False), append_kv=tap, **kw)
    tout = tres if tap is None else tres[0]
    tref = tatt.reference_attend(t(c["q"]), t(kl), t(vl),
                                 t(jlen, False), t(c["qpos"], False),
                                 bias=t(c["bias"], False),
                                 alibi=t(c["alibi"], False),
                                 causal=c["causal"])
    # CPU tensors never launch a kernel and never count as plain-on-CUDA
    assert tk.counts == {k: 0 for k in tk.counts}

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32)) if not \
            torch.is_tensor(a) else a.float().numpy()

    for port, ref in ((tout, jout), (tout, jref), (tref, jref)):
        np.testing.assert_allclose(f32(port)[act], f32(ref)[act], atol=tol,
                                   rtol=tol)
    if tap is not None:
        # in place: the passed caches are the returned ones, and hold
        # exactly the plain append's result (and the JAX kernel's)
        assert tres[1] is tkc and tres[2] is tvc
        np.testing.assert_array_equal(f32(tkc), f32(j(kc)))
        np.testing.assert_array_equal(f32(tvc), f32(j(vc)))
        np.testing.assert_array_equal(f32(jres[1]), f32(j(kc)))


def test_supports_shapes_and_block_size_fixed():
    assert tatt.supports_shapes(256, 128) and tatt.supports_shapes(200, 64)
    assert not tatt.supports_shapes(256, 96)
    # past 256: the wide kernels take multiples of 256
    assert tatt.supports_shapes(256, 512) and tatt.supports_shapes(64, 768)
    assert not tatt.supports_shapes(256, 320)
    assert [tatt.padded_head_dim(d) for d in (32, 80, 160, 256, 257, 320,
                                               512, 600)] == [
        64, 128, 256, 256, 512, 512, 512, 768]
    # the S-tile is one constant, whatever the query width
    assert tatt.BLOCK_S == 64


def test_split_plan_depends_on_shapes_only():
    # its inputs are the shapes and the SM count: no query width, no lengths
    assert list(inspect.signature(tatt.split_plan).parameters) == [
        "R", "KH", "S", "sms"]
    # the slice's shapes: 8 rows x 32 kv heads fill 132 SMs, one split
    assert tatt.split_plan(8, 32, 256, 132) == (1, 4)
    assert tatt.split_plan(8, 32, 4096, 132) == (1, 64)
    # one row of LLaMA-2-7B over a 4096-position cache: 8 splits of 8 tiles
    assert tatt.split_plan(1, 32, 4096, 132) == (8, 8)
    for R, KH, S in ((1, 1, 64), (2, 2, 512), (1, 8, 32768), (3, 4, 200)):
        n, tps = tatt.split_plan(R, KH, S, 132)
        tiles = -(-S // tatt.BLOCK_S)
        assert (n - 1) * tps < tiles <= n * tps   # whole tiles, no empty split
        assert n == 1 or tps >= tatt.SPLIT_MIN_TILES


def _np32(a):
    return (a.float().numpy() if torch.is_tensor(a)
            else np.asarray(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_attend_matches_jax(name):
    """The plain split-S arithmetic (64-position tiles, a partial (m, l, O)
    per split, combined in order) against the JAX package's Pallas kernel
    (interpret mode) and its oracle."""
    c = _case(name)
    dt = c["dtype"]
    tol = TOL[dt]
    act = c["lengths"] > 0
    plan = tatt.split_plan(2, 2, 512, MANY_SMS)
    assert plan == (2, 4)

    def j(a, f=True):
        return None if a is None else jnp.asarray(a, _JNP[dt] if f else None)

    def t(a, f=True):
        return torch.tensor(a).to(_TORCH[dt]) if f else torch.tensor(a)

    jap = None if c["append"] is None else (
        j(c["append"][0]), j(c["append"][1]), j(c["append"][2], False))
    jres = jatt.flash_attend(j(c["q"]), j(c["k"]), j(c["v"]),
                             j(c["lengths"], False), j(c["qpos"], False),
                             append_kv=jap, interpret=True)
    jout = jres if jap is None else jres[0]
    kc, vc = c["k"], c["v"]
    tkc, tvc = t(kc), t(vc)
    if c["append"] is not None:
        kc = _appended(kc, c["append"], None, 0)
        vc = _appended(vc, c["append"], None, 1)
        tatt.append_at(tkc, tvc, t(c["append"][0]), t(c["append"][1]),
                       t(c["append"][2], False))
    jlen = np.minimum(c["lengths"], 512)
    jref = jatt.reference_attend(j(c["q"]), j(kc), j(vc), j(jlen, False),
                                 j(c["qpos"], False))
    args = (t(c["q"]), tkc, tvc, t(c["lengths"], False), t(c["qpos"], False))
    tout = tatt.split_attend(*args, plan=plan)
    for ref in (jout, jref):
        np.testing.assert_allclose(_np32(tout)[act], _np32(ref)[act],
                                   atol=tol, rtol=tol)
    assert (_np32(tout)[~act] == 0).all()     # length-0 rows: zeros
    # one split of every tile: the same function
    one = tatt.split_attend(*args, plan=(1, 8))
    np.testing.assert_allclose(_np32(one)[act], _np32(tout)[act], atol=tol,
                               rtol=tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["append-stacked", "split-append-later"]
                         + FP32_GQ_CASES + WIDE_CASES)
def test_cuda_kernels_match_plain_version(cuda_device, name):
    """On a card: K1 and K2 against their plain versions, on the stacked
    cache, with split-S, on fp32 caches at the G*Q values where the fp32
    kernel's query tiles cut, and through the 16-bit wide kernel at head
    dims 256, 512 and 768 in bf16 and fp16 (chip_smoke.py phase 3 runs the
    full set)."""
    c = _case(name)
    dev = cuda_device
    dt = _TORCH[c["dtype"]]
    tol = TOL[c["dtype"]]
    if name.startswith("split"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert tatt.split_plan(2, 2, 512, sms)[0] > 1

    def t(a, f=True):
        return torch.tensor(a, device=dev).to(dt) if f else torch.tensor(
            a, device=dev)

    li = c["layer_idx"]
    l0 = None if li is None else 0

    def lay(x, i):
        return x if i is None else x[i]

    q, k, v = t(c["q"]), t(c["k"]), t(c["v"])
    lengths, qpos = t(c["lengths"], False), t(c["qpos"], False)
    k1 = tatt.flash_attend(q, k, v, lengths, qpos, layer_idx=l0)
    ref1 = tatt.reference_attend(q, lay(k, l0), lay(v, l0), lengths, qpos)
    kn, vn = t(c["append"][0]), t(c["append"][1])
    appos = t(c["append"][2], False)
    k_ref, v_ref = k.clone(), v.clone()
    out, k_out, v_out = tatt.flash_attend(q, k, v, lengths, qpos,
                                          append_kv=(kn, vn, appos),
                                          layer_idx=li)
    tatt.append_at(k_ref, v_ref, kn, vn, appos, layer_idx=li)
    ref2 = tatt.reference_attend(q, lay(k_ref, li), lay(v_ref, li), lengths,
                                 qpos)
    torch.cuda.synchronize()
    torch.testing.assert_close(k1, ref1, atol=tol, rtol=tol)
    torch.testing.assert_close(out, ref2, atol=tol, rtol=tol)
    assert torch.equal(k_out, k_ref) and torch.equal(v_out, v_ref)
