"""Port attention vs the JAX package, on the CPU.

The same numpy inputs go through the port's ``flash_attend`` (on CPU
tensors: its plain PyTorch version) and ``reference_attend``, and through
the JAX package's ``flash_attend`` (the Pallas kernel in interpret mode)
and ``reference_attend``. Outputs are compared on active rows only
(``lengths > 0``): a length-0 row has no defined average. Tolerances
(atol = rtol): fp32 2e-5, bf16 2e-2. The hand-written CUDA kernels run
only on a card; their test skips here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flexflow_tpu.kernels import attention as jatt
from flexflow_tpu_torch import kernels as tk
from flexflow_tpu_torch.kernels import attention as tatt

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(name):
    """numpy inputs of one flash_attend case (the cases of
    tests/test_pallas_kernels.py)."""
    rng = np.random.RandomState(CASES.index(name))
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
    # the S-tile is one constant, whatever the query width
    assert tatt.BLOCK_S == 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_cuda_kernels_match_plain_version(cuda_device):
    """On a card: K1 and K2 against their plain versions (chip_smoke.py
    phase 3 runs the full set of cases)."""
    c = _case("append-stacked")
    dev = cuda_device

    def t(a):
        return torch.tensor(a, device=dev)

    q, k, v = t(c["q"]), t(c["k"]), t(c["v"])
    lengths, qpos = t(c["lengths"]), t(c["qpos"])
    k1 = tatt.flash_attend(q, k, v, lengths, qpos, layer_idx=0)
    ref1 = tatt.reference_attend(q, k[0], v[0], lengths, qpos)
    kn, vn, appos = (t(a) for a in c["append"])
    k_ref, v_ref = k.clone(), v.clone()
    out, k_out, v_out = tatt.flash_attend(q, k, v, lengths, qpos,
                                          append_kv=(kn, vn, appos),
                                          layer_idx=1)
    tatt.append_at(k_ref, v_ref, kn, vn, appos, layer_idx=1)
    ref2 = tatt.reference_attend(q, k_ref[1], v_ref[1], lengths, qpos)
    torch.cuda.synchronize()
    torch.testing.assert_close(k1, ref1, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(out, ref2, atol=2e-5, rtol=2e-5)
    assert torch.equal(k_out, k_ref) and torch.equal(v_out, v_ref)
