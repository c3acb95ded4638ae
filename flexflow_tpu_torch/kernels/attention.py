"""KV-cache serving attention: the two Hopper kernels and their plain
PyTorch versions.

Counterpart of ``flexflow_tpu/kernels/attention.py``, whose ``flash_attend``
reaches two Pallas TPU kernels; ``csrc/flash_attend.cu`` replaces both:

* K1 ``flash_attend`` without ``append_kv`` (TPU ``_kernel``): batched
  attention over the cache with an fp32 online softmax — prefill (causal
  on absolute ``qpos``) and tree verify (``causal=False`` + additive
  ``bias``), optional ALiBi, GQA/MQA.
* K2 ``flash_attend(..., append_kv=(k_new, v_new, appos))`` (TPU
  ``_append_kernel``): the decode step — each row's new K/V lands at cache
  position ``appos[r]`` in place (``appos < 0`` skips the row), then the
  row attends over the updated cache.

On CUDA tensors ``flash_attend`` launches the kernel (or raises on a shape
it does not take); on CPU tensors it runs the plain versions below. The
cache stream is cut into ``BLOCK_S``-position tiles whatever the query
width, so a width-1 and a width-8 decode split the softmax identically.

Split-S: where ``R * KH`` blocks would leave SMs idle, ``split_plan`` cuts
the S tiles into splits; each split's partial softmax state is combined
by a second small launch in a fixed order. The plan depends on (R, KH, S,
SM count) only, never on the query width or on ``lengths`` (no host
read). ``split_attend`` is its plain version, for tests and the chip
smoke test.

Partials: ``flash_attend_partials`` launches K1 or K2 with no output and
returns each split's fp32 partial softmax state (unnormalised O and its
row max and sum), for a caller that combines them with partials computed
elsewhere: a sequence-parallel rank holds only some cache rows
(``parallel/ring_attention.seq_sharded_attend``). ``partials_reference``
is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30  # finite "minus infinity": keeps the online softmax NaN-free
BLOCK_S = 64     # cache positions per kernel tile (csrc/flash_attend.cu BS)
SPLIT_MIN_TILES = 4  # a split streams at least this many tiles
SUPPORTED_HEAD_DIMS = (64, 128, 256)
# the wide kernels take 256 and any multiple of it (csrc/flash_attend.cu
# DC: one block per WIDE_HEAD_DIM-column slice of the output)
WIDE_HEAD_DIM = 256
# cache and output dtypes the kernels take, as csrc/flash_attend.cu's codes
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supports_shapes(S: int, D: int) -> bool:
    """Can the CUDA kernels serve a cache of length S and head dim D?"""
    return S > 0 and (D in SUPPORTED_HEAD_DIMS
                      or (D > WIDE_HEAD_DIM and D % WIDE_HEAD_DIM == 0))


def padded_head_dim(D: int) -> int:
    """The cache head dim that serves head dim D on the card: D rounded up
    to the next kernel head dim (64, 128 or 256, then multiples of 256),
    the counterpart of ``flexflow_tpu/ops/inc_attention.py:312
    padded_head_dim``."""
    if D > WIDE_HEAD_DIM:
        return -(-D // WIDE_HEAD_DIM) * WIDE_HEAD_DIM
    return next(d for d in SUPPORTED_HEAD_DIMS if d >= D)


def kernel_takes(device, S: int, D: int, dtype) -> bool:
    """Does a kernel launch serve a cache of S positions, head dim D (the
    cache's own, padded or not) and ``dtype`` on ``device``? The one
    predicate behind ``_launch``'s checks and ``kernel_serves``."""
    return (torch.device(device).type == "cuda" and dtype in _KERNEL_DTYPES
            and supports_shapes(S, D))


@functools.lru_cache(maxsize=None)
def split_plan(R: int, KH: int, S: int, sms: int):
    """(n_split, tiles_per_split) for a cache of S positions served by
    R * KH (row, kv head) streams on ``sms`` SMs. One split when the
    streams alone fill the SMs; else enough splits, of whole 64-position
    tiles and at least ``SPLIT_MIN_TILES`` each, for two blocks an SM."""
    tiles = -(-S // BLOCK_S)
    streams = R * KH
    if streams >= sms:
        return 1, tiles
    want = -(-2 * sms // streams)
    tps = max(-(-tiles // want), SPLIT_MIN_TILES)
    return -(-tiles // tps), tps


def _masked_scores(q, k_cache, lengths, qpos, bias, alibi, causal, qk_scale):
    """fp32 scores [R, KH, G, Q, S] of dt-rounded q and k, with ALiBi and
    bias added and NEG_INF where a key is not visible."""
    R, Q, H, D = q.shape
    KH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    # products of dt-rounded operands, accumulated in fp32
    qg = q.reshape(R, Q, KH, G, D).float()
    kc = k_cache.to(q.dtype).float()
    s = torch.einsum("rqkgd,rksd->rkgqs", qg, kc) * qk_scale
    s_ids = torch.arange(S, device=q.device)[None, None, :]        # [1,1,S]
    if alibi is not None:
        dist = (qpos[:, :, None] - s_ids).float()                  # [R,Q,S]
        slopes = alibi.float().reshape(KH, G)
        s = s - slopes[None, :, :, None, None] * dist[:, None, None, :, :]
    if bias is not None:
        s = s + bias.float()[:, None, None, :, :]
    if causal:
        visible = s_ids <= qpos[:, :, None]
    else:
        visible = torch.ones((R, Q, S), dtype=torch.bool, device=q.device)
    visible = visible & (s_ids < lengths[:, None, None])
    return torch.where(visible[:, None, None, :, :], s,
                       torch.tensor(NEG_INF, device=q.device))


def reference_attend(q, k_cache, v_cache, lengths, qpos, bias=None,
                     alibi=None, *, causal=True, qk_scale=None,
                     out_dtype=None):
    """Plain PyTorch attention with the JAX ``reference_attend`` semantics.

    q [R, Q, H, D]; k/v [R, KH, S, D]; lengths [R]; qpos [R, Q];
    bias [R, Q, S]; alibi [H]. Returns [R, Q, H*D] in ``out_dtype``. Rows
    with ``lengths == 0`` see only masked keys and return a meaningless
    average (the kernels write zeros there): compare active rows only."""
    from flexflow_tpu_torch import kernels

    if q.is_cuda:
        kernels.counts["plain_attend_cuda"] += 1
    R, Q, H, D = q.shape
    if qk_scale is None:
        qk_scale = 1.0 / math.sqrt(D)
    out_dtype = out_dtype or q.dtype
    dt = q.dtype
    s = _masked_scores(q, k_cache, lengths, qpos, bias, alibi, causal,
                       qk_scale)
    p = torch.softmax(s, dim=-1)
    vc = v_cache.to(dt).float()
    out = torch.einsum("rkgqs,rksd->rqkgd", p.to(dt).float(), vc).to(dt)
    return out.reshape(R, Q, H * D).to(out_dtype)


def split_attend(q, k_cache, v_cache, lengths, qpos, bias=None, alibi=None,
                 *, plan, causal=True, qk_scale=None, out_dtype=None):
    """Plain version of the kernels' split-S arithmetic: each split of
    ``plan = (n_split, tiles_per_split)`` runs an online softmax over its
    ``BLOCK_S``-position tiles below ``ceil(min(len, S) / BLOCK_S)`` and
    keeps (m, l, unnormalised O); the splits are combined in order,
    out = sum w_s O_s / sum w_s l_s with w_s = exp(m_s - max m). Rows with
    ``lengths == 0`` give zeros, as the kernels do. Same arguments and
    result as ``reference_attend``; used by tests and ``chip_smoke.py``."""
    R, Q, H, D = q.shape
    KH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    if qk_scale is None:
        qk_scale = 1.0 / math.sqrt(D)
    out_dtype = out_dtype or q.dtype
    dt = q.dtype
    n_split, tps = plan
    s = _masked_scores(q, k_cache, lengths, qpos, bias, alibi, causal,
                       qk_scale)
    vc = v_cache.to(dt).float()
    nb = (lengths.clamp(0, S).long() + BLOCK_S - 1) // BLOCK_S      # [R]
    stat = (R, KH, G, Q)
    ms, ls, os_ = [], [], []
    for sp in range(n_split):
        m = torch.full(stat, NEG_INF, device=q.device)
        l = torch.zeros(stat, device=q.device)
        o = torch.zeros(stat + (D,), device=q.device)
        for t in range(sp * tps, min((sp + 1) * tps, -(-S // BLOCK_S))):
            live = (t < nb)[:, None, None, None]                      # [R,1,1,1]
            x = s[..., t * BLOCK_S:(t + 1) * BLOCK_S]
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp(x - m_new[..., None])
            corr = torch.exp(m - m_new)
            pv = torch.einsum("rkgqs,rksd->rkgqd", p.to(dt).float(),
                              vc[:, :, t * BLOCK_S:(t + 1) * BLOCK_S])
            l = torch.where(live, l * corr + p.sum(-1), l)
            o = torch.where(live[..., None], o * corr[..., None] + pv, o)
            m = torch.where(live, m_new, m)
        ms.append(m)
        ls.append(l)
        os_.append(o)
    mx = torch.stack(ms).amax(0)
    o = torch.zeros_like(os_[0])
    l = torch.zeros_like(ls[0])
    for m_s, l_s, o_s in zip(ms, ls, os_):
        w = torch.exp(m_s - mx)
        l = l + w * l_s
        o = o + w[..., None] * o_s
    out = (o / l.clamp(min=1e-30)[..., None]).to(dt)              # [R,KH,G,Q,D]
    out = out.permute(0, 3, 1, 2, 4).reshape(R, Q, H * D)
    return out.to(out_dtype)


def partials_reference(q, k_cache, v_cache, lengths, qpos, bias=None,
                       alibi=None, *, causal=True, qk_scale=None):
    """Plain version of the kernels' partials: (part_o [1, R, Q, H, D],
    part_ml [1, R, Q, H, 2]) in fp32, one split's unnormalised O = P.V and
    its row max m and sum l over the keys each row sees, with P rounded to
    q's dtype before its product (as ``reference_attend``). A row that
    sees no key gives m = NEG_INF, l = 0 and O = 0, where the kernel's l
    counts the masked keys it streamed; such a row weighs nothing in a
    combine where some split sees a key."""
    from flexflow_tpu_torch import kernels

    if q.is_cuda:
        kernels.counts["plain_attend_cuda"] += 1
    R, Q, H, D = q.shape
    if qk_scale is None:
        qk_scale = 1.0 / math.sqrt(D)
    dt = q.dtype
    s = _masked_scores(q, k_cache, lengths, qpos, bias, alibi, causal,
                       qk_scale)                                 # [R,KH,G,Q,S]
    m = s.amax(-1)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    o = torch.einsum("rkgqs,rksd->rqkgd", p.to(dt).float(),
                     v_cache.to(dt).float()).reshape(R, Q, H, D)
    ml = torch.stack([m, p.sum(-1)], -1).permute(0, 3, 1, 2, 4)  # [R,Q,KH,G,2]
    return o[None], ml.reshape(R, Q, H, 2)[None]


def combine_partials(part_o, part_ml, dtype, out_dtype=None, reduce_max=None,
                     reduce_sum=None):
    """out [R, Q, H*D] from partials [n, R, Q, H, D] / [n, R, Q, H, 2]:
    sum_s w_s O_s / sum_s w_s l_s with w_s = exp(m_s - max m), rounded to
    ``dtype`` (the kernels' combine rounds to the cache type) and then to
    ``out_dtype``. ``reduce_max``/``reduce_sum``, when given, take the
    max and the two sums across the holders of other partials too (the
    collectives of ``parallel/ring_attention.seq_sharded_attend``)."""
    n, R, Q, H, D = part_o.shape
    m, l = part_ml[..., 0], part_ml[..., 1]
    mx = m.amax(0)
    if reduce_max is not None:
        mx = reduce_max(mx)
    w = torch.exp(m - mx)
    den = (w * l).sum(0)
    num = (w[..., None] * part_o).sum(0)
    if reduce_sum is not None:
        den, num = reduce_sum(den), reduce_sum(num)
    out = (num / den.clamp(min=1e-30)[..., None]).to(dtype)
    return out.reshape(R, Q, H * D).to(out_dtype or dtype)


def flash_attend_partials(q, k_cache, v_cache, lengths, qpos, bias=None,
                          alibi=None, append_kv=None, *, causal=True,
                          qk_scale=None, layer_idx=None):
    """``flash_attend`` with no output: K1 (or K2 with ``append_kv``, its
    append done in place) writes every split's partial and no combine
    runs. Returns (part_o [n, R, Q, H, D], part_ml [n, R, Q, H, 2]) in
    fp32, for ``combine_partials``. On CPU tensors: ``append_at`` and
    ``partials_reference``."""
    if qk_scale is None:
        qk_scale = 1.0 / math.sqrt(q.shape[-1])
    from flexflow_tpu_torch.kernels import kernels_enabled

    if q.is_cuda and kernels_enabled():
        return _launch(q, k_cache, v_cache, lengths, qpos, bias, alibi,
                       append_kv, causal, float(qk_scale), None, layer_idx)
    if append_kv is not None:
        append_at(k_cache, v_cache, *append_kv, layer_idx=layer_idx)
    kc = k_cache if layer_idx is None else k_cache[layer_idx]
    vc = v_cache if layer_idx is None else v_cache[layer_idx]
    return partials_reference(q, kc, vc, lengths.clamp(max=kc.shape[-2]),
                              qpos, bias=bias, alibi=alibi, causal=causal,
                              qk_scale=qk_scale)


def append_at(k_cache, v_cache, k_new, v_new, appos, layer_idx=None):
    """Plain in-place append, K2's first half: write k_new/v_new
    [R, 1, KH, D] at cache position ``appos[r]`` of each row of
    [R, KH, S, D] (or of layer ``layer_idx`` of [L, R, KH, S, D]); rows
    with ``appos`` outside [0, S) are skipped."""
    kc = k_cache if layer_idx is None else k_cache[layer_idx]
    vc = v_cache if layer_idx is None else v_cache[layer_idx]
    S = kc.shape[-2]
    rows = ((appos >= 0) & (appos < S)).nonzero().flatten()
    cols = appos[rows].long()
    kc[rows, :, cols] = k_new[rows, 0].to(kc.dtype)
    vc[rows, :, cols] = v_new[rows, 0].to(vc.dtype)


def flash_attend(q, k_cache, v_cache, lengths, qpos, bias=None, alibi=None,
                 append_kv=None, *, causal=True, qk_scale=None,
                 out_dtype=None, layer_idx=None):
    """Batched KV-cache attention, with the JAX ``flash_attend`` signature.

    q        [R, Q, H, D]   new-token queries (rotary already applied)
    k/v      [R, KH, S, D]  the cache, or the stacked [L, R, KH, S, D]
                            buffer with ``layer_idx`` selecting the layer
    lengths  [R] int        valid cache extent per row (clamped to S;
                            0 => the row does no work and returns zeros)
    qpos     [R, Q] int     absolute position of each query token
    bias     [R, Q, S] f32  optional additive mask (tree mask)
    alibi    [H] f32        optional ALiBi slopes
    append_kv  (k_new [R, 1, KH, D], v_new same, appos [R] int): write each
               row's new K/V at appos[r] (appos < 0 = skip) IN PLACE
               before attending; returns (out, k_cache, v_cache), the
               caches being the same tensors that were passed in
    returns  [R, Q, H*D] in ``out_dtype`` (default q.dtype)
    """
    if qk_scale is None:
        qk_scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    from flexflow_tpu_torch.kernels import kernels_enabled

    if q.is_cuda and kernels_enabled():
        out = _launch(q, k_cache, v_cache, lengths, qpos, bias, alibi,
                      append_kv, causal, float(qk_scale), out_dtype,
                      layer_idx)
        return out if append_kv is None else (out, k_cache, v_cache)
    if append_kv is not None:
        append_at(k_cache, v_cache, *append_kv, layer_idx=layer_idx)
    kc = k_cache if layer_idx is None else k_cache[layer_idx]
    vc = v_cache if layer_idx is None else v_cache[layer_idx]
    out = reference_attend(q, kc, vc, lengths.clamp(max=kc.shape[-2]), qpos,
                           bias=bias, alibi=alibi, causal=causal,
                           qk_scale=qk_scale, out_dtype=out_dtype)
    return out if append_kv is None else (out, k_cache, v_cache)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _bind(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.ff_flash_attend, lib.ff_flash_attend_append):
        fn.argtypes = [vp] * 13 + [i] * 8 + [f, i, i, i, vp]
        fn.restype = i


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(q, k_cache, v_cache, lengths, qpos, bias, alibi, append_kv,
            causal, scale, out_dtype, layer_idx):
    """Check everything the kernel assumes, then launch K1 or K2 on the
    current stream. Raises on what the kernel does not take. With
    ``out_dtype`` None there is no output: returns the partials
    (``flash_attend_partials``)."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.kernels import build

    dev = q.device
    if layer_idx is not None:
        if k_cache.dim() != 5:
            raise ValueError("layer_idx needs the stacked [L, R, KH, S, D] cache")
        kc, vc = k_cache[int(layer_idx)], v_cache[int(layer_idx)]
    else:
        kc, vc = k_cache, v_cache
    if kc.dim() != 4 or kc.shape != vc.shape:
        raise ValueError(f"k/v caches must be [R, KH, S, D] alike, got "
                         f"{tuple(kc.shape)} / {tuple(vc.shape)}")
    R, KH, S, D = kc.shape
    if q.dim() != 4 or q.shape[0] != R or q.shape[-1] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(kc.shape)}")
    Q, H = q.shape[1], q.shape[2]
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    cdt = kc.dtype
    if not kernel_takes(dev, S, D, cdt) or vc.dtype != cdt:
        raise ValueError(
            f"flash_attend kernel takes a cache of head dim "
            f"{SUPPORTED_HEAD_DIMS} or a multiple of {WIDE_HEAD_DIM} past it "
            f"(pad another: padded_head_dim) in {list(_KERNEL_DTYPES)}, got "
            f"D={D} {cdt} / {vc.dtype}")
    partials = out_dtype is None
    if not partials and out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"out dtype {out_dtype} not in {list(_KERNEL_DTYPES)}")
    for name, t in (("k_cache", kc), ("v_cache", vc)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned on {dev}")

    def aligned(t):
        # the kernels read q, k_new and v_new in 16-byte (or 4-byte) words
        t = t.contiguous()
        return t.clone() if t.data_ptr() % 16 else t

    def small(t, dtype, shape, name):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        return aligned(t.to(dtype))

    qc = aligned(q.to(cdt))
    lens = small(lengths, torch.int32, (R,), "lengths")
    qp = small(qpos, torch.int32, (R, Q), "qpos")
    b = None if bias is None else small(bias, torch.float32, (R, Q, S), "bias")
    al = None if alibi is None else small(alibi, torch.float32, (H,), "alibi")
    kn = vn = ap = None
    if append_kv is not None:
        k_new, v_new, appos = append_kv
        kn = small(k_new, cdt, (R, 1, KH, D), "k_new")
        vn = small(v_new, cdt, (R, 1, KH, D), "v_new")
        ap = small(appos, torch.int32, (R,), "appos")
    out = (None if partials else
           torch.empty((R, Q, H * D), dtype=out_dtype, device=dev))
    n_split, tps = split_plan(R, KH, S, _sm_count(dev))
    part_o = part_ml = None
    if n_split > 1 or partials:
        # fp32 partials of each split: combined in the kernel call, or
        # returned
        part_o = torch.empty((n_split, R, Q, H, D), dtype=torch.float32,
                             device=dev)
        part_ml = torch.empty((n_split, R, Q, H, 2), dtype=torch.float32,
                              device=dev)

    lib = build.load("flash_attend")
    if not getattr(lib, "_ff_bound", False):
        _bind(lib)
        lib._ff_bound = True
    fn, key = ((lib.ff_flash_attend, "flash_attend") if append_kv is None
               else (lib.ff_flash_attend_append, "flash_attend_append"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_ptr(qc), _ptr(kc), _ptr(vc), _ptr(lens), _ptr(qp), _ptr(b),
            _ptr(al), _ptr(kn), _ptr(vn), _ptr(ap), _ptr(out), _ptr(part_o),
            _ptr(part_ml), R, Q, H, KH, S, D, n_split, tps, scale,
            int(bool(causal)),
            _KERNEL_DTYPES[cdt], _KERNEL_DTYPES[out_dtype or cdt],
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {rc}")
    kernels.counts[key] += 1
    if b is not None and append_kv is None:
        kernels.counts["flash_attend_bias"] += 1
    if partials:
        kernels.counts["flash_attend_partials"] += 1
    kernels.note_shape(key, (R, Q, H, KH, S, D, str(cdt)[6:],
                             "partials" if partials else str(out_dtype)[6:],
                             b is not None))
    return (part_o, part_ml) if partials else out
