"""The numerics of the bf16 paged verify (B4 in full mode, B5 in ring mode,
each also on int8 pools, B3) on the tensor cores, replayed on the CPU: a
tolerance argument for the kernel, not a test of it.

Since this slice a bf16 verify runs the decode kernel's template,
``paged_decode_tc`` in ``paged_attention.cu``, with K query tokens a
sequence: a kv head's K · groups query rows (row j · groups + g) fill the M
side of its 16-row mma tiles, query j sits at ``oldest + j`` (oldest =
newest - (K - 1); newest = lens - 1 in full mode, positions in ring mode),
and a key at absolute position kpos counts for row j iff kpos <= qpos_j
and, in ring mode, kpos > qpos_j - window. The kernel runs only on the card
(chip_smoke.py holds it against the plain version there, by max abs error
2e-2 and by each row's error over its rms, 1e-2). The arithmetic that sets
those tolerances is replayed here as in
``tests/test_torch_paged_decode_numerics.py``: f32 scores from bf16 q and
bf16 (or int8, exact in bf16) keys, times the key's scale and
scale·log2(e); 64-key stages of four 16-key warp slices, each with its own
f32 online softmax per row; a key masked for a row at p = 0; p times the
value's scale rounded to bf16 before P·V, l summed from the f32 p; the
warps merged at the end of a split, the splits merged by a second pass
that skips splits without a live key. As there, ``ex2.approx`` is an exact
exp2 here and the order of the sums over the head dim is not the
hardware's. The replay must stay within the smoke's tolerances of the
port's plain version and of the JAX function at gemma3-12b's (16/8 heads,
hd 256) and yi-9b's (32/4, hd 128) head layouts, k = 2, 4, 8, full and
ring mode (a wrapped ring, an inactive slot), bf16 and int8 pools.

The host side the CPU does run is tested as it is: the split choice with
n_q · groups rows, the workspace and shared-memory sizes, and the dispatch
of a verify by its query type."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import (
    paged_attention_verify_ref as jax_paged_attention_verify_ref)
from repro_torch import kernels
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_attention_verify_ref, ring_key_positions)
from repro_torch.kernels.quantize import quantize_kv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

SLICE = 16                 # keys per warp per stage (kDecSliceKeys)
WARPS = 4                  # key slices per stage (kDecWarps)
NEG_INF = -1e30            # the kernel's kNegInf
LOG2E = 1.4426950408889634
ABS_TOL = 2e-2             # the smoke's bf16 tolerance
ROW_TOL = 1e-2             # the smoke's DECODE_ROW_TOL
H100_SMS = 132

LAYOUTS = {"yi-9b": (32, 4, 128), "gemma3-12b": (16, 8, 256)}


def _ring_pages(window, bs, draft):
    """The ring the engine sizes for K drafts (state_providers.ring_pages)."""
    return -(-(window + draft) // bs) + 1


def emulate_verify(q, k_pool, v_pool, tables, lens, *, split_tokens,
                   window=None, positions=None, ring_pages=None,
                   k_scale=None, v_scale=None, drop=None):
    """The bf16 verify kernel's arithmetic on q (B, n_q, H, hd) bf16 and
    bf16 or int8 pools: returns out (B, n_q, H, hd) bf16. `drop` = (split,
    stage, warp) skips that warp slice in every split and kv head (a
    planted fault)."""
    B, n_q, H, hd = q.shape
    _, bs, Hkv, _ = k_pool.shape
    g = H // Hkv
    rows = n_q * g
    c = hd ** -0.5 * LOG2E
    ring = ring_pages is not None
    span = (ring_pages if ring else tables.shape[1]) * bs
    quant = k_scale is not None
    out = torch.zeros((B, n_q, H, hd))
    t = torch.arange(span)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        newest = int(positions[b]) if ring else n - 1
        qpos = newest - (n_q - 1) + torch.arange(rows) // g     # row j·g + gg
        if ring:
            kpos = ring_key_positions(positions[b:b + 1], ring_pages, bs)[0]
            ok_all = ((kpos >= 0)[None] & (kpos[None] <= qpos[:, None])
                      & (kpos[None] > qpos[:, None] - window))
        else:
            ok_all = (t < min(n, span))[None] & (t[None] <= qpos[:, None])
        slots = tables[b, t // bs].long() * bs + t % bs
        k = k_pool.reshape(-1, Hkv, hd)[slots].float().transpose(0, 1)
        v = v_pool.reshape(-1, Hkv, hd)[slots].float().transpose(0, 1)
        # (Hkv, rows, hd): row j·g + gg of kv head h is q[b, j, h·g + gg]
        qr = q[b].float().reshape(n_q, Hkv, g, hd).permute(1, 0, 2, 3)
        s_all = qr.reshape(Hkv, rows, hd) @ k.transpose(1, 2)
        if quant:
            ks = k_scale.reshape(-1, Hkv)[slots].T[:, None, :]
            vs = v_scale.reshape(-1, Hkv)[slots].T[:, None, :]
            s_all = s_all * (ks * c)
        else:
            vs = torch.ones((Hkv, 1, span))
            s_all = s_all * c
        t_stop_all = span if ring else min(n, span)
        parts = []                                        # (m, l, acc)
        for split, t0 in enumerate(range(0, span, split_tokens)):
            t_stop = min(t0 + split_tokens, t_stop_all)
            if t0 >= t_stop:
                continue
            m = torch.full((WARPS, Hkv, rows), NEG_INF)
            l = torch.zeros((WARPS, Hkv, rows))
            o = torch.zeros((WARPS, Hkv, rows, hd))
            for stage, s0 in enumerate(range(t0, t_stop, WARPS * SLICE)):
                for w in range(WARPS):
                    k0 = s0 + w * SLICE
                    if k0 >= t_stop or drop == (split, stage, w):
                        continue
                    idx = torch.arange(k0, k0 + SLICE).clamp(max=span - 1)
                    ok = ok_all[:, idx] & (torch.arange(k0, k0 + SLICE)
                                           < t_stop)[None]   # (rows, 16)
                    s = torch.where(ok, s_all[..., idx], NEG_INF)
                    m_new = torch.maximum(m[w], s.amax(-1))
                    corr = torch.exp2(m[w] - m_new)
                    p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
                    l[w] = l[w] * corr + p.sum(-1)
                    pv = (p * vs[..., idx]).to(torch.bfloat16).float()
                    o[w] = o[w] * corr[..., None] + pv @ v[:, idx]
                    m[w] = m_new
            m_all = m.amax(0)
            wgt = torch.exp2(m - m_all)
            parts.append((m_all, (l * wgt).sum(0),
                          (o * wgt[..., None]).sum(0)))
        # the merge pass: splits that saw no live key (l = 0) are skipped
        m_all = torch.stack([torch.where(pl > 0, pm, NEG_INF)
                             for pm, pl, _ in parts]).amax(0)
        l_all = torch.zeros((Hkv, rows))
        acc = torch.zeros((Hkv, rows, hd))
        for pm, pl, pa in parts:
            wgt = torch.where(pl > 0, torch.exp2(pm - m_all), 0.0)
            l_all = l_all + pl * wgt
            acc = acc + pa * wgt[..., None]
        res = acc / l_all.clamp(min=1e-30)[..., None]      # (Hkv, rows, hd)
        out[b] = res.reshape(Hkv, n_q, g, hd).permute(1, 0, 2, 3).reshape(
            n_q, H, hd)
    return out.to(torch.bfloat16)


def _row_error(out, ref):
    def rms(x):
        return x.pow(2).mean(-1).sqrt()
    diff = out.float() - ref.float()
    return (rms(diff) / rms(ref.float()).clamp_min(1e-30)).max().item()


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)


def _case(layout, mode, pool, n_q, seed=0):
    """Short tables: (args, kw) for the port's functions. Full mode: 4
    sequences of 24-page tables (block 16) with lengths K (the first query
    sees one key), one cutting a stage mid-way, the whole table and 0
    (inactive); ring mode: a window of 100 through the ring the engine
    sizes for K - 1 drafts, newest positions before, at and far past the
    first wrap, and an inactive slot (position -1, as the engine passes
    it)."""
    H, Hkv, hd = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    bs = 16
    if mode == "full":
        P, lens, kw = 24, [n_q, 201, 384, 0], {}
    else:
        window = 100
        R = _ring_pages(window, bs, n_q - 1)
        P, lens = R + 2, [37, R * bs, 5 * R * bs + 3, 0]
        kw = dict(window=window, ring_pages=R,
                  positions=torch.tensor([n - 1 for n in lens],
                                         dtype=torch.int32))
    B = len(lens)
    N = B * P + 1
    q = _bf16(rng, (B, n_q, H, hd))
    kp, vp = _bf16(rng, (N, bs, Hkv, hd)), _bf16(rng, (N, bs, Hkv, hd))
    tables = torch.from_numpy(rng.permutation(N)[:B * P].reshape(B, P)
                              .astype(np.int32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    if pool == "int8":
        kp, ks = quantize_kv(kp.float())
        vp, vs = quantize_kv(vp.float())
        kw.update(k_scale=ks.contiguous(), v_scale=vs.contiguous())
    return (q, kp, vp, tables, lens_t), kw


def _jax(args, kw):
    q, kp, vp, tables, lens = args

    def j(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy().astype(ml_dtypes.bfloat16))
        return jnp.asarray(x.numpy())
    jkw = {k: (j(v) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    out = jax_paged_attention_verify_ref(j(q), j(kp), j(vp), j(tables),
                                         j(lens), **jkw)
    return torch.from_numpy(np.asarray(out, np.float32))


def _chosen_split(args, kw):
    q, kp, _, tables, _ = args
    n_q, H, Hkv = q.shape[1], q.shape[2], kp.shape[2]
    span = kw.get("ring_pages", tables.shape[1]) * kp.shape[1]
    return K.decode_split_tokens(q.shape[0], Hkv, n_q * (H // Hkv), span,
                                 H100_SMS)


@pytest.mark.parametrize("split", ["chosen", 192])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["full", "ring"])
@pytest.mark.parametrize("n_q", [2, 4, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_verify_replay_within_tolerance(layout, n_q, mode, pool, split):
    """The replay at the split the host chooses for an H100 and at 192
    keys (three stages, the ring's depth) stays within the smoke's
    tolerances of both plain versions; the inactive slot is zeros."""
    args, kw = _case(layout, mode, pool, n_q)
    split = _chosen_split(args, kw) if split == "chosen" else split
    out = emulate_verify(*args, split_tokens=split, **kw)
    ref = paged_attention_verify_ref(*args, **kw)
    jax_ref = _jax(args, kw)
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    assert (out.float() - ref.float()).abs().max().item() <= ABS_TOL
    assert (out.float() - jax_ref).abs().max().item() <= ABS_TOL
    assert _row_error(out, ref) <= ROW_TOL
    assert _row_error(out, jax_ref) <= ROW_TOL
    assert bool((out[-1] == 0).all())


@pytest.mark.parametrize("mode", ["full", "ring"])
def test_replay_masks_per_row(mode):
    """The rows' own masks matter: the newest query's rows equal a
    one-query replay at the same position bit for bit (its mask is the
    decode's), while the oldest query's output is far, by the row error,
    from that query attending every key up to the newest position (the
    union of the rows' windows, which the slot map reads)."""
    args, kw = _case("gemma3-12b", mode, "bf16", 4, seed=2)
    q, kp, vp, tables, lens = args
    out = emulate_verify(*args, split_tokens=192, **kw)
    last = emulate_verify(q[:, -1:].contiguous(), kp, vp, tables, lens,
                          split_tokens=192, **kw)
    assert torch.equal(out[:, -1], last[:, 0])
    union = paged_attention_ref(q[:, 0].contiguous(), kp, vp, tables, lens,
                                **kw)
    active = lens > 0
    assert _row_error(out[active, 0], union[active]) > 3 * ROW_TOL


def test_replay_rounds_p():
    """The replay is not the plain version: P's rounding to bf16 moves
    the f32 output before its own rounding."""
    args, kw = _case("yi-9b", "full", "bf16", 4, seed=1)
    out = emulate_verify(*args, split_tokens=192, **kw)
    assert (out != paged_attention_verify_ref(*args, **kw)).any()


@pytest.mark.parametrize("mode", ["full", "ring"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_row_error_sees_a_lost_key_slice(pool, mode):
    """One warp's 16 keys lost in one split of ~1024-key rows: the row
    error, the check the smoke holds every bf16 verify case to, sees it."""
    H, Hkv, hd = LAYOUTS["gemma3-12b"]
    rng = np.random.default_rng(3)
    bs, n_q = 16, 4
    if mode == "full":
        P, kw = 64, {}
        n = P * bs
    else:
        window = 1000
        P = _ring_pages(window, bs, n_q - 1)
        n = 3 * P * bs + 5
        kw = dict(window=window, ring_pages=P,
                  positions=torch.tensor([n - 1], dtype=torch.int32))
    N = P + 1
    args = (_bf16(rng, (1, n_q, H, hd)), _bf16(rng, (N, bs, Hkv, hd)),
            _bf16(rng, (N, bs, Hkv, hd)),
            torch.from_numpy(rng.permutation(N)[:P][None].astype(np.int32)),
            torch.tensor([n], dtype=torch.int32))
    if pool == "int8":
        q, kp, vp, tables, lens = args
        kp, ks = quantize_kv(kp.float())
        vp, vs = quantize_kv(vp.float())
        args = (q, kp, vp, tables, lens)
        kw.update(k_scale=ks, v_scale=vs)
    ref = paged_attention_verify_ref(*args, **kw)
    sound = emulate_verify(*args, split_tokens=128, **kw)
    lost = emulate_verify(*args, split_tokens=128, drop=(3, 1, 2), **kw)
    assert _row_error(sound, ref) <= ROW_TOL
    assert _row_error(lost, ref) > 3 * ROW_TOL


def test_timed_shapes_split():
    """At the smoke's timed verify shapes, gemma3-12b with k = 4 (B 8, 8
    kv heads of 2 groups: 8 rows, one tile, as its decode), the host picks
    on an H100 the split of a decode over the same span: 512 keys over the
    full 2048-key tables (4 x 64 blocks), 256 over the ring of 1056 keys
    (5 x 64); yi-9b's layout with k = 4 (32 rows, two tiles) doubles the
    blocks a split, so its 2048-key span takes 512-key splits where its
    decode takes 256."""
    ring = _ring_pages(1024, 16, 3) * 16
    assert ring == 1056
    assert K.decode_split_tokens(8, 8, 4 * 2, 2048, H100_SMS) == 512
    assert K.decode_split_tokens(8, 8, 2, 2048, H100_SMS) == 512
    assert K.decode_split_tokens(8, 8, 4 * 2, ring, H100_SMS) == 256
    assert K.decode_split_tokens(8, 4, 8, 2048, H100_SMS) == 256
    assert K.decode_split_tokens(8, 4, 4 * 8, 2048, H100_SMS) == 512


# (B, Hkv, groups, n_q, span, sms): the timed shapes, more rows than one
# tile (yi-9b k = 5: 40 rows, three tiles), batch 1, spans shorter than a
# stage and longer than the largest split
VERIFY_SPLIT_CASES = [(8, 8, 2, 4, 2048, 132), (8, 8, 2, 4, 1056, 132),
                      (8, 4, 8, 5, 2048, 132), (1, 4, 8, 2, 2048, 132),
                      (1, 1, 1, 8, 16, 132), (64, 8, 2, 8, 32768, 132),
                      (2, 8, 2, 4, 131072, 114), (3, 1, 24, 3, 200, 8)]


@pytest.mark.parametrize("B,Hkv,groups,n_q,span,sms", VERIFY_SPLIT_CASES)
def test_verify_split_and_workspace(B, Hkv, groups, n_q, span, sms):
    """The split counts the row tiles of n_q · groups rows: a power-of-two
    number of stages within [one stage, the largest split]; at least half
    the blocks of DECODE_WAVES waves where the span allows them and no
    more than twice as many unless the split is at its least or most; the
    workspace holds every (output row, split) partial, B · n_q · H rows."""
    rows = n_q * groups
    split = K.decode_split_tokens(B, Hkv, rows, span, sms)
    stages = split // K.DECODE_STAGE_KEYS
    assert split % K.DECODE_STAGE_KEYS == 0 and stages & (stages - 1) == 0
    assert K.DECODE_STAGE_KEYS <= split <= K.DECODE_MAX_SPLIT
    n_splits = -(-span // split)
    tiles = -(-rows // K.DECODE_ROWS)
    blocks = B * Hkv * tiles * n_splits
    most = B * Hkv * tiles * -(-span // K.DECODE_STAGE_KEYS)
    assert (2 * blocks >= min(K.DECODE_WAVES * sms, most)
            or split == K.DECODE_MAX_SPLIT)
    base = B * Hkv * tiles
    assert (blocks <= 2 * max(K.DECODE_WAVES * sms, base)
            or split in (K.DECODE_STAGE_KEYS, K.DECODE_MAX_SPLIT))
    hd = 256
    H = Hkv * groups
    assert (K.decode_workspace_floats(B, H, hd, span, split, n_q)
            == B * n_q * H * n_splits * (hd + 2))
    assert (K.decode_workspace_floats(B, H, hd, span, split, n_q)
            == n_q * K.decode_workspace_floats(B, H, hd, span, split))


@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("hd", [8, 64, 72, 80, 128, 200, 256])
def test_ring_verify_shared_memory_fits(hd, pool):
    """A ring verify block keeps each key's position beside its slot:
    every width and pool type still fits a Hopper block at the largest
    split; at hd 256 with bf16 pools that is 229,120 of 232,448 B."""
    need = K.decode_smem_bytes(pool, hd, K.DECODE_MAX_SPLIT, ring_verify=True)
    assert need <= K.MAX_SMEM_BYTES
    assert need == (K.decode_smem_bytes(pool, hd, K.DECODE_MAX_SPLIT)
                    + 4 * K.DECODE_MAX_SPLIT)
    if hd == 256 and pool == torch.bfloat16:
        assert need == 229_120


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_verify_dispatch_by_query_type(monkeypatch, dtype, quant, ring):
    """On a CUDA tensor a bf16 verify launches the tensor-core kernel with
    its K queries (the decode entry with n_q = K) and an f32 one the
    CUDA-core kernel; both count under the mode's key (``_int8`` with
    scales). The launches are recorded here, not run: the device test is
    swapped for one that calls these CPU tensors CUDA tensors."""
    calls = []

    def record(name):
        def launch(q, *a, **kw):
            calls.append((name, tuple(q.shape)))
        return launch
    monkeypatch.setattr(ops, "_device_of", lambda q, name: "cuda")
    monkeypatch.setattr(ops, "paged_decode_cuda", record("tc"))
    monkeypatch.setattr(ops, "paged_attention_multi_cuda", record("multi"))
    args, kw = _case("gemma3-12b", "ring" if ring else "full",
                     "int8" if quant else "bf16", 4)
    q, kp, vp, tables, lens = args
    q = q.to(dtype)
    if not quant:
        kp, vp = kp.to(dtype), vp.to(dtype)
    kernels.reset_launch_counts()
    ops.paged_attention_verify(q, kp, vp, tables, lens, **kw)
    key = ("paged_ring_verify" if ring else "paged_verify") + (
        "_int8" if quant else "")
    assert calls == [("tc" if dtype == torch.bfloat16 else "multi",
                      tuple(q.shape))]
    assert {k: v for k, v in kernels.launch_counts.items() if v} == {key: 1}
