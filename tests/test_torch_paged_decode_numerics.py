"""The numerics of the bf16 paged decode kernel (B1 and B2 on the tensor
cores, ``paged_decode_tc`` in ``paged_attention.cu``), replayed on the CPU:
a tolerance argument for the kernel, not a test of it.

The kernel runs only on the card (chip_smoke.py holds it against the plain
version there, by max abs error 2e-2 and by each row's error over its rms,
1e-2). What sets those tolerances is arithmetic the CPU can replay: f32
scores from bf16 q and bf16 (or int8, exact in bf16) keys, times the key's
scale and scale·log2(e); keys split into 64-key stages of four 16-key warp
slices, each warp with its own online softmax in f32 (masked keys at p = 0),
p times the value's scale rounded to bf16 before P·V, l summed from the f32
p; the warps merged at the end of a split, the splits merged by a second
pass. The replay below does the same, except that the kernel's
``ex2.approx`` (relative error near 2^-22) is an exact exp2 here, and the
order of the sums over the head dim (inside one mma step, and the even and
odd depth steps the kernel keeps apart) is not the hardware's; skipping
O's rescale when no row's max grew multiplies by exactly 1, so the replay
always rescales. It must stay
within the smoke's tolerances of the port's plain version and of the JAX
function at yi-9b's (32/4 heads, hd 128) and gemma3-12b's (16/8, hd 256)
head layouts, full and ring mode, bf16 and int8 pools.

The host side the CPU does run is tested as it is: the split choice, the
workspace and shared-memory sizes, and the width table read from the
source."""
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import (
    paged_attention_ref as jax_paged_attention_ref)
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     ring_key_positions)
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


def emulate_decode(q, k_pool, v_pool, tables, lens, *, split_tokens,
                   window=None, positions=None, ring_pages=None,
                   k_scale=None, v_scale=None, drop=None):
    """The bf16 decode kernel's arithmetic on q (B, H, hd) bf16 and bf16 or
    int8 pools: returns out (B, H, hd) bf16. `drop` = (split, stage, warp)
    skips that warp slice in every split and kv head (a planted fault)."""
    B, H, hd = q.shape
    _, bs, Hkv, _ = k_pool.shape
    g = H // Hkv
    c = hd ** -0.5 * LOG2E
    ring = ring_pages is not None
    span = (ring_pages if ring else tables.shape[1]) * bs
    quant = k_scale is not None
    out = torch.zeros((B, H, hd))
    t = torch.arange(span)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        if ring:
            kpos = ring_key_positions(positions[b:b + 1], ring_pages, bs)[0]
            pos = int(positions[b])
            live = (kpos >= 0) & (kpos <= pos) & (kpos > pos - window)
        else:
            live = t < min(n, span)
        slots = tables[b, t // bs].long() * bs + t % bs
        k = k_pool.reshape(-1, Hkv, hd)[slots].float().transpose(0, 1)
        v = v_pool.reshape(-1, Hkv, hd)[slots].float().transpose(0, 1)
        qg = q[b].float().reshape(Hkv, g, hd)
        s_all = qg @ k.transpose(1, 2)                    # (Hkv, g, span)
        if quant:
            ks = k_scale.reshape(-1, Hkv)[slots].T[:, None, :]
            vs = v_scale.reshape(-1, Hkv)[slots].T[:, None, :]
            s_all = s_all * (ks * c)
        else:
            vs = torch.ones((Hkv, 1, span))
            s_all = s_all * c
        parts = []                                        # (m, l, acc)
        for split, t0 in enumerate(range(0, span, split_tokens)):
            t_stop = min(t0 + split_tokens, span if ring else min(n, span))
            if t0 >= t_stop:
                continue
            m = torch.full((WARPS, Hkv, g), NEG_INF)
            l = torch.zeros((WARPS, Hkv, g))
            o = torch.zeros((WARPS, Hkv, g, hd))
            for stage, s0 in enumerate(range(t0, t_stop, WARPS * SLICE)):
                for w in range(WARPS):
                    k0 = s0 + w * SLICE
                    if k0 >= t_stop or drop == (split, stage, w):
                        continue
                    idx = torch.arange(k0, k0 + SLICE).clamp(max=span - 1)
                    ok = live[idx] & (torch.arange(k0, k0 + SLICE) < t_stop)
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
        l_all = torch.zeros((Hkv, g))
        acc = torch.zeros((Hkv, g, hd))
        for pm, pl, pa in parts:
            wgt = torch.where(pl > 0, torch.exp2(pm - m_all), 0.0)
            l_all = l_all + pl * wgt
            acc = acc + pa * wgt[..., None]
        out[b] = (acc / l_all.clamp(min=1e-30)[..., None]).reshape(H, hd)
    return out.to(torch.bfloat16)


def _row_error(out, ref):
    def rms(x):
        return x.pow(2).mean(-1).sqrt()
    diff = out.float() - ref.float()
    return (rms(diff) / rms(ref.float()).clamp_min(1e-30)).max().item()


def _case(layout, mode, pool, seed=0):
    """Short tables: (args, kw) for the port's functions. Full mode: 4
    sequences of 24-page tables (block 16) with lengths 1, one cutting a
    stage mid-way, the whole table and 0 (inactive); ring mode: a window of
    100 through 8 ring pages, positions before, at and far past the first
    wrap, and an inactive slot (position 0, as the engine passes it)."""
    H, Hkv, hd = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    bs = 16
    if mode == "full":
        P, lens, kw = 24, [1, 201, 384, 0], {}
    else:
        window = 100
        R = -(-window // bs) + 1
        P, lens = R + 2, [37, R * bs, 5 * R * bs + 3, 0]
        kw = dict(window=window, ring_pages=R,
                  positions=torch.tensor([max(n - 1, 0) for n in lens],
                                         dtype=torch.int32))
    B = len(lens)
    N = B * P + 1

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    q = bf16((B, H, hd))
    kp, vp = bf16((N, bs, Hkv, hd)), bf16((N, bs, Hkv, hd))
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
    out = jax_paged_attention_ref(j(q), j(kp), j(vp), j(tables), j(lens),
                                  **jkw)
    return torch.from_numpy(np.asarray(out, np.float32))


def _chosen_split(args, kw):
    q, kp, _, tables, _ = args
    H, Hkv = q.shape[1], kp.shape[2]
    span = kw.get("ring_pages", tables.shape[1]) * kp.shape[1]
    return K.decode_split_tokens(q.shape[0], Hkv, H // Hkv, span, H100_SMS)


@pytest.mark.parametrize("split", ["chosen", 192])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["full", "ring"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_replay_within_tolerance(layout, mode, pool, split):
    """The replay at the split the host chooses for an H100 (one 64-key
    stage at these short spans) and at 192 keys (three stages, the ring's
    depth) stays within the smoke's tolerances of both plain versions;
    the inactive slot is zeros."""
    args, kw = _case(layout, mode, pool)
    split = _chosen_split(args, kw) if split == "chosen" else split
    out = emulate_decode(*args, split_tokens=split, **kw)
    ref = paged_attention_ref(*args, **kw)
    jax_ref = _jax(args, kw)
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    assert (out.float() - ref.float()).abs().max().item() <= ABS_TOL
    assert (out.float() - jax_ref).abs().max().item() <= ABS_TOL
    assert _row_error(out, ref) <= ROW_TOL
    assert _row_error(out, jax_ref) <= ROW_TOL
    assert bool((out[-1] == 0).all())


def test_replay_rounds_p():
    """The replay is not the plain version: P's rounding to bf16 moves
    the f32 output before its own rounding."""
    args, kw = _case("yi-9b", "full", "bf16", seed=1)
    out = emulate_decode(*args, split_tokens=192, **kw)
    assert (out != paged_attention_ref(*args, **kw)).any()


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_row_error_sees_a_lost_key_slice(pool):
    """One warp's 16 keys lost in one split of a 1024-key row: the row
    error, the check the smoke adds at its timed decode shapes, sees it."""
    H, Hkv, hd = LAYOUTS["yi-9b"]
    rng = np.random.default_rng(3)
    bs, P = 16, 64
    N = P + 1

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    args = (bf16((1, H, hd)), bf16((N, bs, Hkv, hd)), bf16((N, bs, Hkv, hd)),
            torch.from_numpy(rng.permutation(N)[:P][None].astype(np.int32)),
            torch.tensor([P * bs], dtype=torch.int32))
    kw = {}
    if pool == "int8":
        q, kp, vp, tables, lens = args
        kp, ks = quantize_kv(kp.float())
        vp, vs = quantize_kv(vp.float())
        args, kw = (q, kp, vp, tables, lens), dict(k_scale=ks, v_scale=vs)
    ref = paged_attention_ref(*args, **kw)
    sound = emulate_decode(*args, split_tokens=128, **kw)
    lost = emulate_decode(*args, split_tokens=128, drop=(3, 1, 2), **kw)
    assert _row_error(sound, ref) <= ROW_TOL
    assert _row_error(lost, ref) > 3 * ROW_TOL


def _source_constants():
    text = K.SOURCE.read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]*);", text)
        assert m, f"{name} not found in paged_attention.cu"
        return m.group(1)
    widths = re.search(r"constexpr int kDecWidths\[\] = \{([^}]*)\};", text)
    assert widths and "kDecWidths[I]" in text   # the dispatch walks it
    warps, slice_keys = int(const("kDecWarps")), int(const("kDecSliceKeys"))
    assert const("kDecStageKeys") == "kDecWarps * kDecSliceKeys"
    return dict(stage_keys=warps * slice_keys, stages=int(const("kDecStages")),
                rows=int(const("kDecRows")),
                max_split=int(const("kDecMaxSplit")),
                widths=tuple(int(x) for x in widths.group(1).split(",")))


def test_host_constants_match_source():
    src = _source_constants()
    assert (src["stage_keys"], src["stages"], src["rows"], src["max_split"],
            src["widths"]) == (K.DECODE_STAGE_KEYS, K.DECODE_STAGES,
                               K.DECODE_ROWS, K.DECODE_MAX_SPLIT,
                               K.DECODE_WIDTHS)
    assert (SLICE * WARPS) == K.DECODE_STAGE_KEYS


def test_width_table_matches_configs():
    """The source instantiates the bf16 decode kernel at the configs' head
    dims (the registered architectures and their reduced variants) and at
    no other width; every head dim the wrapper takes has a width."""
    widths = _source_constants()["widths"]
    cfgs = [get_config(n) for n in list_configs()]
    config_dims = {c.resolved_head_dim for c in cfgs + [reduced(c)
                                                        for c in cfgs]}
    assert set(widths) == config_dims == {64, 80, 128, 256}
    assert list(widths) == sorted(widths) and all(w % 16 == 0 for w in widths)
    for hd in range(8, 257, 8):
        w = K.decode_width(hd)
        assert w >= hd and (w == hd or hd not in config_dims)


# (B, Hkv, groups, span): the smoke's timed shapes, small and large batches,
# spans shorter than a stage and longer than the largest split
SPLIT_CASES = [(8, 4, 8, 2048, 132), (8, 8, 2, 65 * 16, 132),
               (1, 4, 8, 2048, 132), (1, 1, 1, 16, 132),
               (64, 8, 2, 32768, 132), (3, 1, 24, 200, 132),
               (2, 8, 2, 131072, 114), (16, 4, 8, 4096, 8)]


@pytest.mark.parametrize("B,Hkv,groups,span,sms", SPLIT_CASES)
def test_split_choice(B, Hkv, groups, span, sms):
    """A power-of-two number of stages, within [one stage, the largest
    split], the
    splits covering the span; the workspace holds every (row, split)
    partial; at least half the blocks of DECODE_WAVES waves of the SMs
    where the span allows them (whole stages round the split up, at most
    doubling it), and no more than twice as many unless the split is at
    its least or its most."""
    split = K.decode_split_tokens(B, Hkv, groups, span, sms)
    stages = split // K.DECODE_STAGE_KEYS
    assert split % K.DECODE_STAGE_KEYS == 0 and stages & (stages - 1) == 0
    assert K.DECODE_STAGE_KEYS <= split <= K.DECODE_MAX_SPLIT
    n_splits = -(-span // split)
    assert n_splits * split >= span > (n_splits - 1) * split
    hd = 128
    H = Hkv * groups
    rows = B * H
    assert (K.decode_workspace_floats(B, H, hd, span, split)
            == rows * n_splits * (hd + 2))
    blocks = B * Hkv * -(-groups // K.DECODE_ROWS) * n_splits
    most = B * Hkv * -(-groups // K.DECODE_ROWS) * -(
        -span // K.DECODE_STAGE_KEYS)
    assert (2 * blocks >= min(K.DECODE_WAVES * sms, most)
            or split == K.DECODE_MAX_SPLIT)
    base = B * Hkv * -(-groups // K.DECODE_ROWS)      # one split each
    assert (blocks <= 2 * max(K.DECODE_WAVES * sms, base)
            or split in (K.DECODE_STAGE_KEYS, K.DECODE_MAX_SPLIT))


def test_timed_shapes_split():
    """At the smoke's timed decode shapes on an H100 the host picks 256-key
    splits: yi-9b (span 2048) 8 x 32 blocks, gemma3's ring (span 1040) 5 x
    64; at batch 1 one stage a block (yi-9b: 32 x 4 blocks)."""
    assert K.decode_split_tokens(8, 4, 8, 2048, H100_SMS) == 256
    assert K.decode_split_tokens(8, 8, 2, 65 * 16, H100_SMS) == 256
    assert K.decode_split_tokens(1, 4, 8, 2048, H100_SMS) == 64


@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("hd", [8, 64, 72, 80, 128, 200, 256])
def test_shared_memory_fits(hd, pool):
    """Every width, pool type and the largest split fit a Hopper block;
    at hd 256 the bf16 block takes 202,752 B of stages."""
    need = K.decode_smem_bytes(pool, hd, K.DECODE_MAX_SPLIT)
    assert need <= K.MAX_SMEM_BYTES
    if hd == 256:
        stages = 3 * 2 * 64 * (2 * 256 + 16 if pool == torch.bfloat16
                               else 256 + 16)
        assert need == stages + 16 * 264 * 2 + 2 * 3 * 64 * 4 + 2048 * 4
