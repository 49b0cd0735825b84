"""The fused decode step (kernel K5) of the PyTorch port against the JAX
package: chunk layout and gate, ``decode_mode``, the packers, the plain
version ``decode_step_plain`` against the reference's ``decode_step``
(Pallas in interpret mode, f32 at 1e-5; bf16 within one bf16 ulp), and
``kv_generate(fused="on")`` end to end in bf16 at the reference's own
fused-decode test config (units 128, heads 4, hidden 512, 2 layers,
Normal(0.15)).  The CUDA kernel itself is held against the plain version
on the card (``cuda`` marker; skipped without one)."""
import numpy as onp
import pytest
import torch

from _torch_parity import (KERNEL_TOL, jax_gpt, jax_llama, need_cuda,
                           port_gpt, port_llama, rand)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import decode_fused as P


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _J():
    from mxnet_tpu.ops import decode_fused as J
    return J


# --------------------------------------------------------------------------- #
# layout, gate, decode_mode
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("u,f,kvd", [(768, 3072, None), (4096, 11008, None),
                                     (4096, 11008, 1024), (128, 512, None),
                                     (64, 128, 32), (96, 200, None),
                                     (5120, 13824, 640), (32, 64, None)])
def test_pick_cw_and_schedule_match_reference(u, f, kvd):
    from mxnet_tpu.models import GPTConfig, LlamaConfig

    J = _J()
    assert P._pick_cw(u, f, kvd) == J._pick_cw(u, f, kvd)
    if J._pick_cw(u, f, kvd) == 0:      # no schedule: the gate refuses
        return
    heads = max(1, u // 64)
    gcfg = GPTConfig(units=u, num_heads=heads, hidden_size=f)
    assert P._schedule(gcfg) == J._schedule(gcfg)
    kv = heads if kvd is None else kvd // (u // heads)
    lcfg = LlamaConfig(units=u, num_heads=heads, num_kv_heads=kv,
                       hidden_size=f)
    assert P._schedule(lcfg) == J._schedule(lcfg)


# (family, units, heads, kv heads, hidden, batch, total, dtype)
GATE_CASES = [
    ("gpt", 128, 4, None, 512, 1, 32, "bfloat16"),
    ("gpt", 128, 4, None, 512, 4, 16, "bfloat16"),
    ("llama", 128, 4, 2, 256, 1, 32, "bfloat16"),
    ("llama", 64, 4, 2, 128, 3, 24, "bfloat16"),
    ("gpt", 128, 4, None, 512, 5, 32, "bfloat16"),     # batch 5
    ("gpt", 128, 4, None, 512, 1, 32, "float32"),      # f32
    ("gpt", 96, 4, None, 200, 1, 32, "bfloat16"),      # untileable
    ("llama", 128, 4, 3, 256, 1, 32, "bfloat16"),      # h % kv != 0
    ("gpt", 130, 5, None, 520, 1, 32, "bfloat16"),     # no chunk width
]


def _cfgs(fam, u, h, kv, f):
    from mxnet_tpu.models import GPTConfig as JG, LlamaConfig as JL
    from mxnet_tpu_torch.models import GPTConfig, LlamaConfig

    if fam == "gpt":
        return (JG(units=u, num_heads=h, hidden_size=f),
                GPTConfig(units=u, num_heads=h, hidden_size=f))
    return (JL(units=u, num_heads=h, num_kv_heads=kv, hidden_size=f),
            LlamaConfig(units=u, num_heads=h, num_kv_heads=kv,
                        hidden_size=f))


@pytest.mark.parametrize("case", GATE_CASES,
                         ids=[f"{c[0]}-u{c[1]}-kv{c[3]}-b{c[5]}-{c[7]}"
                              for c in GATE_CASES])
def test_gate_agrees_with_reference(case):
    import jax.numpy as jnp

    fam, u, h, kv, f, batch, total, dt = case
    jcfg, pcfg = _cfgs(fam, u, h, kv, f)
    ref = _J().fused_decode_supported(jcfg, batch, total, jnp.dtype(dt))
    got = P.fused_decode_supported(pcfg, batch, total, getattr(torch, dt))
    assert got == ref


@pytest.mark.parametrize("fam,u,h,kv,f,batch,total", [
    ("gpt", 768, 12, None, 3072, 4, 768),       # GPT-2 small, B*T > 128
    ("llama", 4096, 32, 32, 11008, 1, 64),      # Llama-7B
    ("llama", 4096, 32, 8, 11008, 2, 64)])      # its GQA variant
def test_gate_drops_only_the_vmem_clause(monkeypatch, fam, u, h, kv, f,
                                         batch, total):
    """The one named difference: configurations the reference refuses
    for its TPU VMEM budget alone, which the port admits."""
    import jax.numpy as jnp

    jcfg, pcfg = _cfgs(fam, u, h, kv, f)
    assert not _J().fused_decode_supported(jcfg, batch, total,
                                           jnp.bfloat16)
    # without the budget the reference admits it too
    monkeypatch.setattr(_J(), "_VMEM_BUDGET", float("inf"))
    assert _J().fused_decode_supported(jcfg, batch, total, jnp.bfloat16)
    assert P.fused_decode_supported(pcfg, batch, total, torch.bfloat16)


# --------------------------------------------------------------------------- #
# the kernel's work plan (CPU)
# --------------------------------------------------------------------------- #

# (family, units, heads, kv heads, hidden, batch, cache length)
PLAN_CASES = [("gpt", 768, 12, None, 3072, 4, 768),      # GPT-2 small
              ("llama", 4096, 32, 32, 11008, 1, 64),     # Llama-7B
              ("llama", 4096, 32, 8, 11008, 2, 64),      # its GQA variant
              ("gpt", 128, 4, None, 512, 3, 256)]        # the card tests'


def _plan_layout(case, quant):
    from types import SimpleNamespace

    fam, u, h, kv, f, batch, total = case
    cfg = _cfgs(fam, u, h, kv, f)[1]
    cw, spans = P._schedule(cfg)
    lo, nc = P._span_offsets(spans)
    kvh = kv or h
    return SimpleNamespace(B=batch, U=u, F=f, H=h, KV=kvh, D=u // h, T=total,
                           cw=cw, quant=quant, llama=fam == "llama", lo=lo,
                           NC=nc, QS=u + 2 * kvh * (u // h))


@pytest.mark.parametrize("which", ["0", "1", "chunk-1", "chunk", "T-1"])
@pytest.mark.parametrize("grid", [132, 264])
@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=[f"{c[0]}-u{c[1]}-kv{c[3]}-b{c[5]}"
                              for c in PLAN_CASES])
def test_attention_chunks_cover_positions(case, grid, which):
    """The position chunks of attention cover 0..pos exactly, none empty,
    one item a block, no more chunks than 16 positions each would give,
    each chunk's scores within the kernel's shared memory (the gate's
    bound of one item's ``total`` positions)."""
    L = _plan_layout(case, False)
    lc0 = P.plan(L, grid, L.T - 1)["lc"]
    pos = {"0": 0, "1": 1, "chunk-1": lc0 - 1, "chunk": lc0,
           "T-1": L.T - 1}[which]
    pl = P.plan(L, grid, pos)
    nc, lc = pl["nc"], pl["lc"]
    cover = [t for c in range(nc) for t in range(c * lc,
                                                 min(pos + 1, (c + 1) * lc))]
    assert cover == list(range(pos + 1))
    assert (nc - 1) * lc < pos + 1                      # no empty chunk
    assert L.B * L.KV * nc <= grid                      # one item a block
    assert lc <= L.T
    assert nc <= -(-(pos + 1) // 16)                    # 16 a chunk at most


def _kernel_bytes(L, pl, quant):
    """The bytes each phase of the kernel uses under plan ``pl`` (csrc
    ``col_smem``, ``phase_row``, ``attn_work``): column, fc2/down,
    attention."""
    G, D = L.H // L.KV, L.D
    n_row = L.F // L.cw
    parts = 2 if L.llama else 1
    col = 4 * (L.B * L.U + 8 * L.B * P._col_tile(L.cw, quant))
    if pl["stage"]:
        col += 4 * ((1 if L.llama else 2) * L.U + 2 * L.U +
                    L.B * L.U // 2)
    row = 4 * -(-n_row // pl["s_row"]) * L.cw * parts * (L.B + 2)
    return col, row


def _attn_bytes(L, pl, grid):
    G, D = L.H // L.KV, L.D
    slots = -(-(L.B * L.KV * pl["nc"]) // grid) if pl["keep"] else 1
    return 4 * (slots * G * pl["lc"] + max((G + 2) * D,
                                           pl["pv_rows"] * pl["gm"] * D))


@pytest.mark.parametrize("grid", [132, 264])
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=[f"{c[0]}-u{c[1]}-kv{c[3]}-b{c[5]}"
                              for c in PLAN_CASES])
def test_weight_phase_plan(case, quant, grid):
    """Each column span goes in two K slabs of 16-row steps and whole
    128-byte column tiles, the fc2/down items are one a block, and at
    these shapes the layout stages the prelude rows, takes 4 F slabs and
    sums the p.V partials of the group's heads (up to 8) through 8 rows,
    within two blocks' shared memory a SM."""
    L = _plan_layout(case, quant)
    pl = P.plan(L, grid, L.T - 1)
    tn = P._col_tile(L.cw, quant)
    ffn_w = (2 if L.llama else 1) * L.F
    for width in (L.QS, L.U, ffn_w):
        assert width % tn == 0 and L.cw % tn == 0
        assert tn * (1 if quant else 2) == min(128, L.cw * (1 if quant
                                                            else 2))
    assert pl["s_qkv"] == pl["s_proj"] == pl["s_ffn"] == min(2, L.U // 16)
    n_row = L.F // L.cw
    assert pl["s_row"] == min(n_row, 4)
    assert pl["s_row"] * pl["g_row"] <= grid and pl["g_row"] <= L.U
    assert pl["stage"] and pl["pv_rows"] == 8
    assert pl["gm"] == min(8, L.H // L.KV) and pl["keep"]
    smem = P._smem_bytes(L.B, L.U, L.F, L.H, L.KV, L.T, L.cw, L.llama)
    assert smem == pl["smem"]
    assert max(*_kernel_bytes(L, pl, quant),
               _attn_bytes(L, pl, grid)) <= smem <= P._SMEM_PAIR


# (family, units, heads, kv heads, hidden): GPT-2 small to xl, Llama-7B,
# Llama-3-8B, Llama-13B, a 70B-class GQA width, the card tests'
SWEEP = [("gpt", 768, 12, None, 3072), ("gpt", 1024, 16, None, 4096),
         ("gpt", 1280, 20, None, 5120), ("gpt", 1600, 25, None, 6400),
         ("llama", 4096, 32, 32, 11008), ("llama", 4096, 32, 8, 14336),
         ("llama", 5120, 40, 40, 13824), ("llama", 8192, 64, 8, 28672),
         ("gpt", 128, 4, None, 512)]


@pytest.mark.parametrize("case", SWEEP,
                         ids=[f"{c[0]}-u{c[1]}-kv{c[3]}" for c in SWEEP])
def test_every_case_the_gate_admits_fits_the_kernel(case):
    """For every batch, cache length and position the gate admits, on a
    grid of one or two blocks a SM: the launcher's shared memory is
    within one block's, each phase of the plan fits in it (attention
    keeping or recomputing its scores), the chunks cover 0..pos."""
    from types import SimpleNamespace

    fam, u, h, kv, f = case
    cfg = _cfgs(fam, u, h, kv, f)[1]
    cw, spans = P._schedule(cfg)
    lo, nct = P._span_offsets(spans)
    kvh = kv or h
    admitted = 0
    for batch in (1, 2, 3, 4):
        for total in (64, 1024, 4096, 16384, 57000):
            if not P.fused_decode_supported(cfg, batch, total,
                                            torch.bfloat16):
                continue
            admitted += 1
            L = SimpleNamespace(B=batch, U=u, F=f, H=h, KV=kvh, D=u // h,
                                T=total, cw=cw, llama=fam == "llama",
                                lo=lo, NC=nct)
            smem = P._smem_bytes(batch, u, f, h, kvh, total, cw,
                                 L.llama)
            assert smem <= P._SMEM_MAX
            for grid in (132, 264):
                for pos in (0, 1, total // 2, total - 1):
                    pl = P.plan(L, grid, pos)
                    for quant in (False, True):
                        assert max(_kernel_bytes(L, pl, quant)) <= smem
                    assert _attn_bytes(L, pl, grid) <= smem
                    assert pl["pv_rows"] in (1, 2, 4, 8)
                    assert 1 <= pl["gm"] <= min(8, h // kvh)
                    assert pl["s_qkv"] <= 16 and pl["lc"] <= total
                    nc, lc = pl["nc"], pl["lc"]
                    assert (nc - 1) * lc < pos + 1 <= nc * lc
    assert admitted


# (family, units, heads, kv heads, hidden, batch, cache length, admitted)
WIDE_GATE_CASES = [
    ("llama", 5120, 40, 40, 13824, 4, 4096, True),     # Llama-13B
    ("llama", 8192, 64, 8, 28672, 4, 4096, True),      # 70B-class GQA
    ("llama", 8192, 64, 8, 28672, 4, 8192, False),     # its scores
    ("llama", 4096, 32, 32, 11008, 1, 57000, True),    # D 128, one head
    ("llama", 4096, 32, 32, 11008, 1, 58000, False),   # a group
    ("gpt", 16384, 128, None, 65536, 4, 64, False)]    # input rows


@pytest.mark.parametrize("case", WIDE_GATE_CASES,
                         ids=[f"{c[0]}-u{c[1]}-b{c[5]}-t{c[6]}"
                              for c in WIDE_GATE_CASES])
def test_gate_at_wide_configs(case):
    """The gate's answers at wide configurations and long caches, on both
    sides of its shared-memory rule; where it admits, the launch at the
    last position fits the kernel on a grid of one block a SM, with more
    (batch row, KV head) pairs than blocks for Llama-13B."""
    from types import SimpleNamespace

    fam, u, h, kv, f, batch, total, admitted = case
    cfg = _cfgs(fam, u, h, kv, f)[1]
    assert P.fused_decode_supported(cfg, batch, total,
                                    torch.bfloat16) == admitted
    if not admitted:
        return
    cw, spans = P._schedule(cfg)
    lo, nct = P._span_offsets(spans)
    L = SimpleNamespace(B=batch, U=u, F=f, H=h, KV=kv or h, D=u // h,
                        T=total, cw=cw, llama=fam == "llama", lo=lo,
                        NC=nct)
    smem = P._smem_bytes(batch, u, f, h, L.KV, total, cw, L.llama)
    assert smem <= P._SMEM_MAX
    pl = P.plan(L, 132, total - 1)
    assert _attn_bytes(L, pl, 132) <= smem
    assert max(_kernel_bytes(L, pl, True)) <= smem
    if batch * L.KV > 132:
        assert not pl["keep"]                   # the scores recomputed


@pytest.fixture(scope="module")
def models():
    """(reference, port) pairs: GPT and Llama, bf16 and f32."""
    out = {}
    for fam, mk, port in (("gpt", jax_gpt, port_gpt),
                          ("llama", jax_llama, port_llama)):
        for dt in ("float32", "bfloat16"):
            net = mk()
            pm = port(net)
            if dt == "bfloat16":
                net.cast("bfloat16")
                pm = pm.to(torch.bfloat16)
            out[fam, dt] = (net, pm)
    return out


MODE_ARGS = [(1, "native", "on", "auto"), (3, "int8", "on", "off"),
             (5, "native", "on", "auto"), (1, "native", "on", "on"),
             (2, "native", "auto", "auto"), (2, "int8", "off", "on"),
             (1, "native", "off", "off")]


@pytest.mark.parametrize("env", ["1", "0"])
@pytest.mark.parametrize("fam,dt", [("gpt", "bfloat16"), ("gpt", "float32"),
                                    ("llama", "bfloat16")])
def test_decode_mode_matches_reference(monkeypatch, models, env, fam, dt):
    from mxnet_tpu.base import MXNetError as JError
    from mxnet_tpu.models import decode_mode as jmode
    from mxnet_tpu_torch.models import decode_mode

    monkeypatch.setenv("MXNET_STACKED_DECODE", env)
    net, pm = models[fam, dt]
    for batch, weights, fused, stacked in MODE_ARGS:
        try:
            ref = jmode(net, batch, 32, weights, fused, stacked)
        except JError:
            ref = MXNetError
        try:
            got = decode_mode(pm, batch, 32, weights, fused, stacked)
        except MXNetError:
            got = MXNetError
        assert got == ref, (batch, weights, fused, stacked)


# --------------------------------------------------------------------------- #
# packers and the plain version
# --------------------------------------------------------------------------- #

def _packs(net, pm, dtype, quant):
    import jax.numpy as jnp

    J = _J()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if hasattr(net.blocks[0], "rms1"):
        return (J.pack_llama_weights(net.blocks, net._cfg, jdt, quant),
                P.pack_llama_weights(pm.blocks, pm._cfg, dtype, quant))
    return (J.pack_gpt_weights(net.blocks, jdt, quant),
            P.pack_gpt_weights(pm.blocks, dtype, quant))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(onp.float64)
    return onp.asarray(a, onp.float64)


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_packers_match_reference(models, fam, quant):
    net, pm = models[fam, "float32"]
    ref, got = _packs(net, pm, torch.float32, quant)
    for i, (a, b) in enumerate(zip(ref, got)):
        a = onp.asarray(a)
        assert a.shape == tuple(b.shape), i
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), i
        if b.dtype == torch.int8:
            onp.testing.assert_array_equal(b.numpy(), a)
        else:
            assert onp.abs(a.astype(onp.float64) - _np(b)).max() <= 1e-7, i


def _step_inputs(cfg, B, T, dtype, seed=0):
    NL, U, H = cfg.num_layers, cfg.units, cfg.num_heads
    KV = getattr(cfg, "num_kv_heads", None) or H
    D = U // H
    x = rand(seed + 1, B, U)
    kh = rand(seed + 2, NL, B, KV, T, D, scale=0.5)
    vh = rand(seed + 3, NL, B, KV, T, D, scale=0.5)
    if dtype == torch.bfloat16:     # values the bf16 caches can hold
        x, kh, vh = (torch.from_numpy(a).bfloat16().float().numpy()
                     for a in (x, kh, vh))
    return x, kh, vh


def _run_both(net, pm, B, pos, quant, dtype, T=16):
    import jax.numpy as jnp

    fam_llama = hasattr(net.blocks[0], "rms1")
    act = None if fam_llama else "gelu"
    eps = 1e-6 if fam_llama else 1e-5
    jp, pp = _packs(net, pm, dtype, quant)
    x, kh, vh = _step_inputs(net._cfg, B, T, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jk, jv = _J().decode_step(pos, jnp.asarray(x, jdt), jp,
                                  jnp.asarray(kh, jdt), jnp.asarray(vh, jdt),
                                  net._cfg, act, eps)
    pk = torch.from_numpy(kh).to(dtype)
    pv = torch.from_numpy(vh).to(dtype)
    px, pk2, pv2 = P.decode_step(pos, torch.from_numpy(x).to(dtype), pp, pk,
                                 pv, pm._cfg, act, eps)
    assert pk2 is pk and pv2 is pv               # updated in place
    return ((_np(onp.asarray(jx, onp.float32)), _np(px)),
            (_np(onp.asarray(jk, onp.float32)), _np(pk)),
            (_np(onp.asarray(jv, onp.float32)), _np(pv)),
            (kh, vh))


@pytest.mark.parametrize("B,pos", [(1, 0), (3, 9), (3, 15)])
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_plain_matches_reference_decode_step(models, fam, quant, B, pos):
    """f32: the output hidden state and the written K/V column within
    1e-5 of the reference kernel in interpret mode; every other cache
    entry untouched, bit for bit."""
    net, pm = models[fam, "float32"]
    (jx, px), (jk, pk), (jv, pv), (kh, vh) = _run_both(net, pm, B, pos,
                                                       quant, torch.float32)
    onp.testing.assert_allclose(px, jx, **KERNEL_TOL)
    onp.testing.assert_allclose(pk[:, :, :, pos], jk[:, :, :, pos],
                                **KERNEL_TOL)
    onp.testing.assert_allclose(pv[:, :, :, pos], jv[:, :, :, pos],
                                **KERNEL_TOL)
    rest = onp.ones(kh.shape[3], bool)
    rest[pos] = False
    onp.testing.assert_array_equal(pk[:, :, :, rest], kh[:, :, :, rest])
    onp.testing.assert_array_equal(pv[:, :, :, rest], vh[:, :, :, rest])


@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_plain_bf16_within_one_ulp(fam):
    """bf16, one layer: the output and the written K/V column within one
    bf16 ulp of the tensor's largest magnitude.  The two sides sum the
    projections in other orders, so a bf16 rounding can land one step
    apart; over more layers such steps compound."""
    mk, port = (jax_gpt, port_gpt) if fam == "gpt" else \
        (jax_llama, port_llama)
    net = mk(num_layers=1)
    pm = port(net).to(torch.bfloat16)
    net.cast("bfloat16")
    for (ref, got) in _run_both(net, pm, 2, 11, False, torch.bfloat16)[:3]:
        ulp = onp.exp2(onp.floor(onp.log2(onp.abs(ref).max())) - 7)
        assert onp.abs(got - ref).max() <= ulp


def test_wrapper_checks_shapes():
    from mxnet_tpu_torch.models import GPTConfig

    cfg = GPTConfig(num_layers=1, units=32, num_heads=4, hidden_size=64)
    x = torch.zeros(1, 32)
    packed = (torch.zeros(3, 32, 32), torch.zeros(3, 32), torch.zeros(1, 4, 32),
              torch.zeros(1, 32), torch.zeros(1, 1), torch.ones(1, 32))
    kh = torch.zeros(1, 1, 4, 8, 8)
    with pytest.raises(MXNetError, match="wstream"):
        P.decode_step(0, x, packed, kh, kh.clone(), cfg, "gelu", 1e-5)
    with pytest.raises(MXNetError, match="caches"):
        P.decode_step(0, x, packed, torch.zeros(1, 1, 4, 8, 4),
                      torch.zeros(1, 1, 4, 8, 4), cfg, "gelu", 1e-5)


# --------------------------------------------------------------------------- #
# kv_generate(fused="on") end to end, bf16
# --------------------------------------------------------------------------- #

BIG = dict(units=128, num_heads=4, hidden_size=512)


@pytest.fixture(scope="module")
def big_gpt():
    net = jax_gpt(init=0.15, **BIG)
    pm = port_gpt(net).to(torch.bfloat16)
    net.cast("bfloat16")
    return net, pm


@pytest.fixture(scope="module")
def big_llama():
    net = jax_llama(init=0.15, units=128, hidden_size=256)
    pm = port_llama(net).to(torch.bfloat16)
    net.cast("bfloat16")
    return net, pm


E2E = [("batched", "native", 0, (1, 5), 10), ("batched", "native", 1, (2, 7), 10),
       ("scan", "native", 2, (1, 6), 6), ("batched", "int8", 4, (1, 5), 8)]


def _same_but_near_ties(net, got, ref):
    """Row by row, ``got`` equals ``ref`` up to the first token where they
    differ; there the reference's own bf16 forward logits must hold a
    near-tie (the top two within two bf16 steps, ``got``'s token among
    them), after which the streams legitimately part.  Each such flip at
    this config is listed in ROADMAP.md §3 with its inputs."""
    import mxnet_tpu as mx

    for g, r in zip(got, ref):
        diff = onp.nonzero(g != r)[0]
        if not diff.size:
            continue
        p = diff[0]
        lg = net(mx.nd.array(r[None, :p], dtype="int32")).asnumpy()
        lg = lg[0, -1].astype(onp.float64)
        top = onp.sort(lg)[-2:]
        step = onp.exp2(onp.floor(onp.log2(onp.abs(top).max())) - 7)
        assert top[1] - top[0] <= 2 * step, (p, top)
        assert lg[g[p]] >= top[0], (p, g[p])


@pytest.mark.parametrize("prefill,weights,seed,shape,n", E2E,
                         ids=[f"{a}-{b}-b{d[0]}" for a, b, _, d, _ in E2E])
def test_fused_kv_generate_token_identical_bf16(big_gpt, prefill, weights,
                                                seed, shape, n):
    """The port's fused stream equals its own unfused stream token for
    token, and the reference's fused stream but for bf16 near-ties."""
    from mxnet_tpu.models import kv_generate as jgen
    from mxnet_tpu_torch.models import kv_generate

    net, pm = big_gpt
    prompt = onp.random.RandomState(seed).randint(0, 97, shape)
    kw = dict(max_new_tokens=n, temperature=0.0, prefill=prefill,
              weights=weights)
    got = kv_generate(pm, prompt, fused="on", **kw)
    own = kv_generate(pm, prompt, fused="off", stacked="off", **kw)
    onp.testing.assert_array_equal(got, own)
    _same_but_near_ties(net, got, jgen(net, prompt, fused="on", **kw))


@pytest.mark.parametrize("weights", ["native", "int8"])
def test_fused_llama_gqa_token_identical_bf16(big_llama, weights):
    from mxnet_tpu.models import kv_generate as jgen
    from mxnet_tpu_torch.models import kv_generate

    net, pm = big_llama
    prompt = onp.random.RandomState(0).randint(0, 97, (1, 5))
    kw = dict(max_new_tokens=8, temperature=0.0, weights=weights)
    got = kv_generate(pm, prompt, fused="on", **kw)
    onp.testing.assert_array_equal(
        kv_generate(pm, prompt, fused="off", stacked="off", **kw), got)
    _same_but_near_ties(net, got, jgen(net, prompt, fused="on", **kw))


def test_weight_update_rebuilds_pack(big_gpt):
    from mxnet_tpu_torch.models import kv_generate
    from mxnet_tpu_torch.models.decoding import _fused_pack

    _, pm = big_gpt
    first = _fused_pack(pm, False)
    assert _fused_pack(pm, False) is first
    prompt = onp.random.RandomState(3).randint(0, 97, (1, 4))
    out1 = kv_generate(pm, prompt, 4, temperature=0.0, fused="on")
    w = pm.blocks[0].attn.qkv.weight
    with torch.no_grad():
        w.neg_()
    try:
        assert _fused_pack(pm, False) is not first
        out2 = kv_generate(pm, prompt, 4, temperature=0.0, fused="on")
        ref2 = kv_generate(pm, prompt, 4, temperature=0.0, fused="off",
                           stacked="off")
        onp.testing.assert_array_equal(out2, ref2)
        assert (out1 != out2).any()
    finally:
        with torch.no_grad():
            w.neg_()


def test_fused_on_refuses_f32(models):
    from mxnet_tpu_torch.models import kv_generate

    _, pm = models["gpt", "float32"]
    with pytest.raises(MXNetError, match="fused"):
        kv_generate(pm, onp.zeros((1, 4), onp.int64), 2, temperature=0.0,
                    fused="on")


# --------------------------------------------------------------------------- #
# the kernel on the card
# --------------------------------------------------------------------------- #

def _card_model(fam):
    from mxnet_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig

    if fam == "gpt":
        m = GPT(GPTConfig(vocab_size=97, max_length=64, num_layers=2,
                          units=128, num_heads=4, hidden_size=512),
                dtype=torch.bfloat16)
    else:
        m = Llama(LlamaConfig(vocab_size=97, max_length=64, num_layers=2,
                              units=128, num_heads=4, num_kv_heads=2,
                              hidden_size=256), dtype=torch.bfloat16)
    return m.initialize(0.15, seed=1)


def _card_case(fam, quant, B, T):
    m = _card_model(fam)
    pack = (P.pack_llama_weights(m.blocks, m._cfg, torch.bfloat16, quant)
            if fam == "llama" else
            P.pack_gpt_weights(m.blocks, torch.bfloat16, quant))
    act = None if fam == "llama" else "gelu"
    x, kh, vh = (torch.from_numpy(a).cuda().bfloat16()
                 for a in _step_inputs(m._cfg, B, T, torch.bfloat16))
    return m, pack, act, x, kh, vh


# (B, pos, T): T = 256 with pos 200 puts attention over several chunks
@pytest.mark.cuda
@pytest.mark.parametrize("B,pos,T", [(1, 0, 32), (3, 17, 32), (4, 31, 32),
                                     (4, 200, 256)])
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_kernel_matches_plain_on_card(fam, quant, B, pos, T):
    """K5 against decode_step_plain on the same card inputs: the output
    and the written column within four bf16 steps of their magnitude
    (the two sum in other orders and round to bf16 at every projection),
    the rest of the caches bit for bit."""
    need_cuda()
    m, pack, act, x, kh, vh = _card_case(fam, quant, B, T)
    kk, vk = kh.clone(), vh.clone()
    before = P.decode_step.launches
    got, _, _ = P.decode_step(pos, x, pack, kk, vk, m._cfg, act, 1e-5)
    ref, kr, vr = P.decode_step_plain(pos, x, pack, kh.clone(), vh.clone(),
                                      m._cfg, act, 1e-5)
    torch.cuda.synchronize()
    assert P.decode_step.launches == before + 1
    if T > 32:
        assert P.decode_step.last_plan["nc"] > 1      # several chunks
    for a, b in ((got, ref), (kk[:, :, :, pos], kr[:, :, :, pos]),
                 (vk[:, :, :, pos], vr[:, :, :, pos])):
        tol = 4 * 2.0 ** -8 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol
    rest = torch.ones(T, dtype=torch.bool, device="cuda")
    rest[pos] = False
    assert torch.equal(kk[:, :, :, rest], kh[:, :, :, rest])
    assert torch.equal(vk[:, :, :, rest], vh[:, :, :, rest])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_kernel_repeats_bit_for_bit_on_card(fam, quant):
    """Two launches on the same inputs agree exactly, x and the written
    column: every partial is summed in a fixed order."""
    need_cuda()
    m, pack, act, x, kh, vh = _card_case(fam, quant, 3, 256)
    outs = []
    for _ in range(2):
        kk, vk = kh.clone(), vh.clone()
        got = P.decode_step(150, x, pack, kk, vk, m._cfg, act, 1e-5)[0]
        outs.append((got, kk[:, :, :, 150], vk[:, :, :, 150]))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pos,keep", [(20, True), (50, False)])
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_kernel_with_more_pairs_than_blocks_on_card(quant, pos, keep):
    """128 KV heads at B=4 give 512 (batch row, KV head) pairs, more than
    the grid's blocks: a block keeps the scores of two items (pos 20), or
    past half the cache recomputes them in the second pass (pos 50); the
    output and the written column within four bf16 steps of the plain
    version, a second launch bit for bit."""
    need_cuda()
    from mxnet_tpu_torch.models import GPT, GPTConfig

    m = GPT(GPTConfig(vocab_size=97, max_length=64, num_layers=1,
                      units=1024, num_heads=128, hidden_size=2048),
            dtype=torch.bfloat16).initialize(0.05, seed=1)
    pack = P.pack_gpt_weights(m.blocks, torch.bfloat16, quant)
    x, kh, vh = (torch.from_numpy(a).cuda().bfloat16()
                 for a in _step_inputs(m._cfg, 4, 64, torch.bfloat16))
    outs = []
    for _ in range(2):
        kk, vk = kh.clone(), vh.clone()
        got = P.decode_step(pos, x, pack, kk, vk, m._cfg, "gelu", 1e-5)[0]
        outs.append((got, kk[:, :, :, pos], vk[:, :, :, pos]))
    assert P.decode_step.grid < 4 * 128
    assert P.decode_step.last_plan["keep"] == keep
    kr, vr = kh.clone(), vh.clone()
    ref, _, _ = P.decode_step_plain(pos, x, pack, kr, vr, m._cfg, "gelu",
                                    1e-5)
    torch.cuda.synchronize()
    for a, b in zip(outs[0], (ref, kr[:, :, :, pos], vr[:, :, :, pos])):
        tol = 4 * 2.0 ** -8 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("fam,f", [("gpt", 512), ("llama", 256),
                                   ("gpt", 4096)])
def test_kernel_in_its_least_layout_on_card(monkeypatch, fam, f, quant):
    """The layout the widest configurations take: the column phases read
    their prelude rows where they lie, the fc2/down span goes in an F
    slab a chunk (32 slabs with F = 4096), p.V takes one head a pass
    through one row; the output and the written column within four bf16
    steps of the plain version, the rest of the caches bit for bit."""
    need_cuda()
    from mxnet_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig

    if fam == "gpt":
        m = GPT(GPTConfig(vocab_size=97, max_length=64, num_layers=2,
                          units=128, num_heads=4, hidden_size=f),
                dtype=torch.bfloat16)
    else:
        m = Llama(LlamaConfig(vocab_size=97, max_length=64, num_layers=2,
                              units=128, num_heads=4, num_kv_heads=2,
                              hidden_size=f), dtype=torch.bfloat16)
    m = m.initialize(0.15, seed=1)
    cw = P._schedule(m._cfg)[0]
    full = P.layout
    monkeypatch.setattr(P, "layout", lambda *a: dict(
        full(*a), stage=False, s_row=f // cw, gm=1, pv_rows=1))
    pack = (P.pack_llama_weights(m.blocks, m._cfg, torch.bfloat16, quant)
            if fam == "llama" else
            P.pack_gpt_weights(m.blocks, torch.bfloat16, quant))
    act = None if fam == "llama" else "gelu"
    x, kh, vh = (torch.from_numpy(a).cuda().bfloat16()
                 for a in _step_inputs(m._cfg, 3, 256, torch.bfloat16))
    kk, vk, kr, vr = kh.clone(), vh.clone(), kh.clone(), vh.clone()
    got, _, _ = P.decode_step(200, x, pack, kk, vk, m._cfg, act, 1e-5)
    pl = P.decode_step.last_plan
    assert not pl["stage"] and pl["pv_rows"] == pl["gm"] == 1
    assert pl["s_row"] == f // cw and pl["nc"] > 1
    ref, _, _ = P.decode_step_plain(200, x, pack, kr, vr, m._cfg, act,
                                    1e-5)
    torch.cuda.synchronize()
    for a, b in ((got, ref), (kk[:, :, :, 200], kr[:, :, :, 200]),
                 (vk[:, :, :, 200], vr[:, :, :, 200])):
        tol = 4 * 2.0 ** -8 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol
    rest = torch.ones(256, dtype=torch.bool, device="cuda")
    rest[200] = False
    assert torch.equal(kk[:, :, :, rest], kh[:, :, :, rest])
    assert torch.equal(vk[:, :, :, rest], vh[:, :, :, rest])


@pytest.mark.cuda
def test_kernel_refuses_f32_on_card():
    need_cuda()
    m = _card_model("gpt").float()
    pack = P.pack_gpt_weights(m.blocks, torch.float32)
    x = torch.zeros(1, 128, device="cuda")
    kh = torch.zeros(2, 1, 4, 8, 32, device="cuda")
    with pytest.raises(MXNetError, match="bf16"):
        P.decode_step(0, x, pack, kh, kh.clone(), m._cfg, "gelu", 1e-5)
