"""The PyTorch port's int8 KV pages against the JAX package: the page
primitives (``_kv_dequant``, ``_kv_requant`` and the step, chunk and
verify page rewrites) on the same seeded inputs, codes equal and scales
equal bit for bit; ``_DecodeEngine.pool_verify_paged`` against the
reference's on the same pool and drafts (f32, GPT and Llama, native and
int8 weights, native and int8 pages), logits within 1e-5 (the chunk
test's tolerance, ``tests/test_torch_serve_paged.py``), the pages after it
within 1e-5 (native) or one code and 1e-6 of the scale (int8); and the
reference's ``TestKVQuantPages`` cases on the port's server (the env
knob, the representation bound, a recycled page's scale reset by each
admission path).  Speculation is held in
``tests/test_torch_serve_spec.py``."""
import numpy as onp
import pytest
import torch

from _torch_parity import jax_gpt, jax_llama, port_gpt, port_llama
from mxnet_tpu_torch.base import MXNetError

T = 64
PAGE = 16
CASES = [(f, w, kv) for f in ("llama", "gpt") for w in ("native", "int8")
         for kv in ("native", "int8")]


def _prompt(seed, n):
    return onp.random.RandomState(seed).randint(0, 97, (n,))


def _drain(srv):
    while srv.pump():
        pass


@pytest.fixture(scope="module")
def nets():
    out = {}
    for family, make, port in (("llama", jax_llama, port_llama),
                               ("gpt", jax_gpt, port_gpt)):
        net = make()
        out[family] = (net, port(net))
    return out


# --------------------------------------------------------------------- #
# (a) the page primitives
# --------------------------------------------------------------------- #

def _pages(seed, NL=2, NP=6, KV=2, D=8):
    """Seeded int8 pool contents, one page of zeros (scale 0) and one
    whose scale sits above its range; the port's pool has the trash page
    on top."""
    rs = onp.random.RandomState(seed)
    codes = rs.randint(-127, 128, (NL, NP, KV, PAGE, D)).astype(onp.int8)
    scales = (rs.rand(NL, NP, KV) * 0.05 + 0.01).astype(onp.float32)
    codes[:, 1] = 0
    scales[:, 1] = 0.0
    scales[:, 4] *= 7.0
    return codes, scales


def _port_pool(codes, scales):
    c = torch.zeros((codes.shape[0], codes.shape[1] + 1) + codes.shape[2:],
                    dtype=torch.int8)
    s = torch.zeros(scales.shape[:1] + (scales.shape[1] + 1,) +
                    scales.shape[2:])
    c[:, :-1] = torch.from_numpy(codes)
    s[:, :-1] = torch.from_numpy(scales)
    # stale contents in the trash page: a sentinel entry must read zeros
    c[:, -1] = 5
    s[:, -1] = 3.0
    return c, s


def _same_pool(pool, ref):
    codes, scales = pool
    rc, rs = (onp.asarray(a) for a in ref)
    NP = rc.shape[1]
    assert onp.array_equal(codes[:, :NP].numpy(), rc)
    assert onp.array_equal(scales[:, :NP].numpy().view(onp.uint32),
                           rs.view(onp.uint32))


def test_requant_and_dequant_bit_for_bit():
    import jax.numpy as jnp
    from mxnet_tpu.models import decoding as jd
    from mxnet_tpu_torch.models import decoding as td

    rs = onp.random.RandomState(0)
    vals = (rs.randn(2, 5, 3, PAGE, 8) *
            rs.choice([1e-3, 1.0, 40.0], (2, 5, 3, 1, 1))).astype(onp.float32)
    vals[0, 0] = 0.0                            # an all-zero page
    amax = onp.abs(vals).max(axis=(-2, -1))
    floors = [0.0,
              # above amax / 127 on half the pages, zero on some
              onp.where(rs.rand(2, 5, 3) < 0.5, amax / 60.0,
                        0.0).astype(onp.float32)]
    for floor in floors:
        rc, rsc = jd._kv_requant(jnp.asarray(vals), jnp.asarray(floor)
                                 if isinstance(floor, onp.ndarray) else floor)
        c, s = td._kv_requant(torch.from_numpy(vals),
                              torch.from_numpy(floor)
                              if isinstance(floor, onp.ndarray) else floor)
        assert c.dtype == torch.int8 and s.dtype == torch.float32
        assert onp.array_equal(c.numpy(), onp.asarray(rc))
        assert onp.array_equal(s.numpy().view(onp.uint32),
                               onp.asarray(rsc).view(onp.uint32))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = td._kv_dequant(c, s, dt).float().numpy()
            ref = onp.asarray(jd._kv_dequant(rc, rsc, jdt)
                              .astype(jnp.float32))
            assert onp.array_equal(got, ref)


def test_requant_roundtrip_bound_and_drift_free():
    """The reference's representation pins, on the port: dequantized
    values within amax / 254 of the written ones, a requantization at
    the page's own scale reproduces codes and scales bit for bit, and a
    larger floor wins."""
    from mxnet_tpu_torch.models.decoding import _kv_dequant, _kv_requant

    vals = torch.from_numpy(onp.random.RandomState(0).randn(2, 4, 16, 8)
                            .astype("float32"))
    codes, scales = _kv_requant(vals, 0.0)
    deq = _kv_dequant(codes, scales, torch.float32)
    amax = vals.abs().amax(dim=(-2, -1))
    err = (deq - vals).abs().amax(dim=(-2, -1))
    assert bool((err <= amax / 254.0 * (1 + 1e-5)).all())
    codes2, scales2 = _kv_requant(deq, scales)
    assert torch.equal(codes, codes2) and torch.equal(scales, scales2)
    _, s_up = _kv_requant(deq, scales * 2)
    assert torch.allclose(s_up, scales * 2)


def test_step_rmw_bit_for_bit():
    import jax.numpy as jnp
    from mxnet_tpu.models import decoding as jd
    from mxnet_tpu_torch.models import decoding as td

    codes, scales = _pages(1)
    NL, NP, KV, _, D = codes.shape
    rs = onp.random.RandomState(2)
    pg = onp.array([3, 1, NP, 4, 0])            # NP: the sentinel
    offs = onp.array([5, 0, 7, 15, 9])
    # rows 0 and 4 raise their page's range, row 3 stays under its floor
    newcol = (rs.randn(5, NL, KV, D) *
              onp.array([9.0, 1.0, 1.0, 0.01, 6.0])[:, None, None, None]
              ).astype(onp.float32)
    ref = jd._kv_step_rmw((jnp.asarray(codes), jnp.asarray(scales)),
                          jnp.asarray(pg), jnp.arange(5), jnp.asarray(offs),
                          jnp.asarray(newcol))
    pool = _port_pool(codes, scales)
    td._kv_step_rmw(pool, torch.as_tensor(pg), torch.arange(5),
                    torch.as_tensor(offs), torch.from_numpy(newcol))
    _same_pool(pool, ref)


def test_chunk_rmw_bit_for_bit():
    import jax.numpy as jnp
    from mxnet_tpu.models import decoding as jd
    from mxnet_tpu_torch.models import decoding as td

    codes, scales = _pages(3)
    NL, NP, KV, _, D = codes.shape
    C, ntp = 20, (20 + PAGE - 2) // PAGE + 1      # 3 window pages
    wpgs = onp.array([4, 1, NP])
    off0 = 9                                   # window-local start
    loc = off0 + onp.arange(C)
    loc[17:] = ntp * PAGE                       # padded tail: dropped
    new = (onp.random.RandomState(4).randn(NL, KV, C, D) * 3.0) \
        .astype(onp.float32)
    ref = jd._kv_chunk_rmw((jnp.asarray(codes), jnp.asarray(scales)),
                           jnp.asarray(wpgs), jnp.asarray(loc),
                           jnp.asarray(new), PAGE, ntp)
    pool = _port_pool(codes, scales)
    td._kv_chunk_rmw(pool, torch.as_tensor(wpgs), torch.as_tensor(loc),
                     torch.from_numpy(new), PAGE, ntp)
    _same_pool(pool, ref)


def test_verify_rmw_bit_for_bit():
    import jax.numpy as jnp
    from mxnet_tpu.models import decoding as jd
    from mxnet_tpu_torch.models import decoding as td

    codes, scales = _pages(5, NP=8)
    NL, NP, KV, _, D = codes.shape
    C = 5
    ntp = (C + PAGE - 2) // PAGE + 1
    wpgs = onp.array([[2, 5], [1, NP], [NP, NP]])   # slot 2: retired
    loc = onp.array([[13, 14, 15, 16, 17], [0, 1, 2, 3, 4],
                     [3, 4, ntp * PAGE, ntp * PAGE, ntp * PAGE]])
    new = (onp.random.RandomState(6).randn(3, C, NL, KV, D) *
           onp.array([4.0, 0.5, 1.0])[:, None, None, None, None]) \
        .astype(onp.float32)
    ref = jd._kv_verify_rmw((jnp.asarray(codes), jnp.asarray(scales)),
                            jnp.asarray(wpgs), jnp.arange(3),
                            jnp.asarray(loc), jnp.asarray(new), PAGE, ntp)
    pool = _port_pool(codes, scales)
    td._kv_verify_rmw(pool, torch.as_tensor(wpgs), torch.arange(3),
                      torch.as_tensor(loc), torch.from_numpy(new), PAGE, ntp)
    _same_pool(pool, ref)


# --------------------------------------------------------------------- #
# (b) pool_verify_paged against the reference's
# --------------------------------------------------------------------- #

# three slots: a block across a page boundary, one from a page start,
# one whose last columns pass the cache horizon (they must drop)
ROWS = [[5, 2, 9, 12], [0, 7, 3, 11], [4, 1, 6, 8]]
POS = [13, 32, 61]


def _verify_pools(NL, KV, D, quant, seed):
    """Seeded pool contents for both packages (int8: random codes and
    positive scales, a zero-scale page among them)."""
    rs = onp.random.RandomState(seed)
    shape = (NL, 12, KV, PAGE, D)
    if quant:
        out = []
        for _ in range(2):
            c = rs.randint(-127, 128, shape).astype(onp.int8)
            s = (rs.rand(NL, 12, KV) * 0.02 + 0.005).astype(onp.float32)
            s[:, 11] = 0.0
            out.append((c, s))
        return out
    return [rs.standard_normal(shape).astype(onp.float32) * 0.5
            for _ in range(2)]


@pytest.mark.parametrize("family,weights,kv", CASES)
def test_pool_verify_paged_matches_reference(nets, family, weights, kv):
    import jax.numpy as jnp
    from mxnet_tpu.gluon.parameter import params_swapped
    from mxnet_tpu.serve import engine as jeng
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    net, model = nets[family]
    jp = jeng.PoolPrograms(net, 3, T, 0.0, 0, None, weights, page_size=PAGE,
                           kv_dtype=kv)
    param_vals, q8, sw = jp.operands
    eng = _DecodeEngine(model, 0.0, 0, weights)
    quant = kv == "int8"
    pools = _verify_pools(eng.NL, eng.KV, eng.D, quant, 11)
    rs = onp.random.RandomState(12)
    toks = rs.randint(0, 97, (3, 5))
    pt = onp.asarray(ROWS)
    pos = onp.asarray(POS)
    jpools = [tuple(jnp.asarray(a) for a in p) if quant else jnp.asarray(p)
              for p in pools]
    with params_swapped(jp.eng.params, param_vals):
        rlog, rk, rv = jp.eng.pool_verify_paged(
            jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(pt, jnp.int32), PAGE, jpools[0], jpools[1], sw, q8)
    tpools = [_port_pool(*p) if quant else
              torch.cat([torch.from_numpy(p), torch.full(
                  (p.shape[0], 1) + p.shape[2:], 7.0)], 1) for p in pools]
    got = eng.pool_verify_paged(torch.as_tensor(toks), torch.as_tensor(pos),
                                tpools[0], tpools[1], torch.as_tensor(pt),
                                PAGE)
    assert got.shape == (3, 5, 97) and got.dtype == torch.float32
    # columns past the horizon are never accepted (the reference's GPT
    # reads its position table out of range there: NaN)
    inside = pos[:, None] + onp.arange(5) < T
    onp.testing.assert_allclose(got.numpy()[inside],
                                onp.asarray(rlog)[inside], rtol=1e-5,
                                atol=1e-5)
    assert bool(torch.isfinite(got).all())
    for mine, ref, before in zip(tpools, (rk, rv), pools):
        if quant:
            rc, rsc = (onp.asarray(a) for a in ref)
            c, s = (a[:, :12].numpy() for a in mine)
            assert onp.abs(c.astype(onp.int32) - rc).max() <= 1
            onp.testing.assert_allclose(s, rsc, rtol=1e-6, atol=0)
            assert onp.any(c != before[0])      # the block was written
        else:
            onp.testing.assert_allclose(mine[:, :12].numpy(),
                                        onp.asarray(ref), rtol=1e-5,
                                        atol=1e-5)


# --------------------------------------------------------------------- #
# (d) the reference's TestKVQuantPages cases on the port's server
# --------------------------------------------------------------------- #

def _agree(got, ref):
    return sum(int(a == b) for a, b in zip(got, ref)) / len(ref)


def _kv(model, p, n):
    from mxnet_tpu_torch.models import kv_generate

    return list(kv_generate(model, p[None], n, temperature=0.0)[0, p.size:])


def test_kv_dtype_env_knob_and_validation(nets, monkeypatch):
    """``MXNET_SERVE_KV_DTYPE`` selects the pages' storage, the argument
    wins over it, a bad value names the variable; an int8 page is
    priced as its codes and scales, less than half a native one here
    (f32)."""
    from mxnet_tpu_torch.serve import DecodeServer
    from mxnet_tpu_torch.serve.engine import kv_page_int8_bytes
    from mxnet_tpu_torch.serve.schema import slot_state_bytes

    model = nets["gpt"][1]
    monkeypatch.setenv("MXNET_SERVE_KV_DTYPE", "int8")
    srv = DecodeServer(model, max_total_len=T, pool_sizes=(2,),
                       autostart=False)
    st = srv.stats()
    assert srv.kv_dtype == "int8" and st["kv_dtype"] == "int8"
    assert st["page_bytes"] == kv_page_int8_bytes(2, 4, PAGE, 8) == \
        2 * 2 * 4 * (PAGE * 8 + 4)
    # the state's bytes: the pages (trash page included) and each slot's
    # columns, as the reference counts them (``nbytes_of`` the state)
    assert st["pool_bytes"] == (st["pages_total"] + 1) * st["page_bytes"] \
        + st["num_slots"] * slot_state_bytes()
    p = _prompt(220, 6)
    s = srv.submit(p, max_new_tokens=8)
    _drain(srv)
    assert _agree(s.tokens(5), _kv(model, p, 8)) >= 0.9
    srv.close()
    srv = DecodeServer(model, max_total_len=T, pool_sizes=(2,),
                       kv_dtype="f32", autostart=False)
    assert srv.kv_dtype == "native"
    assert srv.stats()["page_bytes"] > 2 * st["page_bytes"]
    srv.close()
    monkeypatch.setenv("MXNET_SERVE_KV_DTYPE", "int4")
    with pytest.raises(MXNetError, match="KV_DTYPE"):
        DecodeServer(model, max_total_len=T, autostart=False)
    monkeypatch.delenv("MXNET_SERVE_KV_DTYPE")
    with pytest.raises(MXNetError, match="kv_dtype"):
        DecodeServer(model, max_total_len=T, kv_dtype="fp8",
                     autostart=False)


def _scales(srv):
    return (srv._state["kp"][1].clone(), srv._state["vp"][1].clone())


def _dirty(srv, n=4):
    ks, _ = _scales(srv)
    return {p for p in range(n) if bool((ks[:, p] != 0).any())}


def test_recycled_pages_reset_on_admit(nets):
    """Tenant A dirties pages and retires (its pages go back to the free
    list with their scales); tenant B reserves the whole pool: the
    admission zeroes the scales of its decode-frontier pages before
    anything writes them."""
    from mxnet_tpu_torch.serve import DecodeServer

    model = nets["gpt"][1]
    srv = DecodeServer(model, max_total_len=T, pool_sizes=(1,),
                       prefill_buckets=(8, 16), kv_dtype="int8",
                       spec=False, autostart=False)
    sa = srv.submit(_prompt(230, 14), max_new_tokens=18)
    _drain(srv)
    assert sa.tokens(5)
    dirty = _dirty(srv)
    assert dirty and dirty <= set(srv._pages._free)
    pb = _prompt(231, 6)
    sb = srv.submit(pb, max_new_tokens=58)
    assert srv.pump()
    row = srv._slot_pages[0]
    assert len(row) == 4 and set(row[1:]) & dirty, (row, dirty)
    ks, vs = _scales(srv)
    assert bool((ks[:, row[1:]] == 0).all()) and \
        bool((vs[:, row[1:]] == 0).all())
    assert bool((ks[:, row[0]] > 0).all())
    _drain(srv)
    assert _agree(sb.tokens(5), _kv(model, pb, 58)) >= 0.9
    srv.close()


def test_recycled_pages_reset_on_prefix_hit(nets):
    """A full hit with one copy-on-write page: the copy's destination
    gets the source's scale, the fresh decode-frontier page a zero one."""
    from mxnet_tpu_torch.serve import DecodeServer

    model = nets["gpt"][1]
    srv = DecodeServer(model, max_total_len=T, pool_sizes=(1,),
                       prefill_buckets=(8, 16), kv_dtype="int8",
                       spec=False, autostart=False)
    p = _prompt(232, 16)
    sa = srv.submit(p, max_new_tokens=32)
    _drain(srv)
    assert sa.tokens(5)
    dirty = _dirty(srv)
    sb = srv.submit(p, max_new_tokens=16)
    assert srv.pump()
    assert srv.counters["prefix_hits"] >= 1 and srv.counters["cow_copies"] >= 1
    row = srv._slot_pages[0]
    assert len(row) == 2 and set(row[1:]) & dirty, (row, dirty)
    ks, vs = _scales(srv)
    assert bool((ks[:, row[0]] > 0).all())
    assert bool((ks[:, row[1]] == 0).all()) and \
        bool((vs[:, row[1]] == 0).all())
    _drain(srv)
    assert _agree(sb.tokens(5), _kv(model, p, 16)) >= 0.9
    srv.close()


def test_recycled_pages_reset_on_chunked_prefill(nets):
    """The first chunk's dispatch zeroes the scales of every page the
    slot reserved; the pages past its window keep zero scales."""
    from mxnet_tpu_torch.serve import DecodeServer

    model = nets["gpt"][1]
    srv = DecodeServer(model, max_total_len=T, pool_sizes=(1,),
                       prefill_buckets=(8, 16), kv_dtype="int8",
                       spec=False, autostart=False)
    pa = _prompt(233, 30)
    srv.submit(pa, max_new_tokens=18)
    _drain(srv)
    dirty = _dirty(srv)
    pb = _prompt(234, 24)
    pb[0] = (pa[0] + 1) % 97                    # no prefix match
    sb = srv.submit(pb, max_new_tokens=40)
    assert srv.pump()                           # the first chunk only
    row = srv._slot_pages[0]
    assert len(row) == 4 and set(row[2:]) & dirty, (row, dirty)
    ks, vs = _scales(srv)
    assert bool((ks[:, row[2:]] == 0).all()) and \
        bool((vs[:, row[2:]] == 0).all())
    assert bool((ks[:, row[0]] > 0).all())
    _drain(srv)
    assert srv.counters["chunk_dispatches"] >= 2
    assert _agree(sb.tokens(5), _kv(model, pb, 40)) >= 0.9
    srv.close()


def test_pool_growth_moves_the_trash_page_with_the_scales(nets):
    """Growth pads codes and scales alike: the old pages keep their
    contents, the new ones and the trash page at the new end are zero."""
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve.engine import (PoolPrograms, pool_state_grow,
                                              pool_state_init)

    progs = PoolPrograms(_DecodeEngine(nets["llama"][1]), 1, T, PAGE,
                         kv_dtype="int8")
    state = pool_state_init(progs)
    for name in ("kp", "vp"):
        state[name][0].random_(-127, 128)
        state[name][1].uniform_(0.1, 1.0)
    grown = pool_state_grow(state, 2, 8)
    for name in ("kp", "vp"):
        for old, new in zip(state[name], grown[name]):
            assert new.shape[1] == 9 and new.dtype == old.dtype
            assert torch.equal(new[:, :4], old[:, :4])
            assert not bool(new[:, 4:].any())
    assert grown["spec"].shape == (2,)
