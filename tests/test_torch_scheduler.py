"""The port's served decode against the reference's, on the CPU.

Per-row decode lengths, the three forms of ``cache["len"]``, the decode
step's device body, ``PagedKVAllocator``, the continuous-batching server
and ``launch.serve --continuous``, each on the same numpy weights in both
packages (``bridge.params_from_numpy``).  Tolerances: generated tokens and
``ServerStats`` are equal; fp32 logits and caches against the reference
agree to 1e-5 (both compute fp32 expressions that differ only in
summation order); the port's tensor-length paths equal its int path bit
for bit (the same ops on the same values).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jlaunch
from repro.models import model as jm
from repro.serve import kv_cache as jkv
from repro.serve.paged_cache import PagedKVAllocator as JAlloc
from repro.serve.scheduler import ContinuousBatchingServer as JCB
from repro.serve.serve_step import Request as JRequest
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import serve_step as tss
from repro_torch.serve.paged_cache import PagedKVAllocator as TAlloc
from repro_torch.serve.scheduler import ContinuousBatchingServer as TCB
from repro_torch.serve.serve_step import Request as TRequest
from test_torch_model import both_params, configs, numpy_params
from test_torch_train import _HostSyncGuard

TOL = 1e-5


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _prefilled(arch, seed, b, plen, max_len):
    """Both packages' params and a prefilled cache grown to ``max_len``."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (b, plen))
    _, jc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       return_cache=True)
    _, tc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       return_cache=True)
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, b, max_len))
    tc = tkv.grow_cache(tc, tm.init_cache(tcfg, b, max_len, device="cpu"))
    return (jcfg, jp, jc), (tcfg, tp, tc)


# --- decode with per-row and device lengths ----------------------------------------

def test_decode_per_row_len_matches_scalar():
    """The counterpart of the reference's test of the same name, held
    against the reference: (B,) lengths all at the same position give
    the scalar path's logits and cache, in both packages."""
    (jcfg, jp, jc), (tcfg, tp, tc) = _prefilled("qwen1_5_0_5b", 2, 2, 8, 32)
    nxt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 1))
    jl, jc1 = jm.decode(jcfg, jp, dict(jc, len=jnp.full((2,), 8, jnp.int32)),
                        jnp.asarray(nxt))
    tl, tc1 = tm.decode(tcfg, tp, dict(tc, len=torch.full((2,), 8)),
                        torch.from_numpy(nxt))
    sl, sc = tm.decode(tcfg, tp, tkv.grow_cache(
        tc, tm.init_cache(tcfg, 2, 32, device="cpu")), torch.from_numpy(nxt))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tl), _np(sl), rtol=0, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc1[name]), _np(jc1[name]), rtol=0,
                                   atol=TOL)
    assert tc1["len"].tolist() == np.asarray(jc1["len"]).tolist() == [9, 9]


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_0_5b"])
def test_decode_rows_at_different_positions_match_reference(arch):
    """(B,) lengths 8, 3 and 6 over 3 steps: logits, cache and lengths."""
    (jcfg, jp, jc), (tcfg, tp, tc) = _prefilled(arch, 3, 3, 8, 16)
    lens = np.array([8, 3, 6])
    jc["len"], tc["len"] = jnp.asarray(lens, jnp.int32), torch.from_numpy(lens)
    rng = np.random.default_rng(3)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (3, 1))
        jl, jc = jm.decode(jcfg, jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode(tcfg, tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=TOL)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [11, 6, 9]


@pytest.mark.parametrize("form", ["0-d", "(B,)"])
def test_decode_tensor_lengths_equal_the_int_path(form):
    _, (cfg, params, cache) = _prefilled("smollm_360m", 4, 3, 9, 16)
    nxt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 1)))
    fresh = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in cache.items()}
    want, wc = tm.decode(cfg, params, cache, nxt)
    fresh["len"] = torch.tensor(9) if form == "0-d" \
        else torch.full((3,), 9)
    k_before = fresh["k"]
    got, gc = tm.decode(cfg, params, fresh, nxt)
    assert torch.equal(got, want)
    assert gc["k"] is k_before                          # written in place
    assert torch.equal(gc["k"], wc["k"]) and torch.equal(gc["v"], wc["v"])
    assert wc["len"] == 10 and gc["len"].tolist() == (
        10 if form == "0-d" else [10, 10, 10])


@pytest.mark.parametrize("form", ["0-d", "(B,)"])
def test_decode_with_a_tensor_length_makes_no_host_sync(form):
    """What a CUDA graph capture cannot hold (``_HostSyncGuard``: host
    reads, value-dependent shapes, copies to the CPU) is absent from the
    tensor-length decode."""
    _, (cfg, params, cache) = _prefilled("smollm_360m", 5, 2, 5, 8)
    cache["len"] = torch.tensor(5) if form == "0-d" \
        else torch.tensor([5, 3])
    nxt = torch.zeros(2, 1, dtype=torch.long)
    with _HostSyncGuard():
        logits, out = tm.decode(cfg, params, cache, nxt)
    assert torch.isfinite(logits).all()


# --- the decode step's device body -------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True])
def test_decode_on_device_equals_make_decode(per_row):
    """The served step's body on prefix views of a static state: the logits
    of ``make_decode`` bit for bit, the new K/V rows in the state's own
    buffers, ``len + 1`` and the greedy tokens written in place; the rows
    past the prefix untouched."""
    _, (cfg, params, cache) = _prefilled("smollm_360m", 6, 2, 7, 16)
    nxt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 1)))
    state = tss.decode_state(cfg, 4, 16, per_row=per_row, device="cpu")
    state["k"][:, 2:].normal_()
    rest = state["k"][:, 2:].clone()
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    view = tss.rows_of(state, 2)
    tkv.grow_cache(cache, {"k": view["k"], "v": view["v"]})
    view["len"].fill_(7)
    view["cur"].copy_(nxt)
    want, wc = tss.make_decode(cfg)(params, cache, nxt)
    with _HostSyncGuard():
        got = tss.decode_on_device(cfg, params, view)
    assert torch.equal(got, want)
    assert torch.equal(state["k"][:, :2], wc["k"])
    assert torch.equal(state["v"][:, :2], wc["v"])
    assert torch.equal(state["k"][:, 2:], rest)
    assert torch.equal(state["cur"][:2, 0], torch.argmax(want, -1))
    assert view["len"].tolist() == ([8, 8] if per_row else 8)
    assert {k: v.data_ptr() for k, v in state.items()} == ptrs


def test_graphed_steps_refuse_cpu_params():
    _, cfg = configs("smollm_360m")
    params = tm.init(cfg, 0, device="cpu")
    state = tss.decode_state(cfg, 2, 8, per_row=False, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tss.GraphedDecodeStep(cfg, params, state)
    for by_row in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            tss.GraphedPrefill(cfg, params, state, by_row=by_row)
    with pytest.raises(ValueError, match="graphed=True"):
        tss.BatchedServer(cfg, params, max_len=16, batch_size=2,
                          graphed=True)
    with pytest.raises(ValueError, match="graphed=True"):
        TCB(cfg, params, max_slots=2, max_ctx=16, graphed=True)
    for server in (tss.BatchedServer(cfg, params, max_len=16, batch_size=2),
                   TCB(cfg, params, max_slots=2, max_ctx=16)):
        assert server.graphed is False and server.decode_graph is None
        assert server.prefill_graph is None


def test_batched_server_keeps_one_static_cache():
    """Prefill into the prefix, compaction and decode in place: the state's
    buffers are the same storage after two batches, and the tokens equal
    a server made anew for each batch."""
    _, cfg = configs("smollm_360m")
    params = tm.init(cfg, 1, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(4, 9, 6)]
    max_new = [9, 2, 2, 3, 5, 1]
    server = tss.BatchedServer(cfg, params, max_len=24, batch_size=3)
    ptrs = {k: v.data_ptr() for k, v in server.state.items()}
    got = server.run([TRequest(i, p, m) for i, (p, m)
                      in enumerate(zip(prompts, max_new))])
    assert {k: v.data_ptr() for k, v in server.state.items()} == ptrs
    for i in (0, 3):
        alone = [TRequest(j, prompts[j], max_new[j]) for j in range(i, i + 3)]
        tss.BatchedServer(cfg, params, max_len=24, batch_size=3).run(alone)
        assert [r.output for r in alone] == [r.output for r in got[i:i + 3]]
    with pytest.raises(ValueError, match="write past"):
        server.run([TRequest(0, prompts[0][:8], 18)])


# --- the served prefill's device body ---------------------------------------------
# ``prefill_on_device`` writes a prefill into rows of a static decode state:
# by a device row index (the continuous server) against the reference's
# ``_write_row``, into the prefix (the static server) against its
# ``grow_cache``, both at 1e-5; against the port's own make_prefill + row
# write bit for bit.

def _prompt(rng, vocab, plen, bucket):
    toks = np.zeros((1, bucket), np.int64)
    toks[0, bucket - plen:] = rng.integers(0, vocab, plen)
    return toks


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_0_5b"])
def test_prefill_on_device_by_row_matches_reference_write_row(arch):
    """Three prefills into a 4-row state: bucket 16 into row 2, bucket 8
    into row 0, then bucket 4 into row 2 again (a re-admitted row that held
    a longer request: its slots past 4 keep the old K/V, as the
    reference's ``dynamic_update_slice`` leaves them).  After each, the
    whole cache, every row's length and the first token."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, 10)
    js = JCB(jcfg, jp, max_slots=4, max_ctx=32)
    state = tss.decode_state(tcfg, 4, 32, per_row=True, device="cpu")
    rng = np.random.default_rng(10)
    for row, plen, bucket in ((2, 13, 16), (0, 5, 8), (2, 3, 4)):
        toks = _prompt(rng, jcfg.vocab_size, plen, bucket)
        jl, pcache = js._prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
        js._write_row(row, pcache, bucket)
        got = tss.prefill_on_device(tcfg, tp, state, torch.from_numpy(toks),
                                    torch.tensor([row]))
        np.testing.assert_allclose(_np(got), _np(jl), rtol=0, atol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(state[name]), _np(js.cache[name]),
                                       rtol=0, atol=TOL)
        assert state["len"].tolist() == js.len_np.tolist()
        assert int(state["cur"][row, 0]) == int(jnp.argmax(jl[0]))
    assert state["len"].tolist() == [8, 1, 4, 1]
    assert torch.all(state["k"][:, 2, 4:16] != 0)      # the longer request's
    assert torch.all(state["k"][:, :, 16:] == 0)


def test_prefill_on_device_prefix_matches_reference_grow_cache():
    """The static server's prefill: 3 left-padded prompts into the prefix
    of a 4-row state, against the reference's prefill grown into a
    ``max_len`` cache; row 3 untouched."""
    jcfg, tcfg = configs("qwen1_5_0_5b")
    jp, tp = both_params(jcfg, tcfg, 11)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (3, 9))
    toks[1, :4] = toks[2, :2] = 0
    jl, jc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        return_cache=True)
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, 3, 24))
    state = tss.decode_state(tcfg, 4, 24, per_row=False, device="cpu")
    state["k"][:, 3].fill_(7.0)
    got = tss.prefill_on_device(tcfg, tp, state, torch.from_numpy(toks), 3)
    np.testing.assert_allclose(_np(got), _np(jl[:, -1]), rtol=0, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(state[name][:, :3]), _np(jc[name]),
                                   rtol=0, atol=TOL)
    assert torch.all(state["k"][:, 3] == 7.0) and torch.all(
        state["v"][:, 3] == 0)
    assert state["len"].tolist() == 9
    assert state["cur"][:3, 0].tolist() == np.asarray(
        jnp.argmax(jl[:, -1], axis=-1)).tolist()
    assert state["cur"][3, 0] == 0


def _old_prefill(cfg, params, state, toks, row):
    """The servers' eager prefill as it was: ``make_prefill``, then the
    cache written at ``row`` (or into the prefix, ``row`` None), the
    length set and the greedy token stored."""
    logits, cache = tss.make_prefill(cfg)(params, {"tokens": toks})
    first = torch.argmax(logits, dim=-1)[:, None]
    if row is None:
        view = tss.rows_of(state, toks.shape[0])
        tkv.grow_cache(cache, {"k": view["k"], "v": view["v"]})
        state["len"].fill_(toks.shape[1])
        state["cur"][:toks.shape[0]].copy_(first)
    else:
        n = cache["k"].shape[2]
        for key in ("k", "v"):
            state[key][:, row, :n] = cache[key][:, 0]
        state["len"][row] = toks.shape[1]
        state["cur"][row] = first[0]
    return logits


@pytest.mark.parametrize("by_row", [False, True])
def test_prefill_on_device_equals_the_eager_path(by_row):
    """Bit for bit against ``make_prefill`` and the row write it replaces,
    on a state whose rows already hold other values; the state's buffers
    keep their storage."""
    _, cfg = configs("smollm_360m")
    params = tm.init(cfg, 12, device="cpu")
    rng = np.random.default_rng(12)
    states = [tss.decode_state(cfg, 4, 16, per_row=by_row, device="cpu")
              for _ in range(2)]
    for key in ("k", "v"):
        states[0][key].normal_()
        states[1][key].copy_(states[0][key])
    ptrs = {k: v.data_ptr() for k, v in states[1].items()}
    shapes = ((1, 8), (1, 4), (1, 8)) if by_row else ((3, 7), (2, 11))
    for i, (b, s) in enumerate(shapes):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
        row = (3, 1, 1)[i] if by_row else None
        want = _old_prefill(cfg, params, states[0], toks, row)
        got = tss.prefill_on_device(cfg, params, states[1], toks,
                                    torch.tensor([row]) if by_row else b)
        assert torch.equal(got, want)
        for key in states[0]:
            assert torch.equal(states[1][key], states[0][key]), (i, key)
    assert {k: v.data_ptr() for k, v in states[1].items()} == ptrs


@pytest.mark.parametrize("by_row", [False, True])
def test_prefill_on_device_makes_no_host_sync(by_row):
    """Under ``_HostSyncGuard`` (no host read, no value-dependent shape,
    no copy to the CPU), on the kernel path too (the attention kernel and
    the fused norm run their plain versions on the CPU)."""
    _, cfg = configs("smollm_360m")
    params = tm.init(cfg, 13, device="cpu")
    state = tss.decode_state(cfg, 2, 16, per_row=by_row, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1 if by_row else 2, 8)))
    rows = torch.tensor([1]) if by_row else 2
    for impl in ("auto", "kernel"):
        kcfg = dataclasses.replace(cfg, attn_impl=impl)
        with _HostSyncGuard():
            logits = tss.prefill_on_device(kcfg, params, state, toks, rows)
        assert torch.isfinite(logits).all()


# --- PagedKVAllocator ---------------------------------------------------------------

def test_paged_allocator_matches_reference_call_for_call():
    calls = [("alloc", 0, 10), ("alloc", 1, 17), ("extend", 0, 16),
             ("extend", 0, 17), ("can_fit", None, 20), ("alloc", 2, 40),
             ("extend", 1, 33), ("release", 0, None), ("alloc", 2, 24),
             ("extend", 2, 64), ("pages_of", 1, None), ("release", 5, None),
             ("pages_needed", None, 0), ("release", 1, None),
             ("extend", 2, 48)]
    results = []
    for cls in (JAlloc, TAlloc):
        a, out = cls(12, 4), []
        for op, rid, n in calls:
            args = [x for x in (rid, n) if x is not None]
            out.append((getattr(a, op)(*args), a.used_pages, a.free_pages,
                        a.peak_used))
        results.append(out)
    assert results[0] == results[1]
    with pytest.raises(AssertionError):
        TAlloc(4, 0)


# --- the continuous-batching server ------------------------------------------------

def _serve_both(arch, seed, prompts, max_new, **kw):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed)
    jr = [JRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))]
    tr = [TRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))]
    js, ts = JCB(jcfg, jp, **kw), TCB(tcfg, tp, **kw)
    js.run(jr)
    ts.run(tr)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.alloc.peak_used == js.alloc.peak_used
    assert ts.live == [] and ts.alloc.used_pages == 0
    return tr, ts, (tcfg, tp)


def test_continuous_batching_matches_reference_and_teacher_forcing():
    prompt = np.random.default_rng(0).integers(0, 256, 8).astype(np.int32)
    tr, ts, (cfg, params) = _serve_both("smollm_360m", 0, [prompt], [6],
                                        max_slots=4, max_ctx=32)
    assert tr[0].done and len(tr[0].output) == 6
    toks, want = list(prompt), []
    for _ in range(6):
        logits = tm.forward(cfg, params, {"tokens": torch.tensor([toks])})
        want.append(int(torch.argmax(logits[0, -1])))
        toks.append(want[-1])
    assert tr[0].output == want


def test_continuous_batching_mid_stream_admission_matches_reference():
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, 8).astype(np.int32) for _ in range(6)]
    tr, ts, _ = _serve_both("qwen1_5_0_5b", 1, prompts, [24, 3, 3, 3, 3, 3],
                            max_slots=2, max_ctx=64)
    assert [len(r.output) for r in tr] == [24, 3, 3, 3, 3, 3]
    assert ts.stats.n_finished == 6 and ts.stats.prefill_calls == 6
    assert ts.stats.decode_steps < 30


def test_continuous_batching_preemption_matches_reference():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, 8).astype(np.int32) for _ in range(2)]
    tr, ts, (cfg, params) = _serve_both(
        "smollm_360m", 3, prompts, [12, 12], max_slots=2, max_ctx=32,
        page_size=4, total_pages=8)
    assert all(r.done and len(r.output) == 12 for r in tr)
    assert ts.stats.n_preempted >= 1
    redo = [TRequest(r.rid, r.prompt, 12) for r in tr]
    TCB(cfg, params, max_slots=2, max_ctx=32).run(redo)
    assert [r.output for r in redo] == [r.output for r in tr]


def test_continuous_batching_mixed_prompts_match_reference():
    """Prompts in four buckets, more requests than slots, uneven lengths:
    rows at different positions decode together in every bucket."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32)
               for n in (3, 9, 1, 16, 5, 12, 7)]
    tr, ts, _ = _serve_both("qwen1_5_0_5b", 4, prompts,
                            [5, 2, 7, 4, 1, 6, 3], max_slots=4, max_ctx=24)
    assert [len(r.output) for r in tr] == [5, 2, 7, 4, 1, 6, 3]


def test_continuous_batching_rejects_impossible_head_of_line():
    jcfg, tcfg = configs("smollm_360m")
    jp, tp = both_params(jcfg, tcfg, 0)
    prompt = np.arange(16, dtype=np.int32)
    for cls, req, p in ((JCB, JRequest, jp), (TCB, TRequest, tp)):
        srv = cls(jcfg if cls is JCB else tcfg, p, max_slots=2, max_ctx=32,
                  page_size=4, total_pages=2)
        with pytest.raises(RuntimeError, match="head-of-line"):
            srv.run([req(0, prompt, 4)])


def test_submit_refuses_a_bucket_that_writes_past_max_ctx():
    """R6: a 9-token prompt buckets to 16; with max_ctx 32, 17 new tokens
    (16 decode steps, the last at slot 31) fit and 18 do not.  The
    reference admits the second (and drops its last K/V row)."""
    jcfg, tcfg = configs("smollm_360m")
    jp, tp = both_params(jcfg, tcfg, 8)
    prompt = np.arange(9, dtype=np.int32)
    srv = TCB(tcfg, tp, max_slots=2, max_ctx=32)
    srv.submit(TRequest(0, prompt, 17))
    with pytest.raises(ValueError, match=r"bucket of 16 tokens and 17 "
                                         r"decode steps write past max_ctx 32"):
        srv.submit(TRequest(1, prompt, 18))
    with pytest.raises(ValueError, match="context budget"):
        srv.submit(TRequest(2, prompt, 24))
    JCB(jcfg, jp, max_slots=2, max_ctx=32).submit(JRequest(1, prompt, 18))
    assert len(srv.queue) == 1
    srv.run([])                    # the boundary case runs to its end
    assert srv.queue == [] and srv.stats.n_finished == 1
    assert srv.len_np.max() == 1 and srv.alloc.used_pages == 0
    assert tsched._next_pow2(9) == 16 and tsched._next_pow2(1) == 1


# --- launch.serve --continuous ------------------------------------------------------

_ARGS = ["--arch", "smollm_360m", "--reduced", "--requests", "3",
         "--prompt-len", "6", "--max-new", "4", "--batch-size", "2",
         "--continuous"]


def test_launch_serve_continuous_matches_reference(monkeypatch, capsys):
    """Both launchers on the same numpy weights (their own inits draw from
    different generators): the same sample tokens."""
    from repro.configs import get_config as jget
    from repro.train.checkpoint import _unflatten
    from repro_torch import bridge
    from repro_torch.configs import get_config as tget
    jcfg, tcfg = jget("smollm_360m").reduced(), tget("smollm_360m").reduced()
    flat = numpy_params(jcfg, 9)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype),
                           _unflatten(jm.decls(jcfg), flat))
    monkeypatch.setattr(jlaunch.model_lib, "init", lambda cfg, key: jparams)
    monkeypatch.setattr(tlaunch.model_lib, "init", lambda cfg, seed, device:
                        bridge.params_from_numpy(tcfg, flat, device=device))
    monkeypatch.setattr("sys.argv", ["serve"] + _ARGS)
    jlaunch.main()
    jout = capsys.readouterr().out
    tlaunch.main(_ARGS + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert "[serve:continuous:cpu] 3 requests, 12 tokens" in tout
    sample = re.compile(r"sample output: (\[.*\])")
    assert sample.search(tout).group(1) == sample.search(jout).group(1)


def test_launch_serve_continuous_refuses_the_reference_overflow():
    """The reference's own ``--continuous --prompt-len 40``: bucket 64 =
    max_ctx 64 (40 + 16 + 8), 15 decode steps past it."""
    with pytest.raises(ValueError, match="write past max_ctx 64"):
        tlaunch.main(["--arch", "smollm_360m", "--reduced", "--device",
                      "cpu", "--continuous", "--prompt-len", "40"])
